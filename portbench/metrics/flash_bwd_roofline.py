"""The flash-attention backward kernels' share of their roofline in the
traced steps: each launch of the main kernel (dK, dV) counts one bound, the
larger of twice the forward's operations (the backward's model count) and
twice its bytes (q, k, v, o and dO read; dq, dk and dv written), over the
union of the device intervals of every kernel named here (the Di pre-pass,
dK/dV and dQ).  A program without these kernels gives nothing."""

from portbench import peaks, work

KERNELS = ("flash_bwd",)
MAIN = ("flash_bwd_dkdv",)


def read(obs):
    t = obs.trace
    if obs.kind != "train" or t is None:
        return None
    n, _ = t.kernel_seconds(MAIN)
    _, secs = t.kernel_seconds(KERNELS)
    if not n or secs <= 0:
        return None
    c, b, s = obs.cfg, int(obs.traffic["batch"]), int(obs.traffic["seq_len"])
    ops = 2 * work.flash_fwd_ops(b, s, c.num_heads, c.head_dim, c.window)
    nbytes = 2 * work.flash_fwd_bytes(b, s, c.num_heads, c.num_kv_heads, c.head_dim)
    bound = work.roofline_seconds(ops, nbytes, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    return 100.0 * n * bound / secs
