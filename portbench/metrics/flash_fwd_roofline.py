"""The flash-attention forward kernel's share of its roofline in the traced
steps: each launch's larger bound (operations of the kept causal pairs, or
q, k, v and the output) over the union of the device intervals of the kernels named here."""

from portbench import peaks, work

KERNELS = ("flash_fwd_kernel",)


def read(obs):
    t = obs.trace
    if obs.kind != "train" or t is None:
        return None
    n, secs = t.kernel_seconds(KERNELS)
    if not n or secs <= 0:
        return None
    c, b, s = obs.cfg, int(obs.traffic["batch"]), int(obs.traffic["seq_len"])
    ops = work.flash_fwd_ops(b, s, c.num_heads, c.head_dim, c.window)
    nbytes = work.flash_fwd_bytes(b, s, c.num_heads, c.num_kv_heads, c.head_dim)
    bound = work.roofline_seconds(ops, nbytes, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    return 100.0 * n * bound / secs
