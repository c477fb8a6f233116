"""The paged prefill kernel's share of its roofline in the traced stretch:
for every traced chunk and layer the larger of its operations and bytes
bounds, over the union of the device intervals of the kernels named here."""

from portbench import peaks, work

KERNELS = ("paged_prefill_kernel",)


def read(obs):
    t = obs.trace
    if obs.kind != "serve" or t is None or not obs.traced_prefill_chunks:
        return None
    n, secs = t.kernel_seconds(KERNELS)
    if not n or secs <= 0:
        return None
    c = obs.cfg
    bs = obs.block_size
    bound = 0.0
    for base, clen in obs.traced_prefill_chunks:
        ops = work.paged_prefill_ops(base, clen, c.num_heads, c.head_dim, c.window)
        nbytes = work.paged_prefill_bytes(base, clen, c.num_heads, c.num_kv_heads,
                                          c.head_dim, 2, work.pages(base + clen, bs))
        bound += work.roofline_seconds(ops, nbytes, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    return 100.0 * bound * c.num_layers / secs
