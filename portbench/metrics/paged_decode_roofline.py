"""The paged decode kernel's share of its roofline in the traced stretch:
the bytes bound of every traced decode call (each layer: the decoding
slots' queries and outputs, K and V at each slot's real length, the page
ids read and the lengths) over the union of the device intervals of the kernels named here."""

from portbench import peaks, work

KERNELS = ("paged_decode",)


def read(obs):
    t = obs.trace
    if obs.kind != "serve" or t is None or not obs.traced_decode_calls:
        return None
    n, secs = t.kernel_seconds(KERNELS)
    if not n or secs <= 0:
        return None
    c = obs.cfg
    bs = obs.block_size
    bound = 0.0
    for pos in obs.traced_decode_calls:
        lengths = [p + 1 for p in pos]
        nbytes = work.paged_decode_bytes(lengths, c.num_heads, c.num_kv_heads, c.head_dim,
                                         2, sum(work.pages(n, bs) for n in lengths))
        bound += nbytes / peaks.HBM_BYTES
    return 100.0 * bound * c.num_layers / secs
