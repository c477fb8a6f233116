"""Model FLOPs of the window's prefill chunks over their wall
(``ServeStats.prefill_s``) times the bf16 peak."""

from portbench import peaks, work


def read(obs):
    if obs.kind != "serve" or not obs.prefill_chunks:
        return None
    wall = obs.stats1.prefill_s - obs.stats0.prefill_s
    if wall <= 0:
        return None
    flops = sum(work.prefill_chunk_flops(obs.cfg, b, n) for b, n in obs.prefill_chunks)
    return 100.0 * flops / (wall * peaks.BF16_FLOPS)
