"""Model FLOPs of every prefill chunk and decode token of the window, over
the window times the bf16 peak."""

from portbench import peaks, work


def read(obs):
    if obs.kind != "serve" or not obs.decode_calls:
        return None
    flops = sum(work.decode_step_flops(obs.cfg, pos) for pos in obs.decode_calls)
    flops += sum(work.prefill_chunk_flops(obs.cfg, b, n) for b, n in obs.prefill_chunks)
    return 100.0 * flops / (obs.window_s * peaks.BF16_FLOPS)
