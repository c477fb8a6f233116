"""95th percentile of the engine's decode stalls in the window
(``ServeStats.decode_stall_s``: the admission and prefill-chunk wall ahead
of a decode step while decoding slots wait)."""

from portbench.stats import percentile


def read(obs):
    if obs.kind != "serve":
        return None
    stalls = obs.stats1.decode_stall_s[len(obs.stats0.decode_stall_s):]
    return 1e3 * percentile(stalls, 95) if stalls else None
