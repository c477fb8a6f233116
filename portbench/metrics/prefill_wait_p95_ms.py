"""95th percentile of the engine's prefill waits in the window
(``ServeStats.prefill_wait_s``: a request's first admission to its first
token, less its placement and its own chunk walls: the time it sat admitted
while other slots' chunks and decode calls ran)."""

from portbench.stats import percentile


def read(obs):
    if obs.kind != "serve":
        return None
    waits = getattr(obs.stats1, "prefill_wait_s", None)
    if waits is None:
        return None
    waits = waits[len(obs.stats0.prefill_wait_s):]
    return 1e3 * percentile(waits, 95) if waits else None
