"""95th percentile of every gap between consecutive output tokens of one
request that ended in the window, over all requests (tokens that appeared
together have a gap of 0)."""

from portbench.stats import percentile


def read(obs):
    if obs.kind != "serve" or not obs.itl_s:
        return None
    return 1e3 * percentile(obs.itl_s, 95)
