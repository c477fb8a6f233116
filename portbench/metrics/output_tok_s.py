"""Every output token that appeared in the window, over the window."""

from portbench.stats import rate


def read(obs):
    if obs.kind != "serve":
        return None
    return rate(obs.tokens, obs.window_s)
