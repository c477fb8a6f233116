"""Tokens of every train step run in the window, over the window's start to
the end of its last step."""

from portbench.stats import rate


def read(obs):
    if obs.kind != "train":
        return None
    return rate(obs.tokens, obs.window_s)
