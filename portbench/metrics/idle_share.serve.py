"""Share of the traced stretch in which no device operation ran."""


def read(obs):
    t = obs.trace
    if obs.kind != "serve" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
