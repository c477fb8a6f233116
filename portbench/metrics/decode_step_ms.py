"""The engine's decode wall a step in the window (``ServeStats.decode_s``
over ``decode_steps``)."""


def read(obs):
    if obs.kind != "serve":
        return None
    steps = obs.stats1.decode_steps - obs.stats0.decode_steps
    if steps <= 0:
        return None
    return 1e3 * (obs.stats1.decode_s - obs.stats0.decode_s) / steps
