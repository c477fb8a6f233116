"""Process start to window start: imports, weights, engine or train loop,
kernel builds and loads, graph capture, warm-up, caches filled."""


def read(obs):
    return obs.setup_s
