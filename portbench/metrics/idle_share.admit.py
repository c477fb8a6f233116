"""Share of the traced stretch in which no device operation ran while the
engine was inside ``serve.admit``, the engine's admission: queue pop, prefix-cache
lookup, paged placement."""

from portbench.spans import idle_share

RANGE = "serve.admit"


def read(obs):
    if obs.kind != "serve" or obs.trace is None:
        return None
    return idle_share(obs.trace, RANGE)
