"""Share of the traced stretch in which no device operation ran while the
engine was inside ``serve.decode``, each decode call: its preparation, the graph
launch, the fence, the commit and retire loop."""

from portbench.spans import idle_share

RANGE = "serve.decode"


def read(obs):
    if obs.kind != "serve" or obs.trace is None:
        return None
    return idle_share(obs.trace, RANGE)
