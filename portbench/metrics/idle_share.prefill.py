"""Share of the traced stretch in which no device operation ran while the
engine was inside ``serve.prefill_chunk``, each eager prefill chunk: its
host-side set-up, the chunk's model call, its fence and the first token."""

from portbench.spans import idle_share

RANGE = "serve.prefill_chunk"


def read(obs):
    if obs.kind != "serve" or obs.trace is None:
        return None
    return idle_share(obs.trace, RANGE)
