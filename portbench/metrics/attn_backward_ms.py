"""Device time a step under the port's range ``attention_flash.backward``
(the attention backward), in the traced steps."""

RANGE = "attention_flash.backward"


def read(obs):
    t = obs.trace
    if obs.kind != "train" or t is None or not obs.traced_steps or RANGE not in t.ranges:
        return None
    return 1e3 * t.ranges[RANGE] / obs.traced_steps
