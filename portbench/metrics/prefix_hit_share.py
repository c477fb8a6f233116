"""Prompt tokens served from the prefix cache over prompt tokens admitted,
in the window (``ServeStats.prefix_tokens_saved``)."""


def read(obs):
    if obs.kind != "serve" or obs.prompt_tokens_admitted <= 0:
        return None
    saved = obs.stats1.prefix_tokens_saved - obs.stats0.prefix_tokens_saved
    return 100.0 * saved / obs.prompt_tokens_admitted
