"""95th percentile, over every request whose first token appeared in the
window, of its submission to its first token (failed requests make the run
not correct: ``failed_requests``).  Per-layer where the card is more than
half idle: the host paces it, and its spread between runs is too wide for
an end-to-end bound."""

from portbench.stats import percentile


def read(obs):
    if obs.kind != "serve" or not obs.ttft_s:
        return None
    return 1e3 * percentile(obs.ttft_s, 95)
