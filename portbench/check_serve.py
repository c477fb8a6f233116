"""Whether a serving run's tokens are right, judged by the plain reference.

Once the window has closed and the program is freed, a sample of the
requests the window finished (the one with the most tokens, and
``requests - 1`` more drawn from the seed) goes to the reference of the
configuration's family (``reference/<family>.py``): one f32 forward pass
over each prompt and its served tokens, with weights made again from the
seed.  At each served position the reference's best logit
minus its logit of the served token is a gap (0 where they agree); the
number compared is the widest gap over the sample.  Greedy decoding in
bf16 parts from f32 only where two logits nearly tie, so its gaps stay
small; a wrong token lies far below the best.

The control (``control=True``) is the reference computed with fp8 weight
products, put in the program's place: at each position of the same sample
the token fp8 puts first is the served token, and its gap in the f32
logits is the widest gap that is judged, so a control run comes out not
correct.  The program's own gap is reported beside it
(``program_widest_logit_gap``), judged by the same limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import families, generate, weights


def draw_sample(finished, check: Dict, seed: int) -> List[Tuple[np.ndarray, List[int], int]]:
    """(prompt, served tokens, tokens asked for) of the sampled requests."""
    if not finished:
        return []
    k = min(int(check["requests"]), len(finished))
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i].prompt) + len(finished[i].out)))
    rest = order[1:]
    pick = [order[0]]
    if k > 1:
        rng = generate.rng_for(seed, 5)
        pick += [rest[int(i)] for i in rng.choice(len(rest), size=k - 1, replace=False)]
    return [(np.asarray(finished[i].prompt, np.int32), list(finished[i].out),
             int(finished[i].max_new_tokens)) for i in pick]


def gaps(dims, params, prompt: np.ndarray, out: List[int], device,
         control: bool) -> Tuple[float, float]:
    """(widest gap of the served tokens, widest gap of the fp8 control's
    tokens, or nan) over one request."""
    seq = np.concatenate([prompt, np.asarray(out[:-1], np.int32)])
    toks = torch.from_numpy(seq).to(device)
    start = len(prompt) - 1
    ref = families.reference(dims.family)
    logits = ref.serve_logits(dims, params, toks, start)
    served = torch.tensor(out, dtype=torch.long, device=device)
    best = logits.max(dim=-1).values
    g = float((best - logits.gather(1, served[:, None])[:, 0]).max())
    c = float("nan")
    if control:
        low = ref.serve_logits(dims, params, toks, start, precision="fp8")
        pick = low.argmax(dim=-1)
        c = float((best - logits.gather(1, pick[:, None])[:, 0]).max())
    return g, c


def check(dims, seed: int, device, sample, cell: Dict, control: bool = False
          ) -> List[tuple]:
    """The compared numbers, each ``(name, value, limit)``."""
    limits = cell["limits"]
    short = sum(1 for _, out, asked in sample if len(out) != asked)
    widest, widest_c = 0.0, 0.0
    if sample:
        params = weights.flatten(weights.make_params(
            dims, seed, device, getattr(torch, dims.dtype)))
        for prompt, out, _ in sample:
            g, c = gaps(dims, params, prompt, out, device, control)
            widest = max(widest, g)
            widest_c = max(widest_c, c) if control else widest_c
        del params
    limit = float(limits["widest_logit_gap"])
    checks = [("sampled_requests", float(len(sample)), float(cell["check"]["requests"])),
              ("short_requests", float(short), 0.0)]
    if control:
        checks += [("program_widest_logit_gap", widest, limit),
                   ("widest_logit_gap", widest_c, limit)]
    else:
        checks.append(("widest_logit_gap", widest, limit))
    return checks


def passed(checks: List[tuple]) -> bool:
    """Every compared number within its limit: the sample is full (at
    least its size), nothing short, every gap at most its limit."""
    ok = True
    for name, value, limit in checks:
        if name == "sampled_requests":
            ok &= value >= limit
        else:
            ok &= value <= limit
    return bool(ok)
