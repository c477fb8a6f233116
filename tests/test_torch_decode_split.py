"""The split-K decode kernel's plan and arithmetic, on the CPU.

``csrc/paged_attention.cu`` cuts each sequence's keys into splits of
``decode_split_plan``'s size, scores each split in runs of 8 keys (one
score per lane for a block's 4 query rows) spread over four warps, merges
the warps, then the splits: in the plain
body by weights exp(m_s - m) and a final division by l; in the read_dtype
body by a stats pass (each split's (m, l)), a value pass that folds every
split's stats into the final (m, l) and sums bf16(exp(s - m) / l) *
bf16(v), and a combine that adds the splits' sums.  The plan is a plain
Python function and is tested as one.  The kernel runs only on the card
(tests/test_torch_cuda.py holds it against the plain version there); here
:func:`emulate_decode` repeats its arithmetic in torch, split by split,
warp by warp and run by run, and is held against ``paged_attention_pallas``
in interpret mode, as tests/test_torch_kernels.py runs it.

Tolerance: 3e-5 (f32), the same function summed in another order, as in
tests/test_torch_kernels.py, for both bodies.
"""

import itertools
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)
TOL = 3e-5
H100_SMS = 132
WARPS = 4                       # warps per decode block (csrc: kDWarps)
RUN_KEYS = 8                    # keys per warp run: 32 lanes / 4 rows (csrc: kK)


# -- the plan ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,nb,bs,sms,want", [
    (4, 8, 64, 16, H100_SMS, (16, 64)),       # the serving path: 16 splits of 64 keys
    (1, 8, 64, 16, H100_SMS, (16, 64)),       # one sequence, the same splits
    (64, 8, 64, 16, H100_SMS, (1, 1024)),     # B * Hkv fills the card: one split
    (32, 8, 64, 16, H100_SMS, (3, 352)),      # capped at 4 blocks an SM
    (1, 8, 2048, 16, H100_SMS, (64, 512)),    # a long table, capped
    (2, 2, 6, 8, H100_SMS, (1, 64)),          # a table shorter than one split
    (2, 2, 30, 3, H100_SMS, (2, 66)),         # pages that do not divide 64
])
def test_decode_split_plan(B, Hkv, nb, bs, sms, want):
    assert tpa.decode_split_plan(B, Hkv, nb, bs, sms) == want


def test_decode_split_plan_invariants():
    """Over a grid of shapes: a split is whole pages; the splits cover the
    table and none lies wholly past it; at most DECODE_BLOCKS_PER_SM
    blocks an SM where the heads alone do not fill the card twice; and a
    split is never shorter than DECODE_SPLIT_KEYS keys (or the table)."""
    for B, Hkv, nb, bs, sms in itertools.product(
            (1, 2, 4, 9, 33, 64, 300), (1, 2, 8), (1, 3, 16, 64, 257),
            (1, 4, 16, 100), (8, 132)):
        splits, kps = tpa.decode_split_plan(B, Hkv, nb, bs, sms)
        total = nb * bs
        assert kps % bs == 0 and splits >= 1
        assert splits * kps >= total > (splits - 1) * kps
        if B * Hkv >= 2 * sms:
            assert splits == 1
        else:
            assert splits <= -(-tpa.DECODE_BLOCKS_PER_SM * sms // (B * Hkv))
            assert kps >= min(tpa.DECODE_SPLIT_KEYS, total)


def test_decode_workspace_floats():
    # per (b, h, split, g): (m, l) and D partial sums
    assert tpa.decode_workspace_floats(4, 8, 4, 128, 16) == 4 * 8 * 16 * 4 * 130


# -- the arithmetic ------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _merge(states):
    """Softmax states (m, l, acc-or-None) merged in order: weights
    exp(m_i - m), empty states skipped."""
    live = [s for s in states if s is not None and math.isfinite(s[0])]
    if not live:
        return None
    mx = max(s[0] for s in live)
    l = sum(s[1] * math.exp(s[0] - mx) for s in live)
    acc = None
    if live[0][2] is not None:
        acc = sum(s[2] * math.exp(s[0] - mx) for s in live)
    return mx, l, acc


def emulate_decode(q, k_pool, v_pool, block_tables, lengths, *, window=None,
                   scale=None, read_dtype=None, sms=H100_SMS):
    """The kernel's arithmetic in torch: per (b, h, query row) the splits of
    decode_split_plan, their live keys cut into runs of RUN_KEYS keys taken
    by the warps in turn, an online softmax per warp, the warps merged,
    then the splits (plain body); or stats, final (m, l), and sums of
    bf16(exp(s - m) / l) * bf16(v) (read_dtype body)."""
    B, Hq, _, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    nb = block_tables.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    splits, kps = tpa.decode_split_plan(B, Hkv, nb, bs, sms)
    T = nb * bs
    # (B, Hkv, T, D): column t of sequence b is key t
    k, v = (pool[block_tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, D).float()
            for pool in (k_pool, v_pool))
    if read_dtype is not None:
        k, v = _bf16(k), _bf16(v)
    out = torch.zeros((B, Hq, D))
    for b, h, g in itertools.product(range(B), range(Hkv), range(G)):
        length = int(lengths[b])
        lo = max(0, length - window + 1) if window is not None else 0
        qr = q[b, h * G + g, 0].float()

        def split_runs(s):
            first, last = max(s * kps, lo), min(min(s * kps + kps, T) - 1, length)
            if first > last:
                return []
            starts = range(first, last + 1, RUN_KEYS)
            return [[(k0, min(k0 + RUN_KEYS, last + 1)) for k0 in starts[w::WARPS]]
                    for w in range(WARPS)]

        def scores(k0, k1):
            return (k[b, h, k0:k1] @ qr) * scale

        if read_dtype is None:
            parts = []
            for s in range(splits):
                warps = []
                for runs in split_runs(s):
                    m, l, acc = -math.inf, 0.0, torch.zeros(D)
                    for k0, k1 in runs:
                        sc = scores(k0, k1)
                        m_new = max(m, float(sc.max()))
                        alpha = math.exp(m - m_new)
                        p = torch.exp(sc - m_new)
                        l = l * alpha + float(p.sum())
                        acc = acc * alpha + p @ v[b, h, k0:k1]
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(_merge(warps))
            final = _merge(parts)
            if final is not None:
                out[b, h * G + g] = final[2] / (final[1] if final[1] else 1.0)
        else:
            stats = []
            for s in range(splits):
                warps = []
                for runs in split_runs(s):
                    m, l = -math.inf, 0.0
                    for k0, k1 in runs:
                        sc = scores(k0, k1)
                        m_new = max(m, float(sc.max()))
                        l = l * math.exp(m - m_new) + float(torch.exp(sc - m_new).sum())
                        m = m_new
                    warps.append((m, l, None))
                stats.append(_merge(warps))
            final = _merge(stats)
            if final is None:
                continue
            m, l = final[0], final[1] or 1.0
            total = torch.zeros(D)
            for s in range(splits):
                for runs in split_runs(s):
                    for k0, k1 in runs:
                        p = _bf16(torch.exp(scores(k0, k1) - m) / l)
                        total += p @ v[b, h, k0:k1]
            out[b, h * G + g] = total
    return out.reshape(B, Hq, 1, D).to(q.dtype)


# lengths 0, bs - 1, bs, bs + 1; on and beside the 64-key split boundary;
# a window that empties whole splits; B = 1 with many splits; a group of 8
# (two 4-row blocks per KV head); a plan of one split at large batch
EMULATION_CASES = [
    dict(B=4, Hq=8, Hkv=2, bs=8, nb=32, D=32, window=None, lengths=[0, 7, 8, 9]),
    dict(B=3, Hq=8, Hkv=2, bs=8, nb=32, D=32, window=None, lengths=[63, 64, 200]),
    dict(B=2, Hq=4, Hkv=2, bs=16, nb=16, D=32, window=40, lengths=[200, 255]),
    dict(B=1, Hq=4, Hkv=1, bs=4, nb=128, D=16, window=None, lengths=[509]),
    dict(B=2, Hq=16, Hkv=2, bs=8, nb=16, D=64, window=None, lengths=[100, 127]),
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=24, D=32, window=None, lengths=[150, 191], sms=2),
]


def _emulation_inputs(case, seed=7):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, bs, nb, D = (case[k] for k in ("B", "Hq", "Hkv", "bs", "nb", "D"))
    N = nb * B
    kp = rng.standard_normal((N, Hkv, bs, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, bs, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    bt = rng.permutation(N).astype(np.int32)[:B * nb].reshape(B, nb)
    lengths = np.asarray(case["lengths"], np.int32)
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("read_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_split_arithmetic_against_pallas(case, read_dtype):
    inputs = _emulation_inputs(case)
    t_inputs = [torch.from_numpy(a) for a in inputs]
    splits, _ = tpa.decode_split_plan(case["B"], case["Hkv"], case["nb"], case["bs"],
                                      case.get("sms", H100_SMS))
    assert splits == 1 if "sms" in case else splits > 1
    got = emulate_decode(*t_inputs, window=case["window"], read_dtype=read_dtype,
                         sms=case.get("sms", H100_SMS))
    want = np.asarray(jpa.paged_attention_pallas(
        *[jnp.asarray(a) for a in inputs], window=case["window"],
        read_dtype=None if read_dtype is None else jnp.bfloat16))
    allowed = TOL + TOL * np.abs(want)
    err = np.abs(got.numpy() - want)
    assert (err <= allowed).all(), float((err - allowed).max())
