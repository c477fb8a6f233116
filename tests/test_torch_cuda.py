"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' argument checks and launch counts, the engine's kernel path
against its gather path, a training step with the flash kernel, and the
paper's six algorithms under the VPE with the matmul and conv2d kernels.
Every test marked ``cuda`` needs a CUDA device (sm_90a) and ``nvcc``, and
skips without them; the one unmarked test checks that the paper path's
entry points default to the card.  This file imports no JAX, so it runs on
a machine that has only PyTorch (``--noconftest`` skips tests/conftest.py,
which imports JAX):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bench_algos import build_vpe, make_inputs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import shape_bucket  # noqa: E402
from repro_torch.kernels import conv2d as tconv  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

# the shapes of tests/test_torch_kernels.py: GQA, SWA, MHA, MQA, C=1
DECODE_CASES = [
    dict(B=3, Hq=4, Hkv=2, bs=8, nb=4, D=32, window=None),
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, D=32, window=9),
    dict(B=2, Hq=4, Hkv=4, bs=16, nb=3, D=16, window=None),
    dict(B=1, Hq=8, Hkv=1, bs=4, nb=8, D=64, window=None),
    # the split-K decode's edges: qwen3-8b heads on the main path's table
    # (16 splits of 64 keys) at B = 1 and 4, and under a window that
    # empties whole splits; h2o-danube-3-4b's D = 120 (two lanes idle);
    # B = 64, where B * Hkv fills the card and the plan is one split;
    # qwen2-7b's group of 7 (two 4-row blocks per head, the second one
    # row short) at a D the wrapper pads in bf16; a group of 16 (four
    # blocks per head); D = 192 (two passes of the lanes)
    dict(B=1, Hq=32, Hkv=8, bs=16, nb=64, D=128, window=None),
    dict(B=4, Hq=32, Hkv=8, bs=16, nb=64, D=128, window=None),
    dict(B=4, Hq=32, Hkv=8, bs=16, nb=64, D=128, window=100),
    dict(B=2, Hq=32, Hkv=8, bs=16, nb=40, D=120, window=None),
    dict(B=64, Hq=32, Hkv=8, bs=16, nb=16, D=128, window=None),
    dict(B=2, Hq=28, Hkv=4, bs=16, nb=8, D=20, window=None),
    dict(B=2, Hq=32, Hkv=2, bs=8, nb=10, D=64, window=7),
    dict(B=2, Hq=8, Hkv=2, bs=16, nb=8, D=192, window=None),
]
PREFILL_CASES = [
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, C=16, D=32, window=None),
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, C=8, D=32, window=11),
    dict(B=1, Hq=8, Hkv=1, bs=4, nb=8, C=12, D=64, window=None),
    dict(B=3, Hq=4, Hkv=4, bs=16, nb=4, C=1, D=16, window=None),
    # the bf16 tile core's edges: qwen3-8b's heads with a short chunk
    # (several 64-key stages, the ring wrapping, 64-row tiles of one head),
    # the same under a sliding window, and a head dim off the 16-byte
    # rows (the wrapper pads it in bf16)
    dict(B=2, Hq=32, Hkv=8, bs=16, nb=40, C=128, D=128, window=None, chunk_len=100),
    dict(B=2, Hq=32, Hkv=8, bs=16, nb=40, C=128, D=128, window=100, chunk_len=100),
    dict(B=1, Hq=4, Hkv=2, bs=8, nb=6, C=16, D=20, window=None),
]
# (B, Hq, Hkv, S, T, D): danube heads (D=120), qwen3 heads (D=128), MHA,
# S < T (rows aligned at the end), T not a multiple of the 64-key tile;
# then the bf16 tile core's edges: GQA group 8 with S and T off the
# 128-row and 64-key tiles and the ring wrapping, group 1 at D=120, and
# head dims off the 16-byte rows (padded by the wrapper in bf16)
FLASH_CASES = [
    dict(B=1, Hq=8, Hkv=2, S=192, T=192, D=120),
    dict(B=2, Hq=4, Hkv=1, S=128, T=128, D=128),
    dict(B=1, Hq=4, Hkv=4, S=70, T=200, D=64),
    dict(B=1, Hq=4, Hkv=2, S=1, T=77, D=32),
    dict(B=2, Hq=16, Hkv=2, S=520, T=700, D=128),
    dict(B=1, Hq=8, Hkv=8, S=333, T=333, D=120),
    dict(B=1, Hq=8, Hkv=2, S=96, T=160, D=100),
    dict(B=1, Hq=4, Hkv=1, S=64, T=64, D=60),
]
# f32: the same sums in another order; bf16: one rounding step of the
# output (2^-8 relative); f32 with read_dtype: a probability on a bf16
# rounding boundary may round the other way (its bf16 step times |v|)
TOLERANCES = {(torch.float32, None): 1e-5, (torch.float32, torch.bfloat16): 5e-4,
              (torch.bfloat16, None): 2e-2, (torch.bfloat16, torch.bfloat16): 2e-2}
# flash kernel against its plain version, (atol, rtol): both sum in f32 and
# round once, so bf16 outputs are at most one bf16 step (2^-7 of the value)
# apart
FLASH_TOLERANCES = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a) and nvcc; on the CPU the "
                    "plain versions are held against JAX instead")
    return torch.device("cuda")


def _inputs(case, S, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, bs, nb, D = (case[k] for k in ("B", "Hq", "Hkv", "bs", "nb", "D"))
    N = nb * B
    kp = rng.standard_normal((N, Hkv, bs, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, bs, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    bt = rng.integers(0, N, (B, nb)).astype(np.int32)
    bt[1:, 0] = bt[0, 0]           # rows share a page
    per_seq = rng.integers(0, nb * bs - S + 1, (B,)).astype(np.int32)
    if "lengths" in case:
        per_seq = np.asarray(case["lengths"], dtype=np.int32)
    return q, kp, vp, bt, per_seq


def _to(dev, dtype, *arrs):
    return [torch.from_numpy(a).to(dev, dtype if a.dtype == np.float32 else None)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("read_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_cuda_decode_against_plain(cuda_device, case, dtype, read_dtype):
    inputs = _to(cuda_device, dtype, *_inputs(case, 1, seed=0))
    before = tpa.paged_attention_cuda.launches
    got = tpa.paged_attention_cuda(*inputs, window=case["window"],
                                   read_dtype=read_dtype)
    torch.cuda.synchronize()
    assert tpa.paged_attention_cuda.launches == before + 1
    want = tref.paged_attention_ref(*inputs, window=case["window"],
                                    read_dtype=read_dtype)
    tol = TOLERANCES[(dtype, read_dtype)]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_cuda_prefill_against_plain(cuda_device, case, dtype):
    inputs = _to(cuda_device, dtype, *_inputs(case, case["C"], seed=2))
    clen = case.get("chunk_len", max(1, case["C"] - 3))
    before = tpa.paged_prefill_attention_cuda.launches
    got = tpa.paged_prefill_attention_cuda(*inputs, chunk_len=clen,
                                           window=case["window"])
    torch.cuda.synchronize()
    assert tpa.paged_prefill_attention_cuda.launches == before + 1
    want = tref.paged_prefill_attention_ref(*inputs, chunk_len=clen,
                                            window=case["window"])
    tol = TOLERANCES[(dtype, None)]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_arguments(cuda_device):
    q, kp, vp, bt, ln = _to(cuda_device, torch.float32,
                            *_inputs(DECODE_CASES[0], 1, seed=0))
    before = tpa.paged_attention_cuda.launches
    with pytest.raises(TypeError):
        tpa.paged_attention_cuda(q.double(), kp, vp, bt, ln)
    with pytest.raises(TypeError):
        tpa.paged_attention_cuda(q, kp, vp, bt.long(), ln)
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(q, kp.transpose(1, 2), vp, bt, ln)
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(q.cpu(), kp, vp, bt, ln)
    with pytest.raises(ValueError):
        tpa.paged_prefill_attention_cuda(q, kp, vp, bt, ln, chunk_len=2)
    assert tpa.paged_attention_cuda.launches == before


# qwen3-8b heads on the main path's table, lengths 0, on and beside page
# (16) and split (64) boundaries, and at the table's end
BOUNDARY_CASE = dict(B=9, Hq=32, Hkv=8, bs=16, nb=64, D=128, window=None,
                     lengths=[0, 15, 16, 17, 63, 64, 65, 128, 1023])


def _bf16_neighbours(p):
    """The bf16 values below and above each of ``p``'s (positive, already
    bf16), as f64."""
    bits = p.to(torch.bfloat16).view(torch.int16)
    return [(bits + i).view(torch.bfloat16).double() for i in (-1, 1)]


def _explain_by_bf16_steps(got, q, kp, vp, bt, ln, rows, tol):
    """The read_dtype body's outputs off the shared limit, explained: for
    each (b, query head) row in ``rows``, the kernel's probabilities are
    recovered by least squares from its output (one equation per dim, so
    the row may have at most D valid keys) and each is snapped to the
    nearest of the plain version's bf16 probability and its two bf16
    neighbours.  Returns the probabilities moved by one bf16 step and the
    largest excess of the row's output over its limit around the output
    of the snapped probabilities (<= 0: the one-step moves account for
    the whole error)."""
    B, Hq, _, D = q.shape
    Hkv, G = kp.shape[1], Hq // kp.shape[1]
    k, v = (tref._round(tref._linearize(pool, bt), torch.bfloat16) for pool in (kp, vp))
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * (1.0 / D ** 0.5)      # as the plain version
    valid = torch.arange(k.shape[2], device=q.device)[None, :] <= ln.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p_ref = tref._round(torch.softmax(s, dim=-1), torch.bfloat16).reshape(B, Hq, -1)
    moved, excess = 0, -float("inf")
    for b, hq in rows:
        keys = valid[b].nonzero().flatten()
        assert len(keys) <= D, f"row {(b, hq)}: {len(keys)} valid keys, no recovery"
        vr = v[b, hq // G, keys].double().cpu()                       # (n, D)
        o = got[b, hq, 0].double().cpu()
        p_kernel = torch.linalg.lstsq(vr.T, o[:, None]).solution[:, 0]
        p0 = p_ref[b, hq, keys].cpu()
        cands = torch.stack([p0.double(), *_bf16_neighbours(p0)])     # (3, n)
        pick = (cands - p_kernel).abs().argmin(0)
        moved += int((pick != 0).sum())
        o_snap = cands.gather(0, pick[None])[0] @ vr
        excess = max(excess, float(((o - o_snap).abs() - tol - tol * o_snap.abs()).max()))
    return moved, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("read_dtype", [None, torch.bfloat16])
def test_cuda_decode_lengths_on_boundaries(cuda_device, dtype, read_dtype):
    """Sequences of 1 to 1024 valid keys, split by split, under
    TOLERANCES.  In the read_dtype body with f32 pools, a probability that
    lies on a bf16 rounding boundary may round the other way in the kernel
    than in the plain version, whose denominator is summed in another
    order, and with few valid keys that moves the output by more than the
    limit.  An output row off the limit passes only where its error is
    that: the kernel's probabilities, recovered from its output, are each
    the plain version's or one bf16 step beside it, and the output they
    give lies within the limit."""
    case = BOUNDARY_CASE
    q, kp, vp, bt, ln = _to(cuda_device, dtype, *_inputs(case, 1, seed=0))
    before = tpa.paged_attention_cuda.launches
    got = tpa.paged_attention_cuda(q, kp, vp, bt, ln, read_dtype=read_dtype)
    torch.cuda.synchronize()
    assert tpa.paged_attention_cuda.launches == before + 1
    want = tref.paged_attention_ref(q, kp, vp, bt, ln, read_dtype=read_dtype).float()
    tol = TOLERANCES[(dtype, read_dtype)]
    off = ((got.float() - want).abs() > tol + tol * want.abs()).any(-1)[..., 0]
    rows = off.nonzero().tolist()
    if not rows:
        return
    assert dtype == torch.float32 and read_dtype is not None, \
        f"rows {rows} off the limit {tol}"
    moved, excess = _explain_by_bf16_steps(got, q, kp, vp, bt, ln, rows, tol)
    print(f"rows off the limit {tol}: {rows}; {moved} probabilities one bf16 "
          f"step from the plain version's; excess over the limit then {excess}")
    assert moved > 0 and excess <= 0, (rows, moved, excess)


@pytest.mark.cuda
def test_cuda_decode_rejects_wide_heads(cuda_device):
    """The decode kernel holds at most 256 dims (two passes of a warp's
    lanes)."""
    case = dict(DECODE_CASES[0], D=264)
    q, kp, vp, bt, ln = _to(cuda_device, torch.bfloat16, *_inputs(case, 1, seed=0))
    before = tpa.paged_attention_cuda.launches
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(q, kp, vp, bt, ln)
    assert tpa.paged_attention_cuda.launches == before


@pytest.mark.cuda
def test_cuda_prefill_bf16_rejects_wide_heads(cuda_device):
    """The bf16 prefill body holds at most 128 dims in its tiles."""
    case = dict(PREFILL_CASES[0], D=136)
    q, kp, vp, bt, base = _to(cuda_device, torch.bfloat16, *_inputs(case, 16, seed=2))
    before = tpa.paged_prefill_attention_cuda.launches
    with pytest.raises(ValueError):
        tpa.paged_prefill_attention_cuda(q, kp, vp, bt, base)
    assert tpa.paged_prefill_attention_cuda.launches == before


@pytest.mark.cuda
def test_cuda_engine_kernels_equal_gather_path(cuda_device):
    """Reduced qwen3-8b in f32 on the card: the engine with both kernels
    pinned gives the greedy tokens of the gather path, and launches each
    kernel once per layer per decode step or prefill chunk."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 5)]
    out = {}
    for impls in (("grouped", "gather"), ("cuda", "cuda")):
        eng = tserve.ContinuousBatchingEngine(
            cfg, params, slots=2, max_len=64, block_size=8, prefill_chunk=8,
            decode_impl=impls[0], prefill_kernel=impls[1], device=cuda_device)
        tpa.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=6))
        out[impls] = {r.rid: r.out for r in eng.run()}
        eng.check_kv()
        assert eng.pages.drained
        kernels = impls[0] == "cuda"
        assert tpa.paged_attention_cuda.launches == \
            (eng.stats.decode_steps * cfg.num_layers if kernels else 0)
        assert tpa.paged_prefill_attention_cuda.launches == \
            (eng.stats.prefill_chunks * cfg.num_layers if kernels else 0)
    assert out[("cuda", "cuda")] == out[("grouped", "gather")]


def _flash_inputs(case, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, S, T, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "T", "D"))
    arrs = (rng.standard_normal((B, Hq, S, D)),
            rng.standard_normal((B, Hkv, T, D)),
            rng.standard_normal((B, Hkv, T, D)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 50),
                                           (False, None), (False, 64)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_against_plain(cuda_device, case, causal, window, dtype):
    q, k, v = _flash_inputs(case, cuda_device, dtype, seed=5)
    before = tfa.flash_attention_cuda.launches
    got = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_cuda.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    atol, rtol = FLASH_TOLERANCES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_flash_rejects_bad_arguments(cuda_device):
    q, k, v = _flash_inputs(FLASH_CASES[0], cuda_device, torch.float32, seed=0)
    before = tfa.flash_attention_cuda.launches
    with pytest.raises(TypeError):
        tfa.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 64, 136), device=cuda_device)
        tfa.flash_attention_cuda(big, big[:, :2], big[:, :2])
    assert tfa.flash_attention_cuda.launches == before


@pytest.mark.cuda
def test_cuda_flash_prepare(cuda_device):
    """prepare builds the library, checks its tiles and launches once at
    danube's head shape."""
    before = tfa.flash_attention_cuda.launches
    tfa.prepare(torch.bfloat16, 32, 8, 120, cuda_device)
    assert tfa.flash_attention_cuda.launches == before + 1


@pytest.mark.cuda
def test_cuda_flash_gradient_matches_chunked(cuda_device):
    """attention_flash (kernel forward, reference backward) against
    autograd through attention_chunked, f32: the forward is the same
    function summed in another order; the gradients are attention_chunked's
    VJP on both sides, so this checks the autograd wiring."""
    q, k, v = (t.requires_grad_() for t in
               _flash_inputs(FLASH_CASES[0], cuda_device, torch.float32, seed=8))
    g = torch.randn(q.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(9))
    res = []
    for fn in (tlayers.attention_flash, tlayers.attention_chunked):
        o = fn(q, k, v, causal=True, window=100)
        res.append((o.detach(), *torch.autograd.grad(o, (q, k, v), g)))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_train_step_flash_pinned(cuda_device):
    """One TrainLoop step of reduced h2o-danube-3-4b (f32) with flash_cuda
    pinned launches the kernel twice per layer (forward and the remat
    recomputation) and gives the reference variant's loss."""
    import dataclasses
    base = get_config("h2o-danube-3-4b").reduced()
    params = tmodel.init_params(base, torch.Generator(cuda_device).manual_seed(0))
    data = DataConfig(vocab_size=base.vocab_size, seq_len=48, global_batch=2)
    losses = {}
    for impl in ("flash_cuda", "reference"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        loop = ttrain.TrainLoop(
            cfg, ttrain.TrainLoopConfig(total_steps=1, log_every=0, enable_vpe=False),
            SyntheticStream(data), device=cuda_device,
            params={k: (v.clone() if isinstance(v, torch.Tensor) else
                        {kk: vv.clone() for kk, vv in v.items()})
                    for k, v in params.items()})
        tfa.reset_launch_counts()
        losses[impl] = loop.run()[0]["loss"]
        assert tfa.flash_attention_cuda.launches == \
            (2 * cfg.num_layers if impl == "flash_cuda" else 0)
    assert np.isfinite(losses["flash_cuda"])
    assert losses["flash_cuda"] == pytest.approx(losses["reference"], rel=1e-5)


# matmul: tests/test_kernels.py's shapes, the paper path's 512^3, one off
# every tile, and the Fig. 2b sweep's largest; then k and n off the
# 16-byte copies (the predicated-load path), on both tiles
MATMUL_CASES = [(128, 256, 128), (256, 512, 256), (100, 200, 60), (8, 8, 8),
                (1, 512, 128), (384, 128, 384), (512, 512, 512), (1000, 1000, 1000),
                (4096, 4096, 4096), (33, 257, 65), (512, 513, 511), (2050, 300, 2047)]
# conv2d: tests/test_kernels.py's shapes, make_inputs at scale 0.02, the
# paper's 512^2 * 5x5 and the image pipeline's 384^2 Laplacian
CONV_CASES = [(64, 64, 3), (64, 64, 5), (37, 53, 5), (128, 96, 11), (16, 16, 3),
              (66, 64, 3), (10, 10, 5), (512, 512, 5), (384, 384, 3)]


def matmul_tolerance(dtype, k):
    """(atol, rtol) of the matmul kernel against its plain version.  f32:
    JAX's 5e-4 up to k = 512, scaled by sqrt(k / 512) above it (the
    rounding error of a sum in another order grows with its length).  bf16:
    the same f32 difference, plus one bf16 step (2^-7 of the value) from
    rounding the two sums once each; an output near 0 whose partial sums
    are not keeps the whole f32 difference, so the f32 atol stays."""
    tol = 5e-4 * max(1.0, (k / 512) ** 0.5)
    return (tol, tol + 2 ** -7) if dtype == torch.bfloat16 else (tol, tol)


# conv2d against its plain version, (atol, rtol): f32 JAX's 2e-4; bf16 one
# bf16 step (both sum at most 121 taps in f32 and round once)
CONV_TOLERANCES = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-5, 2 ** -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_cuda_matmul_against_plain(cuda_device, m, k, n, dtype):
    """Also: the bf16 kernel rounds once — its output equals the f32
    kernel's on the widened inputs, rounded to bf16, bit for bit (the same
    products summed in the same order)."""
    gen = torch.Generator(cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    before = tmm.matmul.launches
    got = tmm.matmul(a, b)
    torch.cuda.synchronize()
    assert tmm.matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    atol, rtol = matmul_tolerance(dtype, k)
    torch.testing.assert_close(got.float(), tref.matmul_ref(a, b).float(),
                               rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert torch.equal(got, tmm.matmul(a.float(), b.float()).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k", CONV_CASES)
def test_cuda_conv2d_against_plain(cuda_device, h, w, k, dtype):
    gen = torch.Generator(cuda_device).manual_seed(h * w + k)
    x = torch.randn((h, w), generator=gen, device=cuda_device).to(dtype)
    ker = torch.randn((k, k), generator=gen, device=cuda_device).to(dtype)
    before = tconv.conv2d.launches
    got = tconv.conv2d(x, ker)
    torch.cuda.synchronize()
    assert tconv.conv2d.launches == before + 1
    assert got.shape == (h - k + 1, w - k + 1) and got.dtype == dtype
    atol, rtol = CONV_TOLERANCES[dtype]
    torch.testing.assert_close(got.float(), tref.conv2d_ref(x, ker).float(),
                               rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert torch.equal(got, tconv.conv2d(x.float(), ker.float()).to(dtype))


@pytest.mark.cuda
def test_cuda_matmul_conv2d_reject_bad_arguments(cuda_device):
    a = torch.zeros((64, 64), device=cuda_device)
    before = (tmm.matmul.launches, tconv.conv2d.launches)
    with pytest.raises(TypeError):
        tmm.matmul(a, a.bfloat16())                      # dtype mismatch
    with pytest.raises(TypeError):
        tmm.matmul(a.half(), a.half())                   # unsupported dtype
    with pytest.raises(ValueError):
        tmm.matmul(a.t(), a)                             # not contiguous
    with pytest.raises(ValueError):
        tmm.matmul(a[None], a)                           # wrong rank
    with pytest.raises(ValueError):
        tmm.matmul(a, a[:32])                            # k differs
    with pytest.raises(ValueError):
        tmm.matmul(a.cpu(), a)                           # CPU / CUDA mix
    with pytest.raises(TypeError):
        tconv.conv2d(a, a[:3, :3].contiguous().bfloat16())
    with pytest.raises(ValueError):
        tconv.conv2d(a[:, ::2], a[:3, :3].contiguous())
    with pytest.raises(ValueError):
        tconv.conv2d(a[None], a[:3, :3].contiguous())
    with pytest.raises(ValueError):
        tconv.conv2d(a, a[:3, :3].contiguous().cpu())
    with pytest.raises(ValueError):
        tconv.conv2d(a, torch.zeros((33, 3), device=cuda_device))
    assert (tmm.matmul.launches, tconv.conv2d.launches) == before


@pytest.mark.cuda
def test_cuda_prepare_launches_each_kernel_once(cuda_device):
    before = (tmm.matmul.launches, tconv.conv2d.launches)
    tmm.prepare(cuda_device)
    tconv.prepare(cuda_device)
    assert (tmm.matmul.launches, tconv.conv2d.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_paper_algorithms_trial_the_kernels(cuda_device):
    """build_vpe on the card runs all six algorithms; the VPE trials the
    cuda variants of matmul and convolution, which launch their kernels,
    and every variant gives the reference's result."""
    vpe, fns = build_vpe(device=cuda_device)
    tmm.reset_launch_counts()
    tconv.reset_launch_counts()
    for name in ("complement", "convolution", "dotproduct", "matmul", "patternmatch",
                 "fft"):
        args = make_inputs(name, scale=0.25, device=cuda_device)
        outs = [fns[name](*args) for _ in range(12)]
        assert all(o.device.type == "cuda" for o in outs)
        entry = vpe.registry.op(name)
        want = entry.variants["reference"].fn(*args)
        for vname, variant in entry.variants.items():
            got = variant.fn(*args)
            assert got.dtype == want.dtype, (name, vname)
            if want.dtype in (torch.int32, torch.bool):
                assert torch.equal(got, want), (name, vname)
            else:
                torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        history = vpe.controller.decision(name, shape_bucket(*args)).history
        assert [e for e, _, _ in history].count("trial") == len(entry.variants) - 1
    assert tmm.matmul.launches > 0 and tconv.conv2d.launches > 0


def test_paper_entry_points_default_to_the_card():
    """make_inputs and build_vpe default to device="cuda": on the card they
    give CUDA tensors, without one they raise (no silent move to the CPU)."""
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in make_inputs("matmul", scale=0.02))
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make_inputs("matmul", scale=0.02)
    with pytest.raises(RuntimeError, match="cuda"):
        build_vpe()
