"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' argument checks and launch counts, the engine's kernel path
against its gather path, the decode CUDA graphs against the eager loop and
fused horizons against single steps, the prefix cache warm against cold on
each KV layout, the contiguous and ``auto`` decode graphs, the flash kernel
in contiguous admissions, a training step with the flash kernel, and the
paper's six algorithms under the VPE with the matmul and conv2d kernels,
under a page budget, preemption and swap between graph replays, the
speculative verify graphs and a demoted decode-kernel rung, the MoE
decode graph (reduced qwen2-moe-a2.7b) and the paged and flash kernels at
its heads (a group of 1), and the flash kernel at the recurrent and
encoder-decoder families' heads (D = 64; non-causal; S < T and S > T) with
reduced zamba2-1.2b served in waves through it, a group of two
engine replicas on one card against a single engine, and the paged kernels
at a head-sharded rank's heads with a (1, 2) sharded engine of two ranks
on one card against a single engine, the f32-output GEMM's bf16
gradients, the data mean and ``quantize`` on the card against the CPU bit
for bit, and training at (1, 2) and (1, 4) on one card against one
device, through a checkpoint gathered on the card.
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
from repro_torch.core import VPE, shape_bucket  # noqa: E402
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
    # qwen2-moe-a2.7b's heads: a group of 1, three of a block's four query
    # rows padding
    dict(B=4, Hq=16, Hkv=16, bs=16, nb=64, D=128, window=None),
    dict(B=4, Hq=16, Hkv=16, bs=16, nb=64, D=128, window=100),
    # qwen3-8b's heads on one rank of a head-sharded engine: mp = 2 and 4
    dict(B=4, Hq=16, Hkv=4, bs=16, nb=64, D=128, window=None),
    dict(B=4, Hq=8, Hkv=2, bs=16, nb=64, D=128, window=None),
    dict(B=4, Hq=8, Hkv=2, bs=16, nb=64, D=128, window=100),
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
    # qwen2-moe-a2.7b's heads (a group of 1) on the main path's chunk
    dict(B=2, Hq=16, Hkv=16, bs=16, nb=40, C=128, D=128, window=None, chunk_len=100),
    # qwen3-8b's heads on one rank of a head-sharded engine: mp = 2 and 4
    dict(B=2, Hq=16, Hkv=4, bs=16, nb=40, C=128, D=128, window=None, chunk_len=100),
    dict(B=2, Hq=8, Hkv=2, bs=16, nb=40, C=128, D=128, window=100, chunk_len=100),
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
    # qwen2-moe-a2.7b's heads, training
    dict(B=1, Hq=16, Hkv=16, S=1024, T=1024, D=128),
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
    pinned gives the greedy tokens of the gather path, and launches the
    prefill kernel once per layer per chunk; its decode calls replay one
    captured graph, which stands for one decode-kernel call per layer per
    step, and the decode wrapper counts only that graph's warm-up and
    capture."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 5)]
    out = {}
    for impls in (("grouped", "gather"), ("cuda", "cuda")):
        eng = tserve.ContinuousBatchingEngine(
            cfg, params, slots=2, max_len=64, block_size=8, kv_layout="paged",
            prefill_chunk=8, decode_impl=impls[0], prefill_kernel=impls[1],
            device=cuda_device)
        tpa.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=6))
        out[impls] = {r.rid: r.out for r in eng.run()}
        eng.check_kv()
        assert eng.pages.drained
        kernels = impls[0] == "cuda"
        calls = cfg.num_layers if kernels else 0       # a call of one step
        assert eng.graphs.captures == 1
        assert tpa.paged_attention_cuda.launches == 2 * calls
        assert eng.graphs.replayed_calls == eng.stats.decode_steps * calls
        assert tpa.paged_prefill_attention_cuda.launches == \
            (eng.stats.prefill_chunks * cfg.num_layers if kernels else 0)
    assert out[("cuda", "cuda")] == out[("grouped", "gather")]


@pytest.mark.cuda
def test_cuda_replica_group_equals_single_engine(cuda_device):
    """Reduced qwen3-8b in f32: a group of two replicas on ``cuda:0`` named
    twice, both paged kernels pinned, gives a single engine's tokens; both
    replicas serve, share the parameter tensors and replay decode graphs of
    their own, and the keys the shared VPE records under carry the mesh."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 8)]
    kw = dict(slots=2, max_len=64, block_size=8, kv_layout="paged",
              prefill_chunk=8, decode_impl="cuda", prefill_kernel="cuda")
    want = _serve(tserve.ContinuousBatchingEngine(cfg, params, device=cuda_device,
                                                  **kw), prompts, 6)
    vpe = VPE()
    grp = tserve.make_serve_engine(cfg, params, mesh_shape=(2, 1),
                                   mesh_devices=["cuda:0", "cuda:0"], vpe=vpe, **kw)
    tpa.reset_launch_counts()
    assert _serve(grp, prompts, 6) == want
    assert all(e.params is params and len(e.completed) > 0 for e in grp.engines)
    assert all(e.graphs.replays > 0 and e.pages.drained for e in grp.engines)
    assert tpa.paged_prefill_attention_cuda.launches == \
        grp.stats.prefill_chunks * cfg.num_layers
    keys = vpe.profiler.buckets_seen("serve_decode_impl")
    assert keys and all(b[-3:] == ("shard", 2, 1) for b in keys)


def _sharded_rank(group, prompts):
    """One rank of the head-sharded engine below (run by ``spawn_ranks``)."""
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(dev).manual_seed(0))
    eng = tserve.make_serve_engine(
        cfg, params, mesh_shape=(1, group.world),
        mesh_devices=["cuda:0"] * group.world,
        shard_group=group, slots=2, max_len=64, block_size=8, kv_layout="paged",
        prefill_chunk=8, decode_impl="cuda", prefill_kernel="cuda")
    tpa.reset_launch_counts()
    out = _serve(eng, prompts, 6)
    return dict(tokens=out, mismatch=eng.stats.shard_token_mismatch,
                launches=(tpa.paged_attention_cuda.launches,
                          tpa.paged_prefill_attention_cuda.launches),
                steps=(eng.stats.decode_steps, eng.stats.prefill_chunks),
                replays=eng.graphs.replays, drained=eng.pages.drained,
                heads=(eng.cfg.num_heads, eng.cfg.num_kv_heads))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 2048])
def test_cuda_f32_product_keeps_the_partial_in_f32(cuda_device, k):
    """A sharded rank's down-projection partial: the bf16 GEMM with an f32
    output equals the f32 product of the upcast operands within f32
    rounding, and is not rounded to bf16."""
    from repro_torch.distributed.group import f32_product
    gen = torch.Generator(cuda_device).manual_seed(k)
    h = torch.randn((2, 3, k), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((k, 64), generator=gen, device=cuda_device).bfloat16()
    got = f32_product(h, w)
    want = h.float() @ w.float()
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert not torch.equal(got, got.bfloat16().float())


@pytest.mark.cuda
def test_cuda_f32_product_gradients(cuda_device):
    """The backward of the f32-output GEMM on a training rank: bf16
    gradients of both operands, against autograd of the upcast product
    rounded once to bf16 (the upstream gradient holds bf16 values, as the
    gradient of a partial rounded after its sum does)."""
    from repro_torch.distributed.group import f32_product
    gen = torch.Generator(cuda_device).manual_seed(11)
    h = torch.randn((2, 3, 256), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((256, 64), generator=gen, device=cuda_device).bfloat16()
    g = torch.randn((2, 3, 64), generator=gen, device=cuda_device).bfloat16().float()
    h.requires_grad_()
    w.requires_grad_()
    got = torch.autograd.grad(f32_product(h, w), (h, w), g)
    hf, wf = (t.detach().float().requires_grad_() for t in (h, w))
    want = torch.autograd.grad(hf @ wf, (hf, wf), g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        torch.testing.assert_close(a.float(), b, rtol=2 ** -7, atol=1e-3)


def _on_grid_values(seed, n=1 << 20, block=256):
    """``n`` seeded f32 values in blocks of ``block``, half of each block's
    values exact multiples of its amax/127 (the quantizer's rounding
    boundaries lie between such multiples; a scale one ulp off moves the
    multiples themselves across them)."""
    gen = torch.Generator().manual_seed(seed)
    blocks = torch.randn((n // block, block), generator=gen)
    amax = blocks.abs().amax(1, keepdim=True)
    k = torch.randint(-127, 128, blocks.shape, generator=gen).float()
    grid = torch.rand(blocks.shape, generator=gen) < 0.5
    step = amax / torch.full_like(amax, 127.0)
    return torch.where(grid, k * step, blocks).reshape(-1)


@pytest.mark.cuda
def test_cuda_quantize_equals_cpu_bit_for_bit(cuda_device):
    """``quantize``, and the whole-leaf-block round trip of a split leaf
    (``_split_roundtrip`` of one rank's slice, over no group: each block's
    scale from the slice's own part of it), on a CUDA tensor equal the
    same calls on its CPU copy bit for bit: the scales are divided on the
    device, never multiplied by a rounded reciprocal."""
    from repro_torch.optim.compression import _split_roundtrip, quantize
    x = _on_grid_values(21)
    qc, sc = quantize(x.to(cuda_device))
    q, s = quantize(x)
    assert torch.equal(sc.cpu(), s)
    assert torch.equal(qc.cpu(), q), int((qc.cpu() != q).sum())
    # a (1024, 1024) leaf cut to columns 384..767: runs of 384 are not
    # whole blocks, so each element's block comes from the whole leaf's
    # flat order
    tot = x.reshape(1024, 1024)[:, 384:768].contiguous()
    got = _split_roundtrip(tot.to(cuda_device), (1024, 1024), [(1, 384, 384)],
                           [], 256)
    want = _split_roundtrip(tot, (1024, 1024), [(1, 384, 384)], [], 256)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_data_mean_equals_cpu_bit_for_bit(cuda_device):
    """``MeshGroups.data_mean_`` at dp = 3 on a CUDA tensor equals the same
    call on its CPU copy bit for bit (the dry run's counting group, whose
    sum over the data group is the identity, stands for the ranks): the
    sum is divided by a device tensor, not multiplied by the rounded
    reciprocal of 3 as a Python divisor makes PyTorch's CUDA kernel do."""
    from repro_torch.launch.specs import counting_groups
    groups = counting_groups(3, 1)
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(3))
    got = groups.data_mean_(x.to(cuda_device)).cpu()
    want = groups.data_mean_(x.clone())
    assert torch.equal(got, want), int((got != want).sum())


def _mesh_train_rank(group, ckpt_dir):
    """One rank of a (1, world) training mesh on ``cuda:0`` (run by
    ``spawn_ranks``): parameters drawn from the seed, each rank keeping
    its slice as each leaf is drawn; 2 steps, then a checkpoint gathered
    on the card."""
    from repro_torch.distributed.group import MeshGroups
    cfg = get_config("qwen3-8b").reduced()
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=2))
    loop = ttrain.TrainLoop(
        cfg, ttrain.TrainLoopConfig(total_steps=2, log_every=0, enable_vpe=False,
                                    watchdog=False, checkpoint_dir=ckpt_dir),
        data, seed=0, device="cuda:0", mesh=MeshGroups(group, 1, group.world))
    losses = [m["loss"] for m in loop.run()]
    loop.save()
    return losses


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [2, 4])
def test_cuda_mesh_training_checkpoint_equals_single_device(cuda_device, mp, tmp_path):
    """Reduced qwen3-8b in f32 at (1, mp), the ranks on ``cuda:0`` over
    gloo: the losses of one device's loop from the same seed, and the
    checkpoint (its shards gathered on the card) restored on one device
    gives that loop's parameters."""
    from repro_torch.distributed.group import spawn_ranks
    cfg = get_config("qwen3-8b").reduced()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    lc = dict(total_steps=2, log_every=0, enable_vpe=False, watchdog=False)
    one = ttrain.TrainLoop(cfg, ttrain.TrainLoopConfig(**lc), SyntheticStream(data),
                           seed=0, device=cuda_device)
    want = [m["loss"] for m in one.run()]
    res = spawn_ranks(_mesh_train_rank, ["cuda:0"] * mp, (str(tmp_path),))
    for losses in res:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
    back = ttrain.TrainLoop(cfg, ttrain.TrainLoopConfig(**lc, checkpoint_dir=str(tmp_path)),
                            SyntheticStream(data), seed=1, device=cuda_device)
    assert back.restore() and back.step == 2
    flat = torch.utils._pytree.tree_flatten_with_path
    for (path, a), (_, b) in zip(flat(back.params)[0], flat(one.params)[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-5, msg=str(path))


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [2, 4])
def test_cuda_head_sharded_engine_equals_single_engine(cuda_device, mp):
    """Reduced qwen3-8b in f32 at mesh (1, mp): mp ranks on ``cuda:0`` over
    gloo, both paged kernels pinned, give a single engine's tokens; each
    rank launches both kernels once a layer a step or chunk, eagerly (no
    graph replay), at its own heads: one of the two KV heads at mp = 2,
    and at mp = 4 the one its single query head reads (G = 1)."""
    from repro_torch.distributed.group import spawn_ranks
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 8)]
    want = _serve(tserve.ContinuousBatchingEngine(
        cfg, params, device=cuda_device, slots=2, max_len=64, block_size=8,
        kv_layout="paged", prefill_chunk=8, decode_impl="cuda",
        prefill_kernel="cuda"), prompts, 6)
    for res in spawn_ranks(_sharded_rank, ["cuda:0"] * mp, (prompts,)):
        assert res["tokens"] == want and res["mismatch"] == 0 and res["drained"]
        assert res["heads"] == (cfg.num_heads // mp, 1)
        steps, chunks = res["steps"]
        assert res["launches"] == (steps * cfg.num_layers, chunks * cfg.num_layers)
        assert res["replays"] == 0


def _decode_state(cfg, dev, seed):
    """A (5, B) decode-input block (rows INPUT_ROWS: tok, live, eos,
    paged, budget), a pool of random K/V and a cache whose
    distinct pages cover two 16-step horizons of every slot: slot 0 live,
    slot 1 live with a budget of 2, slot 2 not live."""
    rng = np.random.default_rng(seed)
    B, bs, nb = 3, 8, 8
    n_pages = B * nb
    pool = tmodel.init_page_pool(cfg, n_pages, bs, dev)
    for t in pool.values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    cache = tmodel.init_paged_cache(cfg, B, nb * bs, bs, n_pages, dev)
    cache["bt"].copy_(torch.from_numpy(
        rng.permutation(n_pages).reshape(B, nb).astype(np.int32)))
    cache["length"].copy_(torch.tensor([5, 20, 0], dtype=torch.int32))
    inputs = torch.tensor([rng.integers(0, cfg.vocab_size, B), [1, 1, 0],
                           [-1, -1, -1], [1, 1, 1], [16, 2, 0]],
                          dtype=torch.int32, device=dev)
    return pool, cache, inputs


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda", "grouped", "flat"])
@pytest.mark.parametrize("horizon", [1, 4, 16])
def test_cuda_decode_graph_replay_equals_eager(cuda_device, impl, horizon):
    """Reduced qwen3-8b in f32: two calls of a captured decode graph give
    the tokens, valid masks, final tokens and lengths of the eager loop on
    a copy of the state, and the pool within 1e-5; the capture moves no
    buffer; the decode wrapper counts the warm-up's and the capture's H x
    layers calls each and no replay, and the graphs count H x layers x
    replays replayed calls, for the kernel variant (0 for the gather
    variants)."""
    from repro_torch.runtime.decode_graphs import DecodeGraphs
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    pool, cache, inputs = _decode_state(cfg, cuda_device, seed=horizon)
    e_pool, e_cache, e_inputs = _clone(pool), _clone(cache), inputs.clone()
    graphs = DecodeGraphs(cfg, params, "paged", cache, inputs, pool=pool)

    def pointers():
        return [t.data_ptr() for t in (inputs, graphs.tok, graphs.live, graphs.eos,
                                       graphs.budget, cache["bt"], cache["length"],
                                       pool["k"], pool["v"])]

    before = pointers()
    counted = 0                  # the wrapper's count over the graph calls
    for _ in range(2):
        mark = tpa.paged_attention_cuda.launches
        toks, valid, _ = graphs.run(impl, horizon)
        counted += tpa.paged_attention_cuda.launches - mark
        _, _, e_toks, e_valid, e_final = tmodel.decode_steps_paged(
            cfg, params, e_pool, e_cache, e_inputs[0][:, None], e_inputs[1],
            e_inputs[2], e_inputs[4], horizon, decode_impl=impl)
        e_inputs[0].copy_(e_final)
        np.testing.assert_array_equal(valid, e_valid.cpu().numpy())
        np.testing.assert_array_equal(toks * valid, (e_toks * e_valid).cpu().numpy())
        assert torch.equal(inputs, e_inputs)
        assert torch.equal(cache["length"], e_cache["length"])
        for k in "kv":
            torch.testing.assert_close(pool[k][:, :-1], e_pool[k][:, :-1],
                                       rtol=1e-5, atol=1e-5)
    assert valid.sum(1).tolist() == [horizon, min(2, horizon), 0]
    assert pointers() == before
    assert (graphs.captures, graphs.replays) == (1, 2)
    assert graphs.pool_bytes() > 0
    calls = horizon * cfg.num_layers if impl == "cuda" else 0
    assert counted == 2 * calls
    assert graphs.replayed_calls == 2 * calls


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [1, 4])
def test_cuda_moe_decode_graph_replay_equals_eager(cuda_device, horizon):
    """Reduced qwen2-moe-a2.7b in f32: the MoE block captures (no host
    sync in its routing, scatter or gather), and two replays of the
    decode graph give the eager loop's tokens, valid masks and lengths,
    and its pool within 1e-5."""
    from repro_torch.runtime.decode_graphs import DecodeGraphs
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    assert params["layers"]["moe_router"].dtype == torch.float32
    pool, cache, inputs = _decode_state(cfg, cuda_device, seed=7 + horizon)
    e_pool, e_cache, e_inputs = _clone(pool), _clone(cache), inputs.clone()
    graphs = DecodeGraphs(cfg, params, "paged", cache, inputs, pool=pool)
    for _ in range(2):
        toks, valid, _ = graphs.run("cuda", horizon)
        _, _, e_toks, e_valid, e_final = tmodel.decode_steps_paged(
            cfg, params, e_pool, e_cache, e_inputs[0][:, None], e_inputs[1],
            e_inputs[2], e_inputs[4], horizon, decode_impl="cuda")
        e_inputs[0].copy_(e_final)
        np.testing.assert_array_equal(valid, e_valid.cpu().numpy())
        np.testing.assert_array_equal(toks * valid, (e_toks * e_valid).cpu().numpy())
        assert torch.equal(inputs, e_inputs)
        assert torch.equal(cache["length"], e_cache["length"])
        for k in "kv":
            torch.testing.assert_close(pool[k][:, :-1], e_pool[k][:, :-1],
                                       rtol=1e-5, atol=1e-5)
    assert (graphs.captures, graphs.replays) == (1, 2)


@pytest.mark.cuda
def test_cuda_decode_graph_capture_failure_raises(cuda_device):
    """A host sync inside the captured call fails the capture, and the
    error reaches the caller: no eager retry.  Run in a fresh interpreter,
    so the failed capture cannot touch the other tests' state."""
    import os
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent("""
        import numpy as np, torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as tmodel
        from repro_torch.runtime.decode_graphs import DecodeGraphs
        dev = torch.device("cuda")
        cfg = get_config("qwen3-8b").reduced()
        params = tmodel.init_params(cfg, torch.Generator(dev).manual_seed(0))
        pool = tmodel.init_page_pool(cfg, 8, 8, dev)
        cache = tmodel.init_paged_cache(cfg, 2, 32, 8, 8, dev)
        inputs = torch.zeros((5, 2), dtype=torch.int32, device=dev)
        inputs[1] = 1
        real = tmodel.decode_steps_paged
        def syncing(*args, **kw):
            out = real(*args, **kw)
            out[2].sum().item()          # a host sync: illegal under capture
            return out
        tmodel.decode_steps_paged = syncing
        graphs = DecodeGraphs(cfg, params, "paged", cache, inputs, pool=pool)
        try:
            graphs.run("grouped", 4)
        except RuntimeError as e:    # torch.AcceleratorError is one
            print("RAISED", type(e).__name__, str(e).splitlines()[0][:200])
        else:
            print("NO ERROR")
        print("CAPTURES", graphs.captures, "LIVE", inputs[1].tolist())
    """)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": src}, timeout=300)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr
    assert "CAPTURES 0 LIVE [1, 1]" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_cuda_engine_fused_horizon_equals_single_step(cuda_device):
    """Reduced qwen3-8b in f32, both kernels pinned: the engine at H = 16
    gives the tokens of H = 1; every decode call replays a graph (one
    capture per horizon used, each counted as a tainted step); the replays
    stand for one decode-kernel call per layer per decode step, and the
    wrapper counted only each capture's warm-up and recorded calls."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 5)]
    out = {}
    for horizon in (1, 16):
        eng = tserve.ContinuousBatchingEngine(
            cfg, params, slots=2, max_len=96, block_size=8, kv_layout="paged",
            prefill_chunk=8, decode_horizon=horizon, decode_impl="cuda",
            prefill_kernel="cuda", device=cuda_device)
        tpa.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=24))
        out[horizon] = {r.rid: r.out for r in eng.run()}
        eng.check_kv()
        assert eng.pages.drained
        st = eng.stats
        assert eng.graphs.captures == len(st.horizon_hist) == st.tainted_steps
        assert eng.graphs.replays == sum(st.horizon_hist.values())
        assert eng.graphs.replayed_calls == st.decode_steps * cfg.num_layers
        assert tpa.paged_attention_cuda.launches \
            == 2 * sum(st.horizon_hist) * cfg.num_layers
    assert out[16] == out[1]
    assert set(eng.stats.horizon_hist) == {1, 16}


def _verify_tokens(cfg, S, seed, first):
    """(3, S) verify inputs: each slot's last token, then random drafts."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (3, S))
    toks[:, 0] = first
    return toks.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4, 16])
def test_cuda_verify_graph_replay_equals_eager(cuda_device, S):
    """Reduced qwen3-8b in f32: two calls of a captured verify graph, each
    with new drafts written in place into its token buffer, give the token
    blocks, valid masks, final tokens and lengths of the eager
    ``spec_verify_paged`` on a copy of the state, and the pool within 1e-5;
    one capture, two replays, no buffer moved."""
    from repro_torch.runtime.decode_graphs import DecodeGraphs
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    pool, cache, inputs = _decode_state(cfg, cuda_device, seed=S)
    inputs[4] = torch.tensor([S, 2, 0], dtype=torch.int32)
    e_pool, e_cache, e_inputs = _clone(pool), _clone(cache), inputs.clone()
    graphs = DecodeGraphs(cfg, params, "paged", cache, inputs, pool=pool)
    before = [t.data_ptr() for t in (inputs, cache["bt"], cache["length"],
                                     pool["k"], pool["v"])]
    for call in range(2):
        toks = _verify_tokens(cfg, S, call, inputs[0].cpu().numpy())
        out, captured = graphs.verify(toks)
        out = out.cpu().numpy()
        assert captured == (call == 0)
        _, _, e_g, e_valid, e_final = tmodel.spec_verify_paged(
            cfg, params, e_pool, e_cache, torch.from_numpy(toks).to(cuda_device),
            e_inputs[1], e_inputs[2], e_inputs[4])
        e_inputs[0].copy_(e_final)
        np.testing.assert_array_equal(out[1], e_valid.cpu().numpy())
        np.testing.assert_array_equal(out[0] * out[1], (e_g * e_valid).cpu().numpy())
        assert torch.equal(inputs, e_inputs)
        assert torch.equal(cache["length"], e_cache["length"])
        for k in "kv":
            torch.testing.assert_close(pool[k][:, :-1], e_pool[k][:, :-1],
                                       rtol=1e-5, atol=1e-5)
        assert out[1].sum(1)[2] == 0 and 1 <= out[1].sum(1)[1] <= 2
    assert (graphs.verify_captures, graphs.verify_replays) == (1, 2)
    assert graphs.captures == 0
    assert [t.data_ptr() for t in (inputs, cache["bt"], cache["length"],
                                   pool["k"], pool["v"])] == before


@pytest.mark.cuda
def test_cuda_verify_capture_moves_nothing(cuda_device):
    """The verify graph's warm-up and capture, with ``live`` at zero, leave
    every length and every page but the trash page as they were, and put
    ``live`` back; the first replay then writes the span."""
    from repro_torch.runtime.decode_graphs import DecodeGraphs
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    pool, cache, inputs = _decode_state(cfg, cuda_device, seed=3)
    graphs = DecodeGraphs(cfg, params, "paged", cache, inputs, pool=pool)
    S = 4
    graphs.verify_tokens[S] = torch.from_numpy(
        _verify_tokens(cfg, S, 0, inputs[0].cpu().numpy())).to(cuda_device)
    snap_pool, snap_len, live = _clone(pool), cache["length"].clone(), inputs[1].clone()
    entry = graphs._capture(lambda: graphs._verify_call(S), None)
    torch.cuda.synchronize()
    assert torch.equal(cache["length"], snap_len)
    assert torch.equal(inputs[1], live)
    for k in "kv":
        assert torch.equal(pool[k][:, :-1], snap_pool[k][:, :-1])
    entry.graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(cache["length"], snap_len)
    assert not all(torch.equal(pool[k][:, :-1], snap_pool[k][:, :-1]) for k in "kv")


@pytest.mark.cuda
def test_cuda_demoted_decode_rung_runs_grouped_and_repromotes(cuda_device):
    """Reduced qwen3-8b in f32, both kernels pinned: a planned stall on a
    single decode step demotes ``decode_cuda``; the next steps replay the
    ``grouped`` graph, and after the probation window the kernel's graph
    replays again; the tokens are the fault-free run's."""
    from repro_torch.runtime.serve_faults import FaultPlan, FaultSpec
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 3)]
    out = {}
    for plan in (None, FaultPlan([FaultSpec("decode", "stall", 2)])):
        eng = tserve.ContinuousBatchingEngine(
            cfg, params, slots=2, max_len=64, block_size=8, kv_layout="paged",
            prefill_chunk=8, decode_impl="cuda", prefill_kernel="cuda",
            fault_plan=plan, watchdog=True, probation_steps=3, device=cuda_device)
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=16))
        out[plan is None] = {r.rid: r.out for r in eng.run()}
        eng.check_kv()
        assert eng.pages.drained
    st = eng.stats
    assert st.demotions == {"decode_cuda": 1} and st.repromotions == 1
    assert st.watchdog_trips == 1
    grouped, kernel = eng.graphs.graphs[("grouped", 1)], eng.graphs.graphs[("cuda", 1)]
    assert grouped.replays == 3
    assert kernel.replays == sum(st.horizon_hist.values()) - 3
    assert eng.graphs.replayed_calls_of("cuda") == kernel.replays * cfg.num_layers
    assert out[False] == out[True]


@pytest.mark.cuda
def test_cuda_swap_roundtrip_bf16_pool(cuda_device):
    """A bf16 pool of random K/V at qwen3-8b's KV heads on the card: three
    pages copied by ``swap_out_pages`` into pinned host memory, scattered
    back by ``swap_in_pages`` into three others up to a partial tail block
    (the ids padded with the trash page), gathered again: bit-exact, and
    the trash padding wrote nothing."""
    from repro_torch.models import kvcache as tkv
    rng = np.random.default_rng(21)
    L, Hkv, bs, D, n_pages = 3, 8, 16, 128, 24
    pool = tkv.init_page_pool(n_pages, L, Hkv, bs, D, dtype=torch.bfloat16,
                              device=cuda_device)
    for t in pool.values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    trash_before = [pool[k][:, n_pages].clone() for k in "kv"]
    ids = torch.tensor([7, 2, 19], dtype=torch.int64)
    filled = 3 * bs - 5
    host = tkv.swap_out_pages(pool, torch.tensor([7, 2, 19, 7], device=cuda_device))
    assert all(h.is_pinned() and h.device.type == "cpu" for h in host)
    new_ids = [3, 11, 0, n_pages]
    tkv.swap_in_pages(pool, host[0], host[1], torch.tensor(new_ids),
                      torch.tensor([0, bs, 2 * bs, -bs]), filled)
    back_k, back_v = tkv.gather_pages(pool, torch.tensor(new_ids[:3], device=cuda_device))
    want_k, want_v = tkv.gather_pages(pool, ids.to(cuda_device))
    assert torch.equal(back_k[..., :filled, :], want_k[..., :filled, :])
    assert torch.equal(back_v[..., :filled, :], want_v[..., :filled, :])
    assert torch.equal(back_k[..., :filled, :].cpu(), host[0][..., :filled, :])
    for key, before in zip("kv", trash_before):
        assert torch.equal(pool[key][:, n_pages], before)


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_cuda_engine_under_page_budget_equals_unpressured(cuda_device, swap):
    """Reduced qwen3-8b in f32, both kernels pinned, ``decode_horizon=16``:
    under a page budget near its floor, growth preempts decoding slots
    (the grower itself included) between graph replays, and the resumed
    requests (one-token recompute chunks, or swap-in and a mid-block
    prefill) give the tokens of the same engine without the budget; the
    pool is audit-clean and drained, and no graph is captured beyond one
    per horizon used."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    prompts = [np.random.default_rng(22).integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 21, 13, 30, 17, 9, 25, 12)]
    out = {}
    for budget in (None, 11):
        eng = tserve.ContinuousBatchingEngine(
            cfg, params, slots=4, max_len=64, block_size=8, kv_layout="paged",
            decode_horizon=16, decode_impl="cuda",
            prefill_kernel="cuda", page_budget=budget, swap=swap,
            device=cuda_device)
        for i, p in enumerate(prompts):
            eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=20,
                                      priority="interactive" if i % 2 == 0
                                      else "batch"))
        done = eng.run()
        assert all(r.status == "done" for r in done)
        out[budget] = {r.rid: r.out for r in done}
        eng.check_kv()
        assert eng.pages.drained
        st = eng.stats
        assert eng.graphs.captures == len(st.horizon_hist) == st.tainted_steps
        assert eng.graphs.replayed_calls == st.decode_steps * cfg.num_layers
        assert len(st.ttft_s) == len(prompts)
    assert out[11] == out[None]
    assert st.preemptions > 0 and st.decode_preemptions > 0
    if swap:
        assert st.swap_outs == st.swap_ins > 0


def _flash_inputs(case, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, S, T, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "T", "D"))
    arrs = (rng.standard_normal((B, Hq, S, D)),
            rng.standard_normal((B, Hkv, T, D)),
            rng.standard_normal((B, Hkv, T, D)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrs]


def _shared_prompts(vocab, seed, n=5):
    """Prompts sharing 29 tokens (3 full 8-token blocks and 5 of a fourth),
    each with a suffix of its own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 29).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, int(m)).astype(np.int32)])
            for m in rng.integers(3, 20, n)]


def _serve(eng, prompts, new_tokens, warm=()):
    for j, p in enumerate(warm):
        eng.submit(tserve.Request(rid=-1 - j, prompt=p, max_new_tokens=2))
        eng.run()
    for i, p in enumerate(prompts):
        eng.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    out = {r.rid: r.out for r in eng.run() if r.rid >= 0}
    eng.check_kv()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous", "auto"])
def test_cuda_engine_prefix_cache_warm_equals_cold(cuda_device, layout):
    """Reduced qwen3-8b in f32 on the card, decode and prefill kernels
    pinned: with the prefix cache warm (the tree filled by one request),
    each layout gives the tokens of a cold engine without the cache; the
    paged warm admissions clone the partially matched block, and the pool
    ends holding the tree's pages only."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    prompts = _shared_prompts(cfg.vocab_size, 13)
    kw = dict(slots=2, max_len=64, block_size=8, prefill_chunk=8, decode_impl="cuda",
              prefill_kernel="cuda", device=cuda_device)
    cold = _serve(tserve.ContinuousBatchingEngine(cfg, params, kv_layout="paged", **kw),
                  prompts, 8)
    eng = tserve.ContinuousBatchingEngine(cfg, params, kv_layout=layout,
                                          prefix_blocks=16, **kw)
    assert _serve(eng, prompts, 8, warm=prompts[:1]) == cold
    st = eng.stats
    assert st.prefix_hits == len(prompts) and st.prefix_tokens_saved >= 24 * len(prompts)
    if layout == "paged":
        assert st.cow_copies >= 1
    if eng.pages is not None:
        assert eng.pages.num_live == len(eng.prefix_cache.owned_pages())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "auto"])
def test_cuda_layout_decode_graphs_captured_once(cuda_device, layout):
    """Reduced qwen3-8b in f32, ``decode_impl="cuda"``: the contiguous and
    ``auto`` engines capture one graph per (layout, variant, H) used and
    replay it thereafter (a second pass of the traffic captures nothing);
    the graphs stand for one decode-kernel call a layer a step on ``auto``
    (its paged read) and none on the contiguous layout (the kernel variant
    is grouped there); the tokens are those of the paged engine."""
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    prompts = _shared_prompts(cfg.vocab_size, 14)
    kw = dict(slots=2, max_len=96, block_size=8, prefill_chunk=8, decode_impl="cuda",
              prefill_kernel="cuda", decode_horizon=4, device=cuda_device)
    want = _serve(tserve.ContinuousBatchingEngine(cfg, params, kv_layout="paged",
                                                  **kw), prompts, 13)
    eng = tserve.ContinuousBatchingEngine(cfg, params, kv_layout=layout, **kw)
    assert _serve(eng, prompts, 13) == want
    st, g = eng.stats, eng.graphs
    keys = {("grouped" if layout == "contiguous" else "cuda", h)
            for h in st.horizon_hist}
    assert g.layout == layout and set(g.graphs) == keys and g.captures == len(keys) == st.tainted_steps
    calls = cfg.num_layers if layout == "auto" else 0
    assert g.replays == sum(st.horizon_hist.values())
    assert g.replayed_calls == st.decode_steps * calls
    captures = g.captures
    eng.stats = tserve.ServeStats()
    assert _serve(eng, prompts, 13) == want
    assert g.captures == captures and eng.stats.tainted_steps == 0


@pytest.mark.cuda
def test_cuda_contiguous_admission_launches_flash(cuda_device):
    """``attn_impl="flash_cuda"`` on the contiguous layout: a cold admission
    prefills through the flash kernel, one launch a layer; a warm one
    prefills its suffix against the cached prefix (no flash launch); the
    tokens are those of the reference attention's engine."""
    import dataclasses
    cfg = get_config("qwen3-8b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    prompts = _shared_prompts(cfg.vocab_size, 15, n=3)
    kw = dict(slots=2, max_len=64, kv_layout="contiguous", prefix_blocks=8,
              block_size=8, device=cuda_device)
    want = _serve(tserve.ContinuousBatchingEngine(cfg, params, **kw), prompts, 6)
    cfg_f = dataclasses.replace(cfg, attn_impl="flash_cuda")
    eng = tserve.ContinuousBatchingEngine(cfg_f, params, **kw)
    tfa.reset_launch_counts()
    eng.submit(tserve.Request(rid=-1, prompt=prompts[0], max_new_tokens=2))
    eng.run()
    assert tfa.flash_attention_cuda.launches == cfg.num_layers
    tfa.reset_launch_counts()
    assert _serve(eng, prompts, 6) == want
    assert eng.stats.prefix_hits == len(prompts)
    assert tfa.flash_attention_cuda.launches == 0


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


# the recurrent and encoder-decoder families' heads (D = 64): zamba2-1.2b's
# causal shared block, whisper-base's non-causal encoder, and its
# cross-attention with S < T (rows offset by T - S > 0) and S > T (the
# reduced config's 32 rows against 24 frames: a negative offset)
FAMILY_FLASH_CASES = [
    dict(B=2, Hq=32, Hkv=32, S=256, T=256, D=64, causal=True),
    dict(B=1, Hq=8, Hkv=8, S=1500, T=1500, D=64, causal=False),
    dict(B=2, Hq=8, Hkv=8, S=32, T=1500, D=64, causal=False),
    dict(B=2, Hq=8, Hkv=8, S=256, T=1500, D=64, causal=False),
    dict(B=2, Hq=8, Hkv=8, S=32, T=24, D=64, causal=False),
    dict(B=1, Hq=8, Hkv=8, S=200, T=70, D=64, causal=False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_FLASH_CASES)
def test_cuda_flash_at_the_family_shapes(cuda_device, case, dtype):
    q, k, v = _flash_inputs(case, cuda_device, dtype, seed=9)
    got = tfa.flash_attention_cuda(q, k, v, causal=case["causal"])
    torch.cuda.synchronize()
    want = tref.attention_ref(q, k, v, causal=case["causal"])
    atol, rtol = FLASH_TOLERANCES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_hybrid_wave_serving_flash_equals_reference(cuda_device):
    """Reduced zamba2-1.2b (f32) served in waves on the card: the shared
    block's prefill through the flash kernel (one launch a macro a wave)
    gives the tokens of the reference attention."""
    import dataclasses
    cfg = get_config("zamba2-1.2b").reduced()
    params = tmodel.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 9, 32, 20, 5, 12)]
    out = {}
    for impl in ("reference", "flash_cuda"):
        sched = tserve.WaveScheduler(tserve.ServeLoop(
            dataclasses.replace(cfg, attn_impl=impl), params, max_len=64, batch=4,
            device=cuda_device))
        for i, p in enumerate(prompts):
            sched.submit(tserve.Request(rid=i, prompt=p, max_new_tokens=8))
        before = tfa.flash_attention_cuda.launches
        out[impl] = {r.rid: r.out for r in sched.run()}
        launched = tfa.flash_attention_cuda.launches - before
        # two waves, one launch a shared-block application each
        assert launched == (2 * (cfg.num_layers // cfg.attn_every)
                            if impl == "flash_cuda" else 0)
    assert out["flash_cuda"] == out["reference"]


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


# the flash backward kernel: (B, Hq, Hkv, S, T, D, causal, window) — danube's
# heads at S = 512 and at its training shape, zamba2's D = 64 causal at 32/32
# heads, whisper's non-causal S != T both ways, a window under S, S, T and D
# off the tiles, a head split at mp = 2 (16/4), and a batch of 2
FLASH_BWD_CASES = [
    (1, 32, 8, 512, 512, 120, True, None),
    (1, 32, 8, 4096, 4096, 120, True, 4096),
    (1, 32, 32, 256, 256, 64, True, None),
    (2, 8, 8, 200, 300, 64, False, None),
    (2, 8, 8, 32, 24, 64, False, None),
    (1, 8, 2, 256, 256, 120, True, 100),
    (1, 8, 2, 130, 250, 100, True, None),
    (2, 16, 4, 1000, 1000, 120, True, None),
]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_cuda_flash_bwd_against_mirror_and_vjp(cuda_device, case):
    """The backward kernel (bf16, from the forward kernel's output and
    log-sum-exp) against its plain version, which makes the same bf16
    roundings of P and dS (relative distance of each gradient under 1e-3;
    measured on an H100 1e-4-3.6e-4: sums in another order, exp2 against
    ex2.approx), and against autograd through ``attention_chunked`` in f32
    (under 1e-2; measured 2.3e-3-2.5e-3 in chip_smoke phase 3c: the
    gradients' own bf16 rounding)."""
    B, Hq, Hkv, S, T, D, causal, window = case
    gen = torch.Generator(cuda_device).manual_seed(31)
    q, k, v, g = (torch.randn((B, h, n, D), generator=gen, device=cuda_device).bfloat16()
                  for h, n in ((Hq, S), (Hkv, T), (Hkv, T), (Hq, S)))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        with_lse=True)
    before = tfa.flash_attention_bwd_cuda.launches
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_cuda.launches == before + 1
    mirror = tref.flash_attention_bwd_ref(q, k, v, out, lse[:, :, :S], g, causal=causal,
                                          window=window, block_q=256, block_k=256)
    with tref.full_f32():
        tq, tk, tv = (t.float().requires_grad_() for t in (q, k, v))
        o = tlayers.attention_chunked(tq, tk, tv, causal=causal, window=window)
        plain = torch.autograd.grad(o, (tq, tk, tv), g.float())
    for a, m, p in zip(got, mirror, plain):
        assert a.shape == m.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all()
        assert _rel(a, m) < 1e-3
        assert _rel(a, p) < 1e-2


@pytest.mark.cuda
def test_cuda_flash_bwd_is_deterministic(cuda_device):
    """No atomics: dQ comes from its own q-parallel pass and dK, dV sum a
    group's heads in registers, so two calls give the same bits."""
    gen = torch.Generator(cuda_device).manual_seed(33)
    q, k, v, g = (torch.randn((1, h, 1024, 120), generator=gen, device=cuda_device).bfloat16()
                  for h in (32, 8, 8, 32))
    out, lse = tfa.flash_attention_cuda(q, k, v, with_lse=True)
    first = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    second = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,causal,window", [(512, 512, 120, True, None),
                                                 (4096, 4096, 120, True, 4096),
                                                 (130, 250, 64, True, 100),
                                                 (200, 70, 64, False, None)])
def test_cuda_flash_lse_leaves_the_output_unchanged(cuda_device, S, T, D, causal, window):
    """``with_lse``: the forward kernel's output bit for bit as without it,
    and each row's log-sum-exp that of its kept f32 scores (rows with a
    kept column)."""
    gen = torch.Generator(cuda_device).manual_seed(32)
    q, k, v = (torch.randn((1, h, n, D), generator=gen, device=cuda_device).bfloat16()
               for h, n in ((32, S), (8, T), (8, T)))
    plain = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    want = tref.attention_lse_ref(q, k, causal=causal, window=window)
    kept = torch.isfinite(want)
    torch.testing.assert_close(lse[:, :, :S][kept], want[kept], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_bwd_rejects_bad_arguments(cuda_device):
    q = torch.zeros((1, 8, 128, 64), device=cuda_device, dtype=torch.bfloat16)
    kv = q[:, :2].contiguous()
    out, lse = tfa.flash_attention_cuda(q, kv, kv, with_lse=True)
    before = tfa.flash_attention_bwd_cuda.launches
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd_cuda(q.float(), kv.float(), kv.float(), out.float(), lse,
                                     q.float())
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_cuda(q, kv, kv, out, lse[:, :, :64], q)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_cuda(q, kv, kv, out.cpu(), lse, q)
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 128, 136), device=cuda_device, dtype=torch.bfloat16)
        tfa.flash_attention_bwd_cuda(big, big[:, :2], big[:, :2], big, lse, big)
    assert tfa.flash_attention_bwd_cuda.launches == before


@pytest.mark.cuda
def test_cuda_train_step_flash_bf16_launches_the_backward(cuda_device):
    """One TrainLoop step of reduced h2o-danube-3-4b in bf16 under remat with
    flash_cuda pinned: the forward kernel twice a layer (forward and the
    remat recomputation), the backward kernel once, never the plain VJP;
    the loss within bf16 rounding of the reference variant's."""
    import dataclasses
    base = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(), dtype="bfloat16",
                               remat="full")
    params = tmodel.init_params(base, torch.Generator(cuda_device).manual_seed(0))
    data = DataConfig(vocab_size=base.vocab_size, seq_len=256, global_batch=2)
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
        flash = impl == "flash_cuda"
        assert tfa.flash_attention_cuda.launches == (2 * cfg.num_layers if flash else 0)
        assert tfa.flash_attention_bwd_cuda.launches == (cfg.num_layers if flash else 0)
    assert np.isfinite(losses["flash_cuda"])
    assert losses["flash_cuda"] == pytest.approx(losses["reference"], rel=1e-2)


# matmul: tests/test_kernels.py's shapes, the paper path's 512^3, one off
# every tile, and the Fig. 2b sweep's largest; then k and n off the
# 16-byte copies (the predicated-load path), on both tiles
MATMUL_CASES = [(128, 256, 128), (256, 512, 256), (100, 200, 60), (8, 8, 8),
                (1, 512, 128), (384, 128, 384), (512, 512, 512), (1000, 1000, 1000),
                (4096, 4096, 4096), (33, 257, 65), (512, 513, 511), (2050, 300, 2047)]
# conv2d (h, w, kh, kw): tests/test_kernels.py's shapes, make_inputs at
# scale 0.02, the paper's 512^2 * 5x5 and the image pipeline's 384^2
# Laplacian; then non-square taps, the largest taps, rows that do not start
# on 16 bytes (widths 61 and 127: odd, so bf16 rows also start at odd
# element offsets) on both tiles, and 4096^2 * 5x5 (the 64 x 64 tile)
CONV_CASES = [(64, 64, 3, 3), (64, 64, 5, 5), (37, 53, 5, 5), (128, 96, 11, 11),
              (16, 16, 3, 3), (66, 64, 3, 3), (10, 10, 5, 5), (512, 512, 5, 5),
              (384, 384, 3, 3), (40, 48, 3, 5), (64, 61, 7, 1), (61, 64, 1, 7),
              (40, 40, 32, 32), (64, 61, 3, 3), (100, 127, 5, 5), (900, 901, 3, 3),
              (4096, 4096, 5, 5)]


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
@pytest.mark.parametrize("h,w,kh,kw", CONV_CASES)
def test_cuda_conv2d_against_plain(cuda_device, h, w, kh, kw, dtype):
    gen = torch.Generator(cuda_device).manual_seed(h * w + kh + 33 * (kw - kh))
    x = torch.randn((h, w), generator=gen, device=cuda_device).to(dtype)
    ker = torch.randn((kh, kw), generator=gen, device=cuda_device).to(dtype)
    before = tconv.conv2d.launches
    got = tconv.conv2d(x, ker)
    torch.cuda.synchronize()
    assert tconv.conv2d.launches == before + 1
    assert got.shape == (h - kh + 1, w - kw + 1) and got.dtype == dtype
    atol, rtol = CONV_TOLERANCES[dtype]
    torch.testing.assert_close(got.float(), tref.conv2d_ref(x, ker).float(),
                               rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert torch.equal(got, tconv.conv2d(x.float(), ker.float()).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k", [(512, 512, 5), (384, 384, 3), (37, 53, 5),
                                   (100, 127, 3), (1024, 1000, 5)])
def test_cuda_conv2d_instantiations_equal_bit_for_bit(cuda_device, h, w, k):
    """The 3x3 and 5x5 instantiations (taps fixed at compile time) equal the
    runtime-size instantiation bit for bit in f32, on both tiles, and the
    two tiles equal each other: every one sums the same taps in the same
    order.  Each launch is counted."""
    gen = torch.Generator(cuda_device).manual_seed(h + w + k)
    x = torch.randn((h, w), generator=gen, device=cuda_device)
    ker = torch.randn((k, k), generator=gen, device=cuda_device)
    fixed = tconv.CONV_TAPS.index((k, k))
    before = tconv.conv2d.launches
    want = tconv.launch(x, ker, 0, 0)
    for taps in (0, fixed):
        for tile in range(len(tconv.CONV_TILES)):
            assert torch.equal(tconv.launch(x, ker, taps, tile), want), (taps, tile)
    torch.cuda.synchronize()
    assert tconv.conv2d.launches == before + 1 + 2 * len(tconv.CONV_TILES)
    with pytest.raises(ValueError):
        tconv.launch(x, ker.new_zeros((k, k + 1)), fixed, 0)  # taps not the instance's
    with pytest.raises(ValueError):
        tconv.launch(x, ker, 0, len(tconv.CONV_TILES))        # no such tile


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
    assert (tmm.matmul.launches, tconv.conv2d.launches) == (
        before[0] + 1, before[1] + len(tconv.INSTANTIATIONS))
    assert len(tconv.INSTANTIATIONS) == 2 * len(tconv.CONV_TAPS) * len(tconv.CONV_TILES)


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
