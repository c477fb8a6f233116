"""The paper path of the port against the JAX package's, on the CPU.

Holds ``repro_torch.kernels.matmul.matmul`` and ``kernels.conv2d.conv2d``
(their CPU path: the plain versions) against ``repro.kernels.ops`` (the
Pallas kernels in interpret mode, as the JAX tests run them), the plain
versions against ``repro.kernels.ref``, ``bench_algos`` (inputs, every
variant, the VPE's decisions and bucket keys) against
``repro.bench_algos``, and runs both examples on the CPU.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.

Tolerances are those of the JAX tests: matmul 5e-4 (f32) and 2e-2 (bf16),
conv2d 2e-4 — the same sums in another order; variants against the
reference 2e-2 as in tests/test_system.py (the DFT sums 327 terms of
angles computed in f32); integer results equal, in value and dtype.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.bench_algos import build_vpe as jax_build_vpe  # noqa: E402
from repro.bench_algos import make_inputs as jax_make_inputs  # noqa: E402
from repro.core import shape_bucket as jax_shape_bucket  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bench_algos import ALGORITHMS, build_vpe, make_inputs  # noqa: E402
from repro_torch.core import shape_bucket  # noqa: E402
from repro_torch.examples import image_pipeline, quickstart  # noqa: E402
from repro_torch.kernels import conv2d as tconv  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)
NAMES = ("complement", "convolution", "dotproduct", "matmul", "patternmatch", "fft")
# tests/test_kernels.py's shapes
MATMUL_SHAPES = [(128, 256, 128), (256, 512, 256), (100, 200, 60), (8, 8, 8),
                 (1, 512, 128), (384, 128, 384)]
# tests/test_kernels.py's shapes, and make_inputs("convolution", scale=0.02)
CONV_SHAPES = [(64, 64, 3), (64, 64, 5), (37, 53, 5), (128, 96, 11), (16, 16, 3),
               (10, 10, 5)]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_matches_pallas(m, k, n):
    a, b = _normal(m + k + n, (m, k), (k, n))
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tmm.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_matmul_bf16_matches_pallas():
    a, b = _normal(1, (128, 256), (256, 128))
    want = jops.matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    got = tmm.matmul(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("m,n,tile", [
    (512, 512, (64, 32)),        # Table 1: 128 blocks of 4 warps on 132 SMs
    (1000, 1000, (64, 32)),      # 128 x 128 tiles would give 64 blocks
    (2048, 2048, (128, 128)),    # 256 blocks of 128 x 128
    (4096, 4096, (128, 128)),    # Fig. 2b's largest
    (1, 128, (64, 32)),
])
def test_matmul_tile_choice(m, n, tile):
    """The kernel's tile: at least 128 blocks of at least 4 warps at
    Table 1's 512^2 on an H100 (132 SMs), and 128 x 128 tiles where those
    fill every SM."""
    rows, cols, threads = tmm.MATMUL_TILES[tmm.matmul_tile(m, n, 132)]
    assert (rows, cols) == tile
    assert threads // 32 >= 4
    if (m, n) == (512, 512):
        assert -(-m // rows) * -(-n // cols) >= 128


@pytest.mark.parametrize("h,w,k", CONV_SHAPES)
def test_conv2d_matches_pallas(h, w, k):
    x, ker = _normal(h * w + k, (h, w), (k, k))
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(ker)))
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(ker))
    assert got.dtype == torch.float32 and tuple(got.shape) == (h - k + 1, w - k + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_oracles(dtype):
    """ref.matmul_ref and ref.conv2d_ref against repro.kernels.ref: f32
    sums inside and one rounding to the input dtype on both sides."""
    a, b, x, ker = _normal(2, (100, 200), (200, 60), (37, 53), (5, 5))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = dict(rtol=5e-4, atol=5e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    got = tref.matmul_ref(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    want = jref.matmul_ref(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    got = tref.conv2d_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(ker).to(tdt))
    want = jref.conv2d_ref(jnp.asarray(x, jdt), jnp.asarray(ker, jdt))
    assert got.dtype == tdt and tuple(got.shape) == (33, 49)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else tol))


def test_wrappers_reject_bad_arguments_on_cpu():
    a = torch.zeros((8, 8))
    with pytest.raises(TypeError):
        tmm.matmul(a, a.double())
    with pytest.raises(ValueError):
        tmm.matmul(a, torch.zeros((4, 8)))
    with pytest.raises(ValueError):
        tmm.matmul(a.t(), a[:, :4])
    with pytest.raises(ValueError):
        tconv.conv2d(a, torch.zeros((9, 9)))
    with pytest.raises(ValueError):
        tconv.conv2d(torch.zeros((40, 40)), torch.zeros((33, 3)))
    with pytest.raises(ValueError):
        tconv.conv2d(a[None], a[:3, :3])
    assert tmm.matmul.launches == 0 and tconv.conv2d.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_equal_bit_for_bit(name):
    """The paper's own sizes (scale 1.0): the same numbers in both packages."""
    want = jax_make_inputs(name, scale=1.0, seed=0)
    got = make_inputs(name, scale=1.0, seed=0, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def jax_reference_variants():
    vpe, _ = jax_build_vpe(with_pallas=False)
    return {name: vpe.registry.op(name).variants["reference"].fn for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_every_variant_matches_jax_reference(name, jax_reference_variants):
    want = np.asarray(jax_reference_variants[name](*jax_make_inputs(name, scale=0.02)))
    args = make_inputs(name, scale=0.02, device="cpu")
    vpe, _ = build_vpe(device="cpu")
    variants = vpe.registry.op(name).variants
    expected = {"convolution": {"reference", "fused", "cuda"},
                "matmul": {"reference", "fused", "cuda"}, "fft": {"reference", "dsp"}}
    assert set(variants) == expected.get(name, {"reference", "fused"})
    for vname, variant in variants.items():
        got = variant.fn(*args).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (name, vname)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{name}:{vname}")
        else:
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2,
                                       err_msg=f"{name}:{vname} diverges from reference")


def test_vpe_keeps_fused_matmul_and_reverts_fft_like_jax():
    """tests/test_system.py's decisions on the port, on the CPU: matmul
    moves to ``fused``, the FFT's ``dsp`` trial is reverted; the bucket
    keys equal JAX's."""
    vpe, fns = build_vpe(with_cuda=False, device="cpu")
    for name in ("matmul", "fft"):
        args = make_inputs(name, scale=0.05, device="cpu")
        for _ in range(8):
            fns[name](*args)
    buckets = {name: shape_bucket(*make_inputs(name, scale=0.05, device="cpu"))
               for name in ("matmul", "fft")}
    for name, bucket in buckets.items():
        assert bucket == jax_shape_bucket(*jax_make_inputs(name, scale=0.05))
    assert {op for op, _ in vpe.controller._decisions} == {"matmul", "fft"}
    assert vpe.controller.selected("matmul", buckets["matmul"]) == "fused"
    assert vpe.controller.selected("fft", buckets["fft"]) == "reference"
    assert [e for e, _, _ in vpe.controller.decision("fft", buckets["fft"]).history] \
        == ["trial", "revert"]


def test_paper_speedups_match_jax():
    from repro.bench_algos import ALGORITHMS as JAX_ALGORITHMS
    assert {n: a.paper_speedup for n, a in ALGORITHMS.items()} == \
        {n: a.paper_speedup for n, a in JAX_ALGORITHMS.items()}


def _jax_example(name):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_image_pipeline_runs_on_cpu_and_concludes_its_trials():
    jax_pipeline = _jax_example("image_pipeline")
    for t in (0, 13, 59):
        assert np.array_equal(image_pipeline.synth_frame(t, 48),
                              np.asarray(jax_pipeline.synth_frame(t, 48)))
    assert np.array_equal(np.asarray(jax_pipeline.EDGE_KERNEL), image_pipeline.EDGE_KERNEL)
    r = image_pipeline.main(device="cpu", hw=48)
    assert len(r["fps_trace"]) == 60 and all(np.isfinite(r["fps_trace"]))
    events = [(e, v) for e, v, _ in r["history"]]
    for v in ("fused", "cuda"):
        assert ("trial", v) in events
        assert ("switch", v) in events or ("revert", v) in events
    assert r["decision"] in ("reference", "fused", "cuda")
    assert r["fps_before"] > 0 and r["fps_after"] > 0


def test_quickstart_runs_on_cpu_and_concludes_its_trials():
    """Both smoothing variants give the 5-point circular mean (f32 sums of
    five terms in another order than the f64 reference), and the demo
    concludes every trial it starts."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    want = sum(np.roll(x.astype(np.float64), s) for s in (-2, -1, 0, 1, 2)) / 5.0
    for fn in (quickstart.smooth_naive, quickstart.smooth_fused):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    out = quickstart.main(device="cpu")
    assert "trial fused" in out["smooth"]
    assert "switch fused" in out["smooth"] or "revert fused" in out["smooth"]
    assert "trial dsp" in out["bench"] and "revert dsp" in out["bench"]
    assert "trial fused" in out["bench"] and "cuda" not in out["bench"]
