"""Port paged-attention kernels: the plain versions against the JAX Pallas
kernels (interpret mode, their CPU default) and the CPU dispatch of the
wrappers.  The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py.

Tolerance 3e-5 (f32): the same function summed in another order, as in
tests/test_kernels.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)

DECODE_CASES = [
    dict(B=3, Hq=4, Hkv=2, bs=8, nb=4, D=32, window=None),   # GQA
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, D=32, window=9),      # SWA
    dict(B=2, Hq=4, Hkv=4, bs=16, nb=3, D=16, window=None),  # MHA
    dict(B=1, Hq=8, Hkv=1, bs=4, nb=8, D=64, window=None),   # MQA
]
PREFILL_CASES = [
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, C=16, D=32, window=None),  # GQA
    dict(B=2, Hq=4, Hkv=2, bs=8, nb=6, C=8, D=32, window=11),     # SWA
    dict(B=1, Hq=8, Hkv=1, bs=4, nb=8, C=12, D=64, window=None),  # MQA
    dict(B=3, Hq=4, Hkv=4, bs=16, nb=4, C=1, D=16, window=None),  # C=1
]


def _pool(rng, N, Hkv, bs, D):
    return (rng.standard_normal((N, Hkv, bs, D)).astype(np.float32),
            rng.standard_normal((N, Hkv, bs, D)).astype(np.float32))


def _decode_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, bs, nb, D = (case[k] for k in ("B", "Hq", "Hkv", "bs", "nb", "D"))
    N = nb * B
    kp, vp = _pool(rng, N, Hkv, bs, D)
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    bt = rng.integers(0, N, (B, nb)).astype(np.int32)
    bt[1:, 0] = bt[0, 0]           # rows share pages (aliased prefix)
    lengths = rng.integers(0, nb * bs, (B,)).astype(np.int32)
    return q, kp, vp, bt, lengths


def _prefill_inputs(case, seed=2):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, bs, nb, C, D = (case[k] for k in
                                ("B", "Hq", "Hkv", "bs", "nb", "C", "D"))
    N = nb * B
    kp, vp = _pool(rng, N, Hkv, bs, D)
    q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
    bt = rng.integers(0, N, (B, nb)).astype(np.int32)
    base = rng.integers(0, nb * bs - C + 1, (B,)).astype(np.int32)
    return q, kp, vp, bt, base


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_against_pallas(case):
    inputs = _decode_inputs(case)
    got = tref.paged_attention_ref(*_t(*inputs), window=case["window"])
    want = jpa.paged_attention_pallas(*_j(*inputs), window=case["window"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_read_dtype_against_gather_path(case):
    """With read_dtype the plain version reproduces the serve gather
    path (bf16 K/V reads, probabilities cast to bf16 before the value
    product) and the two-phase Pallas body."""
    q, kp, vp, bt, lengths = _decode_inputs(case, seed=5)
    w = case["window"]
    got = tref.paged_attention_ref(*_t(q, kp, vp, bt, lengths), window=w,
                                   read_dtype=torch.bfloat16)
    kg, vg = jkv.paged_gather_layer(*_j(kp, vp, bt), out_dtype=jkv.SLOT_CACHE_DTYPE)
    gather = jkv.decode_attention(jnp.asarray(q), kg, vg, jnp.asarray(lengths),
                                  window=w)
    pallas = jpa.paged_attention_pallas(*_j(q, kp, vp, bt, lengths), window=w,
                                        read_dtype=jkv.SLOT_CACHE_DTYPE)
    # the worst difference on these inputs is 6e-8 (both references)
    np.testing.assert_allclose(got.numpy(), np.asarray(gather), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # and the port's own gather path computes the same thing
    tkg, tvg = tkv.paged_gather_layer(*_t(kp, vp, bt), out_dtype=tkv.SLOT_CACHE_DTYPE)
    port_gather = tkv.decode_attention(torch.from_numpy(q), tkg, tvg,
                                       torch.from_numpy(lengths), window=w)
    np.testing.assert_allclose(port_gather.numpy(), np.asarray(gather), **TOL)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_plain_against_pallas(case):
    inputs = _prefill_inputs(case)
    got = tref.paged_prefill_attention_ref(*_t(*inputs), window=case["window"])
    want = jpa.paged_prefill_attention_pallas(*_j(*inputs), window=case["window"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_chunk_len_padding():
    """Rows past chunk_len are padding; columns at or past base+chunk_len
    (unwritten pages) are masked for the real rows."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, bs, nb, C, D, clen = 1, 4, 2, 8, 4, 16, 32, 11
    kp, vp = _pool(rng, nb, Hkv, bs, D)
    q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
    bt = np.arange(nb, dtype=np.int32)[None]
    base = np.array([8], np.int32)
    got = tref.paged_prefill_attention_ref(*_t(q, kp, vp, bt, base), chunk_len=clen)
    want = jpa.paged_prefill_attention_pallas(*_j(q, kp, vp, bt, base),
                                              chunk_len=clen)
    np.testing.assert_allclose(got.numpy()[:, :, :clen],
                               np.asarray(want)[:, :, :clen], **TOL)


def test_prefill_fully_masked_padding_row_is_zero():
    """A padded row beyond every valid column's window gives 0 (what the
    CUDA kernel writes), not NaN."""
    rng = np.random.default_rng(4)
    kp, vp = _pool(rng, 4, 1, 4, 8)
    q = rng.standard_normal((1, 1, 16, 8)).astype(np.float32)
    out = tref.paged_prefill_attention_ref(
        *_t(q, kp, vp, np.arange(4, dtype=np.int32)[None],
            np.array([0], np.int32)), chunk_len=2, window=3)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0, 0, 15], torch.zeros(8))


class TestCpuDispatch:
    """On CPU tensors a wrapper IS its plain version and counts nothing."""

    def test_decode_wrapper_uses_plain_version(self):
        inputs = _t(*_decode_inputs(DECODE_CASES[0]))
        before = tpa.paged_attention_cuda.launches
        got = tpa.paged_attention_cuda(*inputs, read_dtype=torch.bfloat16)
        want = tref.paged_attention_ref(*inputs, read_dtype=torch.bfloat16)
        assert torch.equal(got, want)
        assert tpa.paged_attention_cuda.launches == before

    def test_prefill_wrapper_uses_plain_version(self):
        inputs = _t(*_prefill_inputs(PREFILL_CASES[1]))
        before = tpa.paged_prefill_attention_cuda.launches
        got = tpa.paged_prefill_attention_cuda(*inputs, chunk_len=5, window=11)
        want = tref.paged_prefill_attention_ref(*inputs, chunk_len=5, window=11)
        assert torch.equal(got, want)
        assert tpa.paged_prefill_attention_cuda.launches == before

    def test_other_devices_raise(self, monkeypatch):
        """A device with neither a plain version nor a kernel raises.  The
        meta device runs the plain version now (the dry run's path), so
        this stands meta in for such a device."""
        monkeypatch.setattr(tpa, "PLAIN_DEVICES", ("cpu",))
        q = torch.zeros((1, 2, 1, 8), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tpa.paged_attention_cuda(q, q, q, q, q)
        with pytest.raises(ValueError, match="unsupported device"):
            tpa.paged_prefill_attention_cuda(q, q, q, q, q)

    def test_meta_tensors_run_the_plain_version(self):
        """The dry run's meta tensors take the plain version's path and
        count no launch: the output's shape and dtype, nothing computed."""
        from repro_torch.kernels import flash_attention as tfa
        meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
        for fn, inputs, kw, want in (
                (tpa.paged_attention_cuda, _t(*_decode_inputs(DECODE_CASES[0])),
                 {}, tref.paged_attention_ref),
                (tpa.paged_prefill_attention_cuda, _t(*_prefill_inputs(PREFILL_CASES[1])),
                 {"chunk_len": 5, "window": 11}, tref.paged_prefill_attention_ref)):
            before = fn.launches
            got = fn(*meta(*inputs), **kw)
            ref = want(*inputs, **kw)
            assert got.is_meta and got.shape == ref.shape and got.dtype == ref.dtype
            assert fn.launches == before
        q = torch.zeros((1, 4, 40, 32), device="meta")
        kv = torch.zeros((1, 2, 40, 32), device="meta")
        before = tfa.flash_attention_cuda.launches
        out = tfa.flash_attention_cuda(q, kv, kv, causal=True)
        assert out.is_meta and out.shape == q.shape
        assert tfa.flash_attention_cuda.launches == before

    def test_mixed_devices_raise(self):
        """A CPU q with the pool elsewhere is refused, not run as the
        plain version."""
        q = torch.zeros((1, 2, 1, 8))
        pool = torch.zeros((1, 2, 4, 8), device="meta")
        with pytest.raises(ValueError, match="k_pool is on meta"):
            tpa.paged_attention_cuda(q, pool, pool, q, q)
        with pytest.raises(ValueError, match="k_pool is on meta"):
            tpa.paged_prefill_attention_cuda(q, pool, pool, q, q)

