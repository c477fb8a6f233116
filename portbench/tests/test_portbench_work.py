"""The work counts reproduce the "bound ms" column of PERF.md's kernel table
at its shapes.  That table counted whole pages of K/V and whole block-table
rows for decode; the metric counts each slot's real length and the page ids
it reads (fewer bytes), shown here beside it."""

import pytest

from portbench import peaks, work


def test_paged_decode_bound_of_the_kernel_table():
    # B=4, D=128, bs=16, nb=64, lengths [461, 365, 309, 201], bf16, 32/8 heads
    lengths = [461, 365, 309, 201]
    whole = [work.pages(n, 16) * 16 for n in lengths]
    nbytes = work.paged_decode_bytes(whole, 32, 8, 128, 2, table_entries=4 * 64)
    assert nbytes / peaks.HBM_BYTES * 1e3 == pytest.approx(0.0016827271641791045, rel=1e-12)
    real = work.paged_decode_bytes(lengths, 32, 8, 128, 2,
                                   table_entries=sum(work.pages(n, 16) for n in lengths))
    assert real < nbytes
    assert real == 2 * 4 * 32 * 128 * 2 + 2 * 1336 * 8 * 128 * 2 + 85 * 4 + 16


def test_paged_prefill_bound_of_the_kernel_table():
    # C=128 at base 256, bf16, table row of 64 pages
    nbytes = work.paged_prefill_bytes(256, 128, 32, 8, 128, 2, table_entries=64)
    ops = work.paged_prefill_ops(256, 128, 32, 128)
    secs = work.roofline_seconds(ops, nbytes, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    assert secs * 1e3 == pytest.approx(0.001095604776119403, rel=1e-12)


def test_flash_operations_of_the_kernel_table():
    # B=1, Hq=32, Hkv=8, S=T=4096, D=120, causal, bf16
    ops = work.flash_fwd_ops(1, 4096, 32, 120)
    assert ops == 128_880_476_160
    nbytes = work.flash_fwd_bytes(1, 4096, 32, 8, 120)
    secs = work.roofline_seconds(ops, nbytes, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    assert secs * 1e3 == pytest.approx(0.13031392938321537, rel=1e-12)
    # a window as long as the sequence keeps every causal pair
    assert work.flash_fwd_ops(1, 4096, 32, 120, window=4096) == ops


@pytest.mark.parametrize("window", [None, 3, 100])
def test_causal_pairs_count_by_brute_force(window):
    for q, base in ((1, 0), (7, 0), (5, 9), (16, 33)):
        brute = sum(1 for i in range(q) for j in range(base + i + 1)
                    if window is None or j > base + i - window)
        assert work.causal_pairs(q, base, window) == brute


def test_model_flops_add_up():
    from portbench.families.dense import Dims
    d = Dims("x", 2, 64, 4, 2, 16, 128, 100, 1e4, 1e-6, False, False, False, None, "bfloat16")
    per_layer = 64 * 16 * (2 * 4 + 2 * 2) + 3 * 64 * 128
    assert work.layer_matmul_params(d) == per_layer
    # a chunk of n tokens is n tokens' weights, its causal pairs, one logits row
    n, base = 5, 3
    want = (2 * per_layer * 2 * n + 4 * work.causal_pairs(n, base) * 4 * 16 * 2
            + 2 * 64 * 100)
    assert work.prefill_chunk_flops(d, base, n) == want
    assert work.decode_step_flops(d, [3, 0]) == (
        work.token_flops(d, 4, True) + work.token_flops(d, 1, True))
    assert work.train_step_flops(d, 1000, 2, 8) == (
        6 * 1000 * 16 + 12 * 16 * 4 * work.causal_pairs(8, 0) * 2 * 2)
