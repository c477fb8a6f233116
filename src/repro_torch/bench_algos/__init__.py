"""The paper's six benchmark algorithms (§5.1), VPE-registered.

complement, convolution, dot product, matrix multiplication, pattern
matching, FFT — the counterpart of ``repro.bench_algos``.
"""

from .algos import ALGORITHMS, build_vpe, make_inputs

__all__ = ["ALGORITHMS", "build_vpe", "make_inputs"]
