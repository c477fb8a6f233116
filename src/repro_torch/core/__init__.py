"""VPE core — transparent profile-guided dispatch (the paper's contribution).

    from repro_torch.core import VPE
    vpe = VPE()

    @vpe.op("matmul")
    def matmul(a, b): return a @ b          # reference variant

    @vpe.variant("matmul", variant="cuda")
    def matmul_cuda(a, b): ...              # accelerated target

    y = matmul(a, b)    # profiled; VPE trials/keeps/reverts variants
"""

from .controller import Controller, Decision
from .dispatch import VPE, VPEFunction, block_until_ready
from .profiler import Profiler, SampleSet, Welford
from .registry import OpEntry, Registry, Variant
from .shape_class import (bucket_label, occupancy_bucket, pad_to_bucket,
                          prefill_chunk_bucket, prefix_len_bucket,
                          shape_bucket)

__all__ = [
    "VPE", "VPEFunction", "block_until_ready", "Controller", "Decision",
    "Profiler", "SampleSet", "Welford", "Registry", "OpEntry", "Variant",
    "shape_bucket", "bucket_label", "occupancy_bucket", "pad_to_bucket",
    "prefix_len_bucket", "prefill_chunk_bucket",
]
