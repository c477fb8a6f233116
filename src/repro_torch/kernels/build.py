"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` (paged attention, flash attention forward and
backward, matmul, conv2d, the attention tile core ``attention_tile.cuh``
that the attention kernels include, and ``tensor_map.cuh``, the flash
kernels' TMA maps) are compiled for Hopper (``sm_90a``) by one ``nvcc`` process
per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
goes to ``build/repro_torch_kernels/`` at the root of the checkout, named
by a hash of every ``.cu`` and ``.cuh`` file in ``csrc/`` and the flags,
so an edited source or header rebuilds and unchanged ones load at once.
The build happens at first use, so a fresh checkout needs nothing
prebuilt.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of the library: name -> (argtypes, restype)
SIGNATURES = {
    "repro_paged_decode_attention": ((_P,) * 7 + (_I,) * 9 + (_F, _I, _I, _I, _P), _I),
    "repro_paged_prefill_attention": (
        (_P, _P, _P, _P, _P, _I, _P) + (_I,) * 8 + (_F, _I, _P), _I),
    "repro_paged_decode_smem": ((_I,) * 4, ctypes.c_size_t),
    "repro_paged_prefill_smem": ((_I, _I, _I), ctypes.c_size_t),
    "repro_flash_attention": ((_P,) * 5 + (_I,) * 10 + (_F, _I, _P), _I),
    "repro_flash_attention_bwd": ((_P,) * 10 + (_I,) * 10 + (_F, _I, _P), _I),
    "repro_flash_bwd_block_q": ((), _I),
    "repro_flash_bwd_block_k": ((), _I),
    "repro_flash_bwd_head_tile": ((_I,), _I),
    "repro_flash_block_q": ((_I,), _I),
    "repro_flash_block_k": ((_I,), _I),
    "repro_flash_max_head_dim": ((), _I),
    "repro_matmul": ((_P,) * 3 + (_I,) * 5 + (_P,), _I),
    "repro_conv2d": ((_P,) * 3 + (_I,) * 7 + (_P,), _I),
    "repro_conv2d_max_taps": ((), _I),
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the toolkit is "
                           "installed")
    return str(path)


def sources() -> list:
    """The ``.cu`` files of ``csrc/``, one ``nvcc`` each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if it is missing: every source at once, each by
    its own ``nvcc``, then one link.  Returns the compilers' output
    (``-Xptxas=-v`` register and spill counts), empty when the library was
    already built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        logs, failed = [], []
        for src, proc in zip(srcs, procs):
            stdout, stderr = proc.communicate()
            logs.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{stdout}{stderr}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc(), "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}{link.stderr}")
        os.replace(lib, out)        # atomic: a reader never sees half a file
    return "".join(logs)


def sm_count(device) -> int:
    """The SM count of a CUDA device (a ``torch.device``), which the
    wrappers' launch plans take; cached per device."""
    import torch
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded library (built first if missing), with the argument and
    result types of every entry point declared."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
