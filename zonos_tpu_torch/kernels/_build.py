"""Build and load the hand-written CUDA kernels.

Each ``zonos_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/zonos_tpu_torch/`` under the repository root, named by a hash of the
source, the shared headers and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  Builds happen at first use; :func:`build_all` starts one ``nvcc``
per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zonos_tpu_torch"
SOURCES = ("decode_attention", "sampling", "snake_conv", "ssd_chunked", "ssm_state",
           "layer_tail", "int4_matmul", "gemm", "row_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, every
    ``csrc/*.cuh`` header (a source may include any of them) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together.  Returns the ``-Xptxas -v``
    report (registers, shared memory, spills) of each source it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not lib_path(n).exists() for n in names) else None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>``; every function in
    ``signatures`` gets its ``argtypes`` and an ``int`` (cudaError_t) result."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (132 on an H100
    SXM): the kernels with a split contraction size their grids to one wave."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
