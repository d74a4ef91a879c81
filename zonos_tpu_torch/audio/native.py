"""ctypes binding of the native audio engine (the repository's
csrc/audio_engine.cpp; the port of zonos_tpu/audio/native.py).

Built with g++ on first use into ``build/zonos_tpu_torch/``, as
``text/native.py`` builds the G2P engine; on any failure the caller
(``audio/io.py`` ``resample``) uses scipy, whose ``resample_poly`` default
filter the C++ design matches.  Host resampling, not a device kernel.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger("zonos_tpu_torch.audio.native")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "csrc" / "audio_engine.cpp"
_LIB = _REPO_ROOT / "build" / "zonos_tpu_torch" / "libzonos_audio.so"

_lib = None
_tried = False


def _build() -> bool:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename, so a concurrent process never
        # loads a half-written library
        tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception as e:
        logger.debug("native audio build failed: %s", e)
        return False


def get_lib():
    """The loaded library, or None where it cannot be built or loaded."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _SRC.exists() or not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
        lib.zonos_resample_out_len.restype = ctypes.c_long
        lib.zonos_resample_out_len.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.zonos_resample.restype = ctypes.c_int
        lib.zonos_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        _lib = lib
    except OSError as e:
        logger.debug("native audio load failed: %s", e)
        _lib = None
    return _lib


def resample_native(wav: np.ndarray, up: int, down: int) -> np.ndarray | None:
    """Polyphase resample of ``[channels, samples]`` float32 by ``up/down``,
    or None where the library is unavailable or refuses."""
    lib = get_lib()
    if lib is None:
        return None
    wav = np.ascontiguousarray(wav, np.float32)
    ch, n_in = wav.shape
    n_out = lib.zonos_resample_out_len(n_in, up, down)
    out = np.empty((ch, n_out), np.float32)
    rc = lib.zonos_resample(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_in, ch, up, down,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out,
    )
    return None if rc != 0 else out
