"""ctypes binding for the native G2P rule engine (csrc/g2p_engine.cpp).

Builds the shared library on first use (cached under
``build/zonos_tpu_torch/``); if the toolchain or build fails, callers fall
back to the pure-Python matcher — behavior is identical (the same rule table
drives both).  The C++ source is the repository's shared ``csrc/``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger("zonos_tpu_torch.text.native")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "csrc" / "g2p_engine.cpp"
_LIB = _REPO_ROOT / "build" / "zonos_tpu_torch" / "libzonos_g2p.so"

_engine = None
_lib = None
_tried = False


def _serialize_rules() -> str:
    from zonos_tpu_torch.text.g2p_rules_en import RULES

    lines = []
    for grapheme, left, right, phones in RULES:
        lines.append(f"{grapheme}\t{left}\t{right}\t{phones}")
    return "\n".join(lines) + "\n"


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
        logger.debug("native g2p build failed: %s", e)
        return False


def get_engine():
    """Returns a callable word -> phones string, or None if unavailable."""
    global _engine, _lib, _tried
    if _tried:
        return _engine
    _tried = True
    if not _SRC.exists() or not _build():
        return None
    try:
        _lib = ctypes.CDLL(str(_LIB))
        _lib.g2p_create.restype = ctypes.c_void_p
        _lib.g2p_create.argtypes = [ctypes.c_char_p]
        _lib.g2p_apply.restype = ctypes.c_int
        _lib.g2p_apply.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        handle = _lib.g2p_create(_serialize_rules().encode())

        def apply(word: str) -> str:
            buf = ctypes.create_string_buffer(4096)
            n = _lib.g2p_apply(handle, word.encode(), buf, 4096)
            if n < 0:
                return ""
            return buf.value.decode()

        _engine = apply
        logger.debug("native g2p engine loaded from %s", _LIB)
    except Exception as e:
        logger.debug("native g2p load failed: %s", e)
        _engine = None
    return _engine
