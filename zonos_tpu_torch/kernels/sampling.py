"""K3 fused sampling (csrc/sampling.cu) and its plain version.

Replaces ``fused_sample_pallas`` (zonos_tpu/ops/pallas_kernels.py:232):
softmax(logits / T) -> unified reshaping -> min-p -> Gumbel race, one id per
(row, codebook).  The Gumbel noise is an operand, so kernel and plain
version give the same ids for the same noise.

Two hand-written routes, picked by the vocabulary alone (:func:`sample_plan`):
one warp a row with the row in registers up to ``WARP_MAX_VOCAB`` entries (the
flagship's padded 1152), one CTA a row with the row in shared memory up to
``MAX_VOCAB``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"zt_fused_sample_warp": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P],
               "zt_fused_sample_cta": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P],
               "zt_fused_sample_prepare": []}
MAX_VOCAB = 12 * 1024  # the CTA route's row must fit 48 KB of shared memory
# the warp route's J (csrc/sampling.cu kChunks): lane l holds entries 4 (32 j + l) + c,
# j < J, c < 4; 9 holds the flagship's padded 1152 entries exactly
WARP_CHUNKS = 9
WARP_MAX_VOCAB = 128 * WARP_CHUNKS  # 36 entries a lane
WARPS_PER_CTA = 2  # rows a CTA on the warp route (chip_smoke.py --sweep)


class SamplePlan(NamedTuple):
    route: str  # "warp" or "cta"
    warps: int  # rows a CTA (1 on the CTA route)


def sample_plan(V: int) -> SamplePlan:
    """The launch for rows of ``V`` entries: the warp route up to
    ``WARP_MAX_VOCAB``, else the CTA route.  It depends on V alone, so a row's
    sums and id depend only on V and its own operands (not on the row count)."""
    return SamplePlan("warp", WARPS_PER_CTA) if V <= WARP_MAX_VOCAB else SamplePlan("cta", 1)


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The library, with the CTA route's shared memory limit raised on the
    device: once, at the first launch, so never while a CUDA graph is being
    captured."""
    lib = library("sampling", _SIGNATURES)
    with torch.cuda.device(device_index):
        check(lib.zt_fused_sample_prepare(), "fused_sample_prepare")
    return lib


def fused_sample_scores_plain(logits: torch.Tensor, noise: torch.Tensor, linear: float,
                              conf: float, quad: float, min_p: float,
                              temperature: float = 1.0) -> torch.Tensor:
    """The race scores log p + G (-inf where p == 0) whose argmax is the
    sampled id (the math of zonos_tpu/ops/pallas_kernels.py:196-229)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    if linear > 0:
        logp = torch.log(torch.clamp(probs, min=1e-20))
        ent = -torch.sum(probs * logp, dim=-1, keepdim=True)
        raw = logp * (linear + ent * conf) - logp * logp * quad
        probs = torch.softmax(raw, dim=-1)
    if min_p > 0:
        top = probs.amax(dim=-1, keepdim=True)
        probs = torch.where(probs < min_p * top, torch.zeros_like(probs), probs)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.where(probs > 0, torch.log(probs) + noise, torch.full_like(probs, float("-inf")))


def fused_sample_plain(logits: torch.Tensor, noise: torch.Tensor, linear: float, conf: float,
                       quad: float, min_p: float, temperature: float = 1.0) -> torch.Tensor:
    """logits, noise [B, K, V] fp32 -> ids [B, K] int64."""
    scores = fused_sample_scores_plain(logits, noise, linear, conf, quad, min_p, temperature)
    return torch.argmax(scores, dim=-1)


def kernel_takes(logits: torch.Tensor, noise: torch.Tensor) -> bool:
    """Whether K3 takes these operands, by dtype and shape: fp32 logits and
    noise of one shape ``[B, K, V]`` with V at most MAX_VOCAB (the CTA route's
    row lives in shared memory).  ``ops/sampling.py`` runs the plain version
    where it does not."""
    return (logits.dtype == noise.dtype == torch.float32 and logits.dim() == 3
            and logits.shape == noise.shape and logits.shape[-1] <= MAX_VOCAB)


def fused_sample(logits: torch.Tensor, noise: torch.Tensor, linear: float, conf: float,
                 quad: float, min_p: float, temperature: float = 1.0) -> torch.Tensor:
    """One warp (V <= 1152) or one CTA per (row, codebook)
    (:func:`sample_plan`); CPU tensors take the plain version."""
    if not logits.is_cuda:
        return fused_sample_plain(logits, noise, linear, conf, quad, min_p, temperature)
    if not noise.is_cuda or noise.device != logits.device:
        raise ValueError("logits and noise must lie on the same CUDA device")
    if not kernel_takes(logits, noise):
        if logits.dtype != torch.float32 or noise.dtype != torch.float32:
            raise TypeError(f"fused_sample takes fp32, got {logits.dtype}/{noise.dtype}")
        raise ValueError(f"fused_sample takes logits and noise of one shape [B, K, V], V at most "
                         f"{MAX_VOCAB}; got {tuple(logits.shape)} and {tuple(noise.shape)}")
    if not (logits.is_contiguous() and noise.is_contiguous()):
        raise ValueError("fused_sample takes contiguous tensors")
    if not temperature > 0:
        raise ValueError("fused_sample needs temperature > 0 (temperature 0 is an argmax)")
    B, K, V = logits.shape
    out = torch.empty((B, K), dtype=torch.int64, device=logits.device)
    plan = sample_plan(V)
    lib = _library(logits.device.index)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    params = (float(temperature), float(linear), float(conf), float(quad), float(min_p))
    if plan.route == "warp":
        rc = lib.zt_fused_sample_warp(logits.data_ptr(), noise.data_ptr(), out.data_ptr(), B * K,
                                      V, plan.warps, *params, stream)
    else:
        rc = lib.zt_fused_sample_cta(logits.data_ptr(), noise.data_ptr(), out.data_ptr(), B * K,
                                     V, *params, stream)
    check(rc, "fused_sample")
    launch_counts["fused_sample"] += 1
    return out
