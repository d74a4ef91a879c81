"""K3 fused sampling (csrc/sampling.cu) and its plain version.

Replaces ``fused_sample_pallas`` (zonos_tpu/ops/pallas_kernels.py:232):
softmax(logits / T) -> unified reshaping -> min-p -> Gumbel race, one id per
(row, codebook).  The Gumbel noise is an operand, so kernel and plain
version give the same ids for the same noise.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"zt_fused_sample": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P]}
MAX_VOCAB = 12 * 1024  # the row must fit the kernel's 48 KB of shared memory


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
    noise of one shape ``[B, K, V]`` with V at most MAX_VOCAB (the row lives in
    shared memory).  ``ops/sampling.py`` runs the plain version where it does
    not."""
    return (logits.dtype == noise.dtype == torch.float32 and logits.dim() == 3
            and logits.shape == noise.shape and logits.shape[-1] <= MAX_VOCAB)


def fused_sample(logits: torch.Tensor, noise: torch.Tensor, linear: float, conf: float,
                 quad: float, min_p: float, temperature: float = 1.0) -> torch.Tensor:
    """One CTA per (row, codebook); CPU tensors take the plain version."""
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
    lib = library("sampling", _SIGNATURES)
    rc = lib.zt_fused_sample(
        logits.data_ptr(), noise.data_ptr(), out.data_ptr(), B * K, V,
        float(temperature), float(linear), float(conf), float(quad), float(min_p),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    check(rc, "fused_sample")
    launch_counts["fused_sample"] += 1
    return out
