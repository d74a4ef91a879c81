"""K1/K2 decode attention (csrc/decode_attention.cu) and its plain version.

Replaces ``flash_decode_attention_pallas`` and ``decode_attention_pallas``
(zonos_tpu/ops/pallas_kernels.py:147, :58): one query token per row against
a KV cache masked to its first ``length`` rows.  ``length`` is a host int,
so a decode step never reads anything back from the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library

BLOCK_S = 256  # cache rows per split; compiled into the kernel
HEAD_DIM = 128  # compiled into the kernel
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is instantiated for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_flash_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "zt_decode_attention_single": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int) -> float:
    """1/sqrt(D) rounded as an fp32 computation, like the JAX reference."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: int) -> torch.Tensor:
    """q [B, 1, H, D] vs cache [B, H_kv, S, D], first ``length`` rows valid ->
    [B, 1, H, D].  fp32 scores and softmax; the weights are cast to v's dtype
    before the value product (zonos_tpu/ops/attention.py:173-210)."""
    B, _, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // H_kv
    qh = q.transpose(1, 2).reshape(B, H_kv, G, 1, D)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qh.float(), k_cache.to(q.dtype).float())
    scores = scores * attention_scale(D)
    valid = torch.arange(S, device=q.device) < length
    scores = scores.masked_fill(~valid, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, 1, D).transpose(1, 2).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int) -> tuple:
    if not (k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("q, k_cache and v_cache must lie on the same CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"decode attention kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, _, H, D = q.shape
    Bk, H_kv, S, Dk = k.shape
    if Bk != B or Dk != D or D != HEAD_DIM or H % H_kv or H // H_kv not in GROUPS:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention kernel takes contiguous tensors")
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside [1, {S}]")
    return B, H_kv, H // H_kv, S


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: int, block_s: int = BLOCK_S) -> torch.Tensor:
    """K1: split over 256-row cache blocks, one CTA per (block, row, kv head),
    then a combine pass.  CPU tensors take the plain version."""
    length = int(length)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length)
    if block_s != BLOCK_S:
        raise ValueError(f"the kernel is compiled for block_s={BLOCK_S}")
    B, H_kv, G, S = _check(q, k_cache, v_cache, length)
    n_split = -(-length // BLOCK_S)
    # per-split (m, l) [B*H_kv, n_split, G] each and acc [B*H_kv, n_split, G, D], fp32,
    # in one allocation
    n = B * H_kv * n_split * G
    scratch = torch.empty(n * (2 + HEAD_DIM), dtype=torch.float32, device=q.device)
    m_ptr = scratch.data_ptr()
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_flash_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        m_ptr, m_ptr + 4 * n, m_ptr + 8 * n,
        B, H_kv, G, S, length, n_split, attention_scale(HEAD_DIM),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, "flash_decode_attention")
    launch_counts["flash_decode_attention"] += 1
    return out


def decode_attention_single(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            length: int) -> torch.Tensor:
    """K2: one CTA per (row, kv head) walks every valid block; one launch,
    no combine pass.  CPU tensors take the plain version."""
    length = int(length)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length)
    B, H_kv, G, S = _check(q, k_cache, v_cache, length)
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_decode_attention_single(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, H_kv, G, S, length, attention_scale(HEAD_DIM),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, "decode_attention_single")
    launch_counts["decode_attention_single"] += 1
    return out

