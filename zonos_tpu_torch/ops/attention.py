"""Attention for prefill and cached single-token decode (GQA, RoPE'd inputs).

- :func:`prefill_attention` / :func:`fresh_prefill_attention`: causal
  attention over the prompt as plain torch ops (zonos_tpu/ops/attention.py:
  81-116).  Scores and softmax are fp32; the weights are cast to v's dtype
  before the value product.
- :func:`decode_attention`: one query step against the cache, dispatched by
  device: a CUDA tensor goes to the hand-written kernels (K2 while the cache
  holds at most one 256-row block, K1 beyond), a CPU tensor to the plain
  version.

KV cache layout: ``[B, H_kv, S_max, head_dim]``.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.kernels.decode_attention import (
    BLOCK_S,
    attention_scale,
    decode_attention_plain,
    decode_attention_single,
    flash_decode_attention,
)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, H, D] x k [B, H_kv, Sk, D] -> fp32 scores [B, H_kv, G, Sq, Sk]."""
    B, Sq, H, D = q.shape
    H_kv = k.shape[1]
    qh = q.transpose(1, 2).reshape(B, H_kv, H // H_kv, Sq, D)
    return torch.einsum("bhgqd,bhkd->bhgqk", qh.float(), k.float())


def _gqa_output(weights: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """weights [B, H_kv, G, Sq, Sk] x v [B, H_kv, Sk, D] -> [B, Sq, H, D]."""
    B, H_kv, G, Sq, _ = weights.shape
    D = v.shape[-1]
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(v.dtype), v)
    return out.reshape(B, H_kv * G, Sq, D).transpose(1, 2).to(out_dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seq_len: int) -> torch.Tensor:
    """Causal attention of the S prompt queries ``q [B, S, H, D]`` against
    cache positions [0, seq_len) of ``k, v [B, H_kv, S_max, D]``."""
    D = q.shape[-1]
    scores = _gqa_scores(q, k[:, :, :seq_len]) * attention_scale(D)
    S = q.shape[1]
    causal = torch.arange(seq_len, device=q.device)[None, :] <= torch.arange(S, device=q.device)[:, None]
    scores = scores.masked_fill(~causal, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return _gqa_output(weights, v[:, :, :seq_len], q.dtype)


def fresh_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention among the prompt tokens: q [B, S, H, D], k/v
    [B, S, H_kv, D] (prefill always starts at position 0)."""
    return prefill_attention(q, k.transpose(1, 2), v.transpose(1, 2), seq_len=q.shape[1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q [B, 1, H, D] against the first ``length`` rows of the cache."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length)
    if length <= BLOCK_S:
        return decode_attention_single(q, k_cache, v_cache, length)
    return flash_decode_attention(q, k_cache, v_cache, length)
