"""Attention for prefill and cached single-token decode (GQA, RoPE'd inputs).

- :func:`prefill_attention` / :func:`fresh_prefill_attention`: causal
  attention over the prompt as plain torch ops (zonos_tpu/ops/attention.py:
  81-116).  Scores and softmax are fp32; the weights are cast to v's dtype
  before the value product.  On the card the rows go in calls of a fixed
  batch (``PREFILL_ROWS``), so that a row's result does not depend on its
  co-batched rows.
- :func:`decode_attention`: one query step against the cache, dispatched by
  device, dtype and shape: CUDA tensors the kernels take (``kernel_takes``:
  bf16, head_dim 128, 1, 2, 4 or 8 query heads a kv head) go to the
  hand-written kernels, K2 or K1 by the band of the length (K2 up to 256
  rows); anything else, as in JAX on any backend, to the plain version.
- :func:`decode_attention_held_out`: the same over an f8 or int8 cache, with
  the current token's k/v held out in the compute dtype
  (``decode_attention_split``, zonos_tpu/ops/attention.py:119); K2/K1's
  quantized-storage variants on the card where they take the operands.

A decode step's position is a :class:`StepPosition`: tensors on the model's
device and the host's band of the length, so that the step reads nothing back
from the card.  KV cache layout: ``[B, H_kv, S_max, head_dim]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from zonos_tpu_torch.kernels.decode_attention import (
    Band,
    attention_scale,
    band_of,
    decode_attention_plain,
    decode_attention_single,
    decode_attention_single_held_out,
    decode_attention_split_plain,
    flash_decode_attention,
    flash_decode_attention_held_out,
    gqa_output,
    kernel_takes,
    resolve_band,
)


@dataclass(frozen=True)
class StepPosition:
    """Where a decode step writes and how far it attends, on the device:
    ``row`` the cache row (int64 ``[1]``, an index operand), ``pos`` the same
    as an int32 (a quantized cache's attended rows) and ``length`` ``pos + 1``
    (a bf16 cache's); ``band`` the host's :class:`Band` of ``length``, which
    fixes the kernel and its launch."""

    row: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor
    band: Band

    @classmethod
    def of(cls, pos: torch.Tensor, band: Band) -> "StepPosition":
        """From a 0-d integer tensor ``pos`` (the cache row) and its band."""
        pos32 = pos.to(torch.int32)
        return cls(pos.reshape(1).long(), pos32, pos32 + 1, band)

    @classmethod
    def at(cls, pos: int, device) -> "StepPosition":
        """From a host int (a caller outside the decode loop)."""
        return cls.of(torch.full((), pos, dtype=torch.int64, device=device), band_of(pos + 1))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, H, D] x k [B, H_kv, Sk, D] -> fp32 scores [B, H_kv, G, Sq, Sk]."""
    B, Sq, H, D = q.shape
    H_kv = k.shape[1]
    qh = q.transpose(1, 2).reshape(B, H_kv, H // H_kv, Sq, D)
    return torch.einsum("bhgqd,bhkd->bhgqk", qh.float(), k.float())


PREFILL_ROWS = 8  # rows of one prefill-attention call on the card: every call the same batch


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seq_len: int) -> torch.Tensor:
    """Causal attention of the S prompt queries ``q [B, S, H, D]`` against
    cache positions [0, seq_len) of ``k, v [B, H_kv, S_max, D]``.

    On the card the rows go in calls of exactly PREFILL_ROWS (the last padded
    with zeros): the library's batched products pick their kernel by the
    batch, so a fixed batch gives a row the same bits alone and among any
    number of rows.  The CPU computes all rows in one call."""
    if not q.is_cuda:
        return _prefill_attention(q, k, v, seq_len)
    B = q.shape[0]
    k, v = k[:, :, :seq_len], v[:, :, :seq_len]
    pad = -B % PREFILL_ROWS  # (padded even by none: every batch runs the same ops on a chunk)
    q, k, v = (torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) for t in (q, k, v))
    out = torch.cat([_prefill_attention(q[i:i + PREFILL_ROWS], k[i:i + PREFILL_ROWS],
                                        v[i:i + PREFILL_ROWS], seq_len)
                     for i in range(0, B + pad, PREFILL_ROWS)])
    return out[:B]


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seq_len: int) -> torch.Tensor:
    D = q.shape[-1]
    scores = _gqa_scores(q, k[:, :, :seq_len]) * attention_scale(D)
    S = q.shape[1]
    causal = torch.arange(seq_len, device=q.device)[None, :] <= torch.arange(S, device=q.device)[:, None]
    scores = scores.masked_fill(~causal, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return gqa_output(weights, v[:, :, :seq_len], q.dtype)


def fresh_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention among the prompt tokens: q [B, S, H, D], k/v
    [B, S, H_kv, D] (prefill always starts at position 0)."""
    return prefill_attention(q, k.transpose(1, 2), v.transpose(1, 2), seq_len=q.shape[1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int | torch.Tensor, band: Band | None = None) -> torch.Tensor:
    """q [B, 1, H, D] against the first ``length`` rows of the cache:
    ``length`` a host int or an int32 on the device with its ``band``."""
    if not (q.is_cuda and kernel_takes(q, k_cache, v_cache)):
        return decode_attention_plain(q, k_cache, v_cache, length)
    band = resolve_band(length, band, held_out=False)
    kernel = decode_attention_single if band.kernel == "K2" else flash_decode_attention
    return kernel(q, k_cache, v_cache, length, band)


def decode_attention_held_out(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                              k_new: torch.Tensor, v_new: torch.Tensor,
                              pos: int | torch.Tensor, k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None,
                              band: Band | None = None) -> torch.Tensor:
    """q [B, 1, H, D] against cache rows [0, pos) plus the held-out current
    row ``k_new``/``v_new`` [B, 1, H_kv, D] (``pos + 1`` rows in all):
    ``pos`` a host int or an int32 on the device with the band of ``pos + 1``."""
    args = (q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale)
    if not (q.is_cuda and kernel_takes(q, k_cache, v_cache, k_new, v_new, k_scale, v_scale)):
        return decode_attention_split_plain(*args)
    band = resolve_band(pos, band, held_out=True)
    kernel = (decode_attention_single_held_out if band.kernel == "K2"
              else flash_decode_attention_held_out)
    return kernel(*args, band=band)
