"""Rotary position embeddings, base-10000 frequencies, fp32 rotation
(zonos_tpu/ops/rope.py:17-61): interleaved (real, imag) pairs for the
transformer, rotate-halves (GPT-NeoX) for the hybrid's attention layers."""

from __future__ import annotations

import functools

import torch

MAX_ROPE_POSITIONS = 16384


def rope_table(head_dim: int, max_pos: int = MAX_ROPE_POSITIONS, base: float = 10000.0,
               device: torch.device | str = "cpu"):
    """Return (cos, sin), each ``[max_pos, head_dim // 2]`` fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base**exponents)
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    angles = torch.outer(t, inv_freq)
    return torch.cos(angles), torch.sin(angles)


@functools.lru_cache(maxsize=8)
def cached_rope_table(head_dim: int, base: float, device: torch.device):
    """:func:`rope_table`, built once a (width, base, device) and shared.  It
    is built as ordinary tensors even inside ``torch.inference_mode`` (a
    generate), so that a training forward later in the process may save it
    for its backward."""
    with torch.inference_mode(False):
        return rope_table(head_dim, base=base, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[B, S, H, D]`` by per-position cos/sin ``[S, D/2]``;
    (x[..., 0], x[..., 1]) is the first complex pair."""
    xf = x.float()
    xr = xf[..., 0::2]
    xi = xf[..., 1::2]
    cos = cos[:, None, :]  # broadcast over heads
    sin = sin[:, None, :]
    out = torch.stack([xr * cos - xi * sin, xi * cos + xr * sin], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def apply_rope_neox(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[B, S, H, D]`` by cos/sin ``[S, D/2]``, pairing dim ``i``
    with dim ``i + D/2`` (mamba_ssm MHA's non-interleaved rotary)."""
    D = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : D // 2], xf[..., D // 2:]
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
