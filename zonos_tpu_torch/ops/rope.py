"""Rotary position embeddings: interleaved (real, imag) pairs along the head
dim, base-10000 frequencies, fp32 rotation (zonos_tpu/ops/rope.py:17-40)."""

from __future__ import annotations

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
