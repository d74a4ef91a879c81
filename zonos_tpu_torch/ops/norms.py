"""LayerNorm and RMSNorm with fp32 statistics, cast back to the input dtype
(counterpart of zonos_tpu/ops/norms.py:16-37)."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """``bias`` (added after scaling) is applied only by the hybrid's final
    norm, an ``nn.LayerNorm`` run in RMS mode by the reference."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
