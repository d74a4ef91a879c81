"""DAC building blocks: snake activation and 1-D (transposed) convolutions.

Activations keep the JAX package's ``[batch, time, channels]`` (NWC) layout
at every public function (zonos_tpu/models/dac/layers.py).  Weights are in
torch's layouts: conv ``[C_out, C_in, K]``, transposed conv
``[C_in, C_out, K]`` (torch's transposed conv has the kernel flip built in;
the JAX version flips at call time).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin²(αx)/(α + 1e-9), per-channel alpha.  x [.., C]; alpha [C]."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int = 1,
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """torch Conv1d on NWC activations: x [B, T, C_in], w [C_out, C_in, K]."""
    y = F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding, dilation=dilation)
    return y.transpose(1, 2).contiguous()


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int,
                     padding: int) -> torch.Tensor:
    """torch ConvTranspose1d on NWC activations: x [B, T, C_in],
    w [C_in, C_out, K]; out_len = (T-1)*stride - 2*padding + K."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding)
    return y.transpose(1, 2).contiguous()
