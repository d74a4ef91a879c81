"""LayerNorm and RMSNorm with fp32 statistics, cast back to the input dtype
(counterpart of zonos_tpu/ops/norms.py:16-37).

On a CUDA tensor the row kernel N1 (``kernels/row_norm.py``) normalises,
summing every row in one fixed order, so a row's output does not depend on
how many rows share the call; on the CPU, and for what N1 does not take,
the plain versions run.  A norm whose output only one product reads is
passed to it as a :class:`Norm` (``ops/quant.py`` ``norm_matmul``), which
folds it into the product's kernel where it can.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.kernels import row_norm as n1
from zonos_tpu_torch.kernels.row_norm import Norm, layer_norm_plain, rms_norm_plain


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if x.is_cuda and n1.kernel_takes(x, scale, bias):
        return n1.layer_norm(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """``bias`` (added after scaling) is applied only by the hybrid's final
    norm, an ``nn.LayerNorm`` run in RMS mode by the reference."""
    if x.is_cuda and n1.kernel_takes(x, scale, bias):
        return n1.rms_norm(x, scale, eps, bias)
    return rms_norm_plain(x, scale, eps, bias)


def apply_norm(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    """``norm`` of ``x`` (:func:`layer_norm` or :func:`rms_norm`)."""
    if norm.rms:
        return rms_norm(x, norm.scale, norm.eps, bias=norm.bias)
    return layer_norm(x, norm.scale, norm.bias, norm.eps)
