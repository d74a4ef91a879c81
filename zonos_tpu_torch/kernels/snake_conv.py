"""K5 snake-conv (csrc/snake_conv.cu) and its plain version.

Replaces ``snake_conv1d_pallas`` / ``snake_residual_unit_pallas``
(zonos_tpu/ops/pallas_dac.py:47, :90): ``conv1d(snake(x, alpha), w, b)``
with 'same' padding, NWC activations, fp32.  The residual add of the DAC
residual unit is fused into the second launch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"zt_snake_conv1d": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_SMEM_LIMIT = 48 * 1024
_T_TILE, _CO_TILE, _CI_CHUNK = 64, 64, 16  # compiled into the kernel


def snake_conv1d_plain(x: torch.Tensor, alpha: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int = 1, residual: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, C_in], w [C_out, C_in, k] (k odd) -> [B, T, C_out]."""
    k = w.shape[-1]
    s = torch.sin(alpha * x)
    xs = (x + s * s / (alpha + 1e-9)).transpose(1, 2)
    y = F.conv1d(xs, w, b, padding=(k - 1) * dilation // 2, dilation=dilation).transpose(1, 2)
    return y.contiguous() if residual is None else residual + y


def snake_conv1d(x: torch.Tensor, alpha: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int = 1, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Fused snake + 'same'-padded dilated conv (+ residual); CPU tensors take
    the plain version."""
    if not x.is_cuda:
        return snake_conv1d_plain(x, alpha, w, b, dilation, residual)
    tensors = [x, alpha, w, b] + ([residual] if residual is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("snake_conv1d operands must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("snake_conv1d takes fp32 (the DAC runs in fp32)")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    B, T, C_in = x.shape
    C_out, w_in, k = w.shape
    if w_in != C_in or k % 2 == 0 or alpha.shape != (C_in,) or b.shape != (C_out,):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"alpha {tuple(alpha.shape)} b {tuple(b.shape)}")
    if residual is not None and residual.shape != (B, T, C_out):
        raise ValueError(f"residual {tuple(residual.shape)} != {(B, T, C_out)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("snake_conv1d takes contiguous tensors")
    # the snake'd input window with its halo, and the chunk's k weight slices (fp32)
    smem = ((_T_TILE + (k - 1) * dilation) * _CI_CHUNK + k * _CI_CHUNK * _CO_TILE) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"k={k}, dilation={dilation} needs {smem} B of shared memory")
    # the kernel reads weights as [k, C_in, C_out] so a warp's loads are contiguous
    w_kio = w.permute(2, 1, 0).contiguous()
    y = torch.empty((B, T, C_out), dtype=x.dtype, device=x.device)
    lib = library("snake_conv", _SIGNATURES)
    rc = lib.zt_snake_conv1d(
        x.data_ptr(), alpha.data_ptr(), w_kio.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        B, T, C_in, C_out, k, dilation, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "snake_conv1d")
    launch_counts["snake_conv1d"] += 1
    return y


def snake_residual_unit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """DAC residual unit ``x + conv1x1(snake2(conv_k7_dil(snake1(x))))``: two
    K5 launches on the card, the residual add fused into the second."""
    y = snake_conv1d(x, p["alpha1"], p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    return snake_conv1d(y, p["alpha2"], p["conv2"]["w"], p["conv2"]["b"], dilation=1, residual=x)
