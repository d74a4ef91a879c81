"""N1 row LayerNorm / RMSNorm (csrc/row_norm.cu) and its plain versions.

Replaces no TPU kernel: the JAX package normalises with XLA's reductions
(zonos_tpu/ops/norms.py:16-37).  PyTorch's reduction on the card shapes its
blocks by the number of rows, so a row's statistics were summed in another
order alone than in a batch.  N1 sums every row the same way (one warp a
row, the order of ``csrc/row_stats.cuh``), so a row's output is the same
bits alone and in any batch.  Bound by reading and writing each row once.
G1 and K8 run the same header when a norm is folded into them
(:class:`Norm`), so a folded norm gives N1's bits.

Under autograd (``grad_required``: a training forward) N1 runs as the
forward of :class:`_NormGrad`, whose backward recomputes the plain version on
the saved input and differentiates it: the gradients of x, the scale and the
bias are the bits ``torch.autograd`` gives through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from zonos_tpu_torch.kernels import grad_required, launch_counts
from zonos_tpu_torch.kernels._build import check, library

ALIGN = 16  # d must be a multiple of it, as the products' widths (the kernel needs 8)
DTYPES = (torch.bfloat16, torch.float32)  # of x

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_row_norm": [_P] * 4 + [_I] * 3 + [_F, _I, _P],
}


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """fp32 mean and (two-pass) variance, cast back to x's dtype
    (zonos_tpu/ops/norms.py:16-26)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 mean of squares, ``x * rsqrt(ms + eps) * scale (+ bias)``, cast
    back to x's dtype (zonos_tpu/ops/norms.py:29-37)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class Norm(NamedTuple):
    """A row norm over the last axis as an operand of the product that reads
    its output: LayerNorm (``rms`` False; ``bias`` required) or RMSNorm
    (``bias`` added after scaling, or None), bf16 ``scale`` / ``bias``
    ``[d]`` on the bf16 models, fp32 statistics."""

    scale: torch.Tensor
    bias: torch.Tensor | None
    eps: float
    rms: bool


def norm_plain(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    """``norm`` of ``x`` by the plain versions, in x's dtype."""
    if norm.rms:
        return rms_norm_plain(x, norm.scale, norm.eps, norm.bias)
    return layer_norm_plain(x, norm.scale, norm.bias, norm.eps)


def params_aligned(t: torch.Tensor | None) -> torch.Tensor | None:
    """A bf16 norm parameter contiguous from a 16-byte boundary, as the
    kernels read it (8 values a load); a copy where it is not."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def kernel_takes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None) -> bool:
    """Whether N1 takes these operands, by dtype and shape alone: bf16 or
    fp32 x (the hybrid's residual stream is fp32) of width d, a multiple of
    16, and bf16 scale (and bias) ``[d]``, as the bf16 models hold them.  An
    fp32 model's norms run the plain version, on the card as on the CPU."""
    d = x.shape[-1] if x.dim() else 0
    return (x.dtype in DTYPES and scale.dtype == torch.bfloat16
            and (bias is None or bias.dtype == torch.bfloat16)
            and d >= ALIGN and d % ALIGN == 0 and tuple(scale.shape) == (d,)
            and (bias is None or tuple(bias.shape) == (d,)))


def _check(x, scale, bias) -> None:
    tensors = (x, scale) + (() if bias is None else (bias,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("x, scale (and bias) must lie on the same CUDA device")
    if not kernel_takes(x, scale, bias):
        raise (TypeError if x.dtype not in DTYPES or scale.dtype != torch.bfloat16 else ValueError)(
            f"the row norm takes bf16 or fp32 x of a width that is a multiple of {ALIGN} and "
            f"bf16 [d] parameters; got x {x.dtype} {tuple(x.shape)}, scale "
            f"{scale.dtype} {tuple(scale.shape)}, bias "
            f"{None if bias is None else (bias.dtype, tuple(bias.shape))}")


def _launch(x, scale, bias, eps: float, rms: bool) -> torch.Tensor:
    _check(x, scale, bias)
    d = x.shape[-1]
    xr = x.reshape(-1, d).contiguous()
    if xr.data_ptr() % 16:
        xr = xr.clone()
    scale, bias = params_aligned(scale), params_aligned(bias)
    y = torch.empty_like(xr)
    if xr.shape[0]:
        lib = library("row_norm", _SIGNATURES)
        rc = lib.zt_row_norm(xr.data_ptr(), scale.data_ptr(),
                             None if bias is None else bias.data_ptr(), y.data_ptr(),
                             xr.shape[0], d, int(x.dtype == torch.float32), float(eps), int(rms),
                             torch.cuda.current_stream(x.device).cuda_stream)
        check(rc, "row_norm")
        launch_counts["row_norm"] += 1
    return y.reshape(x.shape)


class _NormGrad(torch.autograd.Function):
    """N1 forward; the plain version's gradient (module note)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, rms):
        ctx.save_for_backward(x, scale, bias)
        ctx.norm = (eps, rms)
        return _norm(x, scale, bias, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        return (*norm_backward(*ctx.saved_tensors, *ctx.norm, dy, ctx.needs_input_grad[:3]),
                None, None)


def norm_backward(x, scale, bias, eps: float, rms: bool, dy: torch.Tensor,
                  wanted: tuple[bool, bool, bool] = (True, True, True)) -> tuple:
    """The gradients of x, the scale and the bias (None where not ``wanted``)
    for the upstream ``dy``: the plain version recomputed on ``x`` and
    differentiated."""
    with torch.enable_grad():
        x, scale, bias = (None if t is None else t.detach().requires_grad_(need)
                          for t, need in zip((x, scale, bias), wanted))
        y = norm_plain(x, Norm(scale, bias, eps, rms))
        grads = iter(torch.autograd.grad(
            y, [t for t, need in zip((x, scale, bias), wanted) if need], dy))
    return tuple(next(grads) if need else None for need in wanted)


def _norm(x, scale, bias, eps: float, rms: bool) -> torch.Tensor:
    """N1's launch on CUDA tensors, the plain version on CPU ones."""
    if not x.is_cuda:
        return norm_plain(x, Norm(scale, bias, eps, rms))
    return _launch(x, scale, bias, eps, rms)


def _route(x, scale, bias, eps: float, rms: bool) -> torch.Tensor:
    if grad_required(x, scale, bias):
        return _NormGrad.apply(x, scale, bias, eps, rms)
    return _norm(x, scale, bias, eps, rms)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """N1's LayerNorm on CUDA tensors; CPU tensors take the plain version.
    Under autograd it carries its gradient (:class:`_NormGrad`)."""
    return _route(x, scale, bias, eps, rms=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """N1's RMSNorm on CUDA tensors; CPU tensors take the plain version.
    Under autograd it carries its gradient (:class:`_NormGrad`)."""
    return _route(x, scale, bias, eps, rms=True)
