"""Quantized weights and low-precision stores, shared by both backbones, the
heads and the SSM state (zonos_tpu/models/backbone.py:46-128).

A matmul weight ``[in, out]`` is a plain matrix, an int8 ``{"q", "s"}`` (one
bf16 scale per output column) or a group-wise int4 ``{"q4", "s4"}`` (two
weights per byte, one bf16 scale per group of input rows and column);
:func:`matmul_w` takes all three.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.kernels import grad_required
from zonos_tpu_torch.kernels.gemm import fold_takes as gemm_fold_takes
from zonos_tpu_torch.kernels.gemm import folds as gemm_folds
from zonos_tpu_torch.kernels.gemm import gemm
from zonos_tpu_torch.kernels.gemm import kernel_takes as gemm_takes
from zonos_tpu_torch.kernels.int4_matmul import MAX_ROWS, int4_matmul, kernel_takes, unpack_int4
from zonos_tpu_torch.kernels.int4_matmul import fold_takes as int4_fold_takes
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.ops.norms import apply_norm

F8_MAX = 448.0  # float8 e4m3 has no infinity: out-of-range values become NaN


def matmul_w(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain matrix, an int8 ``{"q": [in, out], "s": bf16 [out]}``
    or a group-wise int4 ``{"q4": [in/2, out] nibble-packed, "s4": bf16 [G, out]}``
    weight (zonos_tpu/models/backbone.py:46-79).

    On a CUDA tensor every product whose dtypes and widths a kernel takes
    goes to a hand-written one whose summation order the weight's shape
    fixes, so a row's result does not depend on how many rows share the
    call: a bf16 or int8 weight to G1 (``kernels/gemm.py``), an int4 one to
    K8 in chunks of at most 64 rows.  What they do not take (an fp32 model,
    other widths) keeps the library product or JAX's unpack
    (:func:`int4_matmul_unpacked`).  On the CPU this computes what it always
    did."""
    din = x.shape[-1]
    rows = x.numel() // din
    if isinstance(w, dict) and "q4" in w:
        q, s = w["q4"], w["s4"]
        dout, G = q.shape[-1], s.shape[-2]
        if x.is_cuda and kernel_takes(min(rows, MAX_ROWS), din, dout, din // G, x.dtype, q.dtype,
                                      s.dtype):
            return int4_rows(_rows(x, rows), q, s).reshape(*x.shape[:-1], dout).to(x.dtype)
        return int4_matmul_unpacked(x, q, s)
    if isinstance(w, dict) and "q" in w:
        q, s = w["q"], w["s"]
        if x.is_cuda and gemm_takes(rows, din, q.shape[-1], x.dtype, q.dtype, s.dtype):
            return gemm(_rows(x, rows), q, s).reshape(*x.shape[:-1], q.shape[-1])
        return (x @ q.to(x.dtype)) * s.to(x.dtype)
    if x.is_cuda and w.dim() == 2 and gemm_takes(rows, din, w.shape[-1], x.dtype, w.dtype):
        return gemm(_rows(x, rows), w).reshape(*x.shape[:-1], w.shape[-1])
    return x @ w


def norm_matmul(x: torch.Tensor, norm: Norm, w, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``matmul_w(apply_norm(x, norm).to(dtype), w)``: a layer's norm and the
    one product that reads it (``dtype``: the compute dtype, x's by default;
    the hybrid's residual x is fp32).

    On a CUDA tensor whose dtypes and widths the product's kernel takes with
    a norm folded in (G1 ``fold_takes`` for a bf16 or int8 weight where
    ``folds`` says so for this row count and norm, K8 ``fold_takes`` for an
    int4 one), one launch normalises x as it stages it, by N1's code: the
    same bits as the composition, with no launch for the norm.  Otherwise,
    and on the CPU, the composition itself: N1 (or the plain norm), the
    cast, then :func:`matmul_w`.  Under autograd (a training forward, whose
    rows are far more than a fold takes) the composition runs too, N1 and
    G1 each carrying its gradient (:func:`fold_allowed`)."""
    dtype = dtype or x.dtype
    din = x.shape[-1]
    rows = x.numel() // din
    if x.is_cuda and dtype == torch.bfloat16 and rows and fold_allowed(x, norm, w):
        if isinstance(w, dict) and "q4" in w:
            q, s = w["q4"], w["s4"]
            if int4_fold_takes(rows, din, q.shape[-1], din // s.shape[-2], x.dtype, q.dtype,
                               s.dtype, norm):
                y = int4_matmul(_rows(x, rows), q, s, norm=norm)
                return y.reshape(*x.shape[:-1], q.shape[-1]).to(dtype)
        else:
            q, s = (w["q"], w["s"]) if isinstance(w, dict) else (w, None)
            N = q.shape[-1]
            if (q.dim() == 2 and gemm_fold_takes(rows, din, N, x.dtype, q.dtype,
                                                 None if s is None else s.dtype, norm)
                    and gemm_folds(rows, norm)):
                return gemm(_rows(x, rows), q, s, norm=norm).reshape(*x.shape[:-1], N)
    return matmul_w(apply_norm(x, norm).to(dtype), w)


def fold_allowed(x: torch.Tensor, norm: Norm, w) -> bool:
    """Whether :func:`norm_matmul` may fold ``norm`` into the product's
    launch: not under autograd (``grad_required`` of x, the norm's
    parameters or the weight), where the folded launches have no gradient."""
    weights = tuple(w.values()) if isinstance(w, dict) else (w,)
    return not grad_required(x, norm.scale, norm.bias, *weights)


def int4_rows(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K8 over any number of rows ``x [rows, din]``: chunks of at most
    MAX_ROWS rows, each one launch (whose plan does not depend on its rows),
    so every row count takes the same route -> fp32 ``[rows, dout]``."""
    if x.shape[0] <= MAX_ROWS:
        return int4_matmul(x, q, s)
    return torch.cat([int4_matmul(x[i:i + MAX_ROWS], q, s)
                      for i in range(0, x.shape[0], MAX_ROWS)])


def _rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` as contiguous ``[rows, in]`` rows starting on 16 bytes (the
    kernels read 16-byte rows; a view at an odd offset is copied)."""
    xr = x.reshape(rows, x.shape[-1]).contiguous()
    return xr.clone() if xr.data_ptr() % 16 else xr


def int4_matmul_unpacked(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """JAX's unpack of an int4 weight (zonos_tpu/models/backbone.py:68-76): the
    group sums of ``x`` by the unpacked integers, times the scales, in the
    dtype of ``x``."""
    dout, G, din = q.shape[-1], s.shape[-2], x.shape[-1]
    qfull = unpack_int4(q).to(x.dtype)
    xg = x.reshape(*x.shape[:-1], G, din // G)
    y = torch.einsum("...gi,gio->...go", xg, qfull.reshape(G, din // G, dout))
    return (y * s.to(x.dtype)).sum(dim=-2)


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 quantization of ``[.., in, out]``:
    ``w / s`` rounded with the fp32 scale, ``s`` stored in bf16."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale[..., 0, :].to(torch.bfloat16)}


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128) -> dict:
    """Symmetric group-wise int4 quantization of ``[.., in, out]`` on the ±7
    grid, one bf16 scale per ``group_size`` rows and column, packed two per
    byte: rows ``[0, in/2)`` in the low nibble, ``[in/2, in)`` in the high."""
    *lead, din, dout = w.shape
    if din % group_size or group_size % 2:
        raise ValueError(f"in-dim {din} must divide into even group_size {group_size}")
    G = din // group_size
    if (din // 2) % group_size:
        raise ValueError("din/2 must be a multiple of group_size (even group count)")
    wg = w.float().reshape(*lead, G, group_size, dout)
    # times the fp32 reciprocal of 7: the JAX package's division runs under
    # jit, where XLA turns a division by a constant into this product
    scale = (wg.abs().amax(dim=-2, keepdim=True) * (1.0 / 7.0)).clamp_min(1e-8)
    q = torch.round(wg / scale).clamp(-7, 7).to(torch.int8).reshape(*lead, din, dout)
    lo, hi = q[..., : din // 2, :], q[..., din // 2:, :]
    packed = (hi << 4) | (lo & 0xF)
    return {"q4": packed, "s4": scale[..., 0, :].to(torch.bfloat16)}


def store_cast(dst: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` into ``dst`` in its storage dtype, f8 clipped to ±448
    first (an SSM state or a KV cache row; the JAX package clips the SSM
    state, and its KV cast gives NaN past ~464)."""
    if dst.dtype == torch.float8_e4m3fn:
        new = new.clamp(-F8_MAX, F8_MAX)
    dst.copy_(new)
