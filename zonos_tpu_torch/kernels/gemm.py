"""G1 bf16 / int8-weight product (csrc/gemm.cu) and its plain version.

Replaces no TPU kernel: the JAX package computes ``matmul_w``'s products with
XLA's ``dot`` (zonos_tpu/models/backbone.py:46-79).  On the card a library
product (cuBLAS) picks its kernel and its split of the contraction by the row
count, so a request's rows came out one bf16 ulp apart alone and in a batch,
and a served request's codes changed with its co-batched peers.  G1 computes
``x [M, K] @ w [K, N]`` (bf16 ``w``, or int8 ``q`` times bf16 column scales
``s`` as ``(x @ q) * s``) in an order fixed by ``(K, N)`` and the card's SM
count alone (:func:`split_count`): splits of the contraction added in split
order, each a run of 16-k ``wgmma`` steps in increasing k, rounded to bf16
once.  A row's result is therefore the same bits alone and in any batch.

What bounds it on an H100: at a decode step's few rows, reading the weight
once (``2 K N`` bytes, ``K N`` for int8); at a large prefill, the tensor
cores' bf16 rate.  The source note has the design: TMA stages feeding
``wgmma`` from a warp-specialised producer, the splits of a small-M call
reduced inside a thread-block cluster.

A layer's norm can be folded into the product that reads it (``gemm(...,
norm=)``): the consumers compute each row's statistics and normalise x as
they stage it, by N1's own code (``csrc/row_stats.cuh``), so the result is
the bits of N1 followed by G1 with no launch for the norm.
:func:`folds` says per row count and norm which of the two routes runs.

Under autograd (``grad_required``: a training forward) a bf16 product goes
through :class:`_GemmGrad`: G1 forward, and as backward the plain version's
own gradient, ``dX = dY Wᵀ`` and ``dW = Xᵀ dY`` as library products of the
bf16 values in fp32 (exact products, fp32 sums) rounded once to bf16, the
bits ``torch.autograd`` gives through :func:`gemm_plain`.  An int8 weight or
a folded norm under grad raises: quantized weights are not trained, and
``ops/quant.py`` ``norm_matmul`` runs a norm under grad as N1, then G1.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from zonos_tpu_torch.kernels import grad_required, launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count
from zonos_tpu_torch.kernels.row_norm import DTYPES as NORM_X_DTYPES  # bf16, fp32
from zonos_tpu_torch.kernels.row_norm import Norm, norm_plain, params_aligned

TILE = 128  # columns a CTA owns (the wgmma's N); compiled into the kernel
STAGE_ROWS = 64  # k rows of a ring stage: splits hold a multiple of it
MIN_SPLIT_ROWS = 256  # the fewest contraction rows worth a split of their own
MAX_SPLITS = 8  # the most splits: the CTAs of a cluster, at most the portable 8
ALIGN = 16  # K and N must be multiples of it (a k-step; the tensor maps' 16-byte rows)
WG_ROWS = 64  # rows of a consumer warpgroup (the wgmma's M); a CTA has one or two
WIDE_FROM = 257  # from this many rows every CTA has two consumer warpgroups (128-row tiles)
# Where a norm runs folded into the product (chip_smoke.py fold_table, H100): a LayerNorm (two
# passes over x) up to FOLD_ROWS rows, an RMSNorm (one pass) up to FOLD_RMS_ROWS (a decode step
# at batch 8 with CFG); past that N1 runs first: every CTA of a row tile recomputes its rows'
# statistics over all of K, and at 128 and 142 rows the fold took 1.8-2.5x N1 and G1.
FOLD_ROWS = 8
FOLD_RMS_ROWS = 16
F32_MAX_ROWS = 16  # fp32 x's box shares the x tile (csrc/gemm.cu kF32Rows): at most 16 rows

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "zt_gemm": [_P] * 4 + [_I] * 8 + [_P],
    "zt_gemm_norm": [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 6 + [_P],
    "zt_gemm_prepare": [],
}


@dataclass(frozen=True)
class GemmPlan:
    """How one product runs: ``n_split`` splits of ``rows_per_split``
    contraction rows (what fixes a row's result: from ``(K, N, sms)``
    alone); the rows of a CTA ``bm`` (64 or 128: one or two consumer
    warpgroups) and whether the splits run as the CTAs of a cluster
    (``parallel``), chosen by the row count for speed: they change no bit."""

    n_split: int
    rows_per_split: int
    bm: int
    parallel: bool


def _split_rows(K: int, n: int) -> int:
    """Contraction rows of each of ``n`` splits: ``ceil(K / n)`` rounded up to
    a stage (the last split may hold fewer)."""
    rows = -(-K // n)
    return -(-rows // STAGE_ROWS) * STAGE_ROWS


def split_count(K: int, N: int, sms: int) -> int:
    """Contraction splits of a ``[K, N]`` weight: about one CTA an SM over
    its ``ceil(N / 128)`` column tiles at a decode step's row count, each
    split at least MIN_SPLIT_ROWS rows (rounded up to a stage), at most
    MAX_SPLITS (a cluster's CTAs); the count drops splits the rounding
    leaves empty.  No row count enters: it fixes the summation order."""
    tiles = -(-N // TILE)
    n = max(1, min((sms + tiles // 2) // tiles, K // MIN_SPLIT_ROWS, MAX_SPLITS))
    return -(-K // _split_rows(K, n))


def gemm_plan(M: int, K: int, N: int, sms: int) -> GemmPlan:
    """The launch of ``M`` rows by a ``[K, N]`` weight on a card of ``sms``
    SMs.  The splits come from :func:`split_count`; a CTA has two consumer
    warpgroups (128-row tiles) from WIDE_FROM rows, or where 128-row tiles
    hold the rows as tightly as 64-row ones (an even count of 64-row
    tiles: each weight column tile is then read half as often), else one
    (two such CTAs share an SM); the splits run as a cluster's CTAs while
    the row and column tiles alone leave the card short of one CTA an SM,
    else one after another in each tile's CTA."""
    n = split_count(K, N, sms)
    rows = _split_rows(K, n)
    tiles64 = -(-M // WG_ROWS)
    bm = 2 * WG_ROWS if M >= WIDE_FROM or (tiles64 > 1 and tiles64 % 2 == 0) else WG_ROWS
    tiles = -(-N // TILE) * -(-M // bm)
    return GemmPlan(n, rows, bm, n > 1 and tiles < sms)


def folds(rows: int, norm: Norm) -> bool:
    """Whether ``norm`` in front of a product of ``rows`` rows runs folded
    into G1 (faster there) or as N1 before it; the same bits either way."""
    return rows <= (FOLD_RMS_ROWS if norm.rms else FOLD_ROWS)


def gemm_plain(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w`` with fp32 sums rounded once to x's dtype; for an int8 ``w``,
    that product by the integers, then times the bf16 scales ``s`` in x's
    dtype (zonos_tpu/models/backbone.py:62-66)."""
    y = (x.float() @ w.float()).to(x.dtype)  # bf16 values multiply exactly in fp32
    return y if s is None else y * s.to(x.dtype)


def kernel_takes(rows: int, K: int, N: int, x_dtype=torch.bfloat16, w_dtype=torch.bfloat16,
                 s_dtype=None) -> bool:
    """Whether G1 takes ``rows`` rows of bf16 x by a ``[K, N]`` weight of
    these dtypes: bf16 (no scales) or int8 with bf16 scales, K and N
    multiples of 16.  ``matmul_w`` keeps the library product otherwise (an
    fp32 model, other widths)."""
    weight_ok = (w_dtype == torch.bfloat16 and s_dtype is None) or (
        w_dtype == torch.int8 and s_dtype == torch.bfloat16)
    return (x_dtype == torch.bfloat16 and weight_ok and rows >= 1 and K >= ALIGN and N >= ALIGN
            and K % ALIGN == 0 and N % ALIGN == 0)


def fold_takes(rows: int, K: int, N: int, x_dtype, w_dtype, s_dtype, norm: Norm) -> bool:
    """Whether G1 takes ``norm`` folded in front of the product: x bf16 or
    fp32 (up to F32_MAX_ROWS rows; normalised, then rounded to bf16), the
    norm's bf16 scale ``[K]`` and bias ``[K]`` (a LayerNorm's, or an
    RMSNorm's if any), the rest as :func:`kernel_takes`."""
    scale, bias = norm.scale, norm.bias
    return (x_dtype in NORM_X_DTYPES and (x_dtype == torch.bfloat16 or rows <= F32_MAX_ROWS)
            and kernel_takes(rows, K, N, torch.bfloat16, w_dtype, s_dtype)
            and scale.dtype == torch.bfloat16 and tuple(scale.shape) == (K,)
            and (bias is not None or norm.rms)
            and (bias is None or (bias.dtype == torch.bfloat16 and tuple(bias.shape) == (K,))))


def _check(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None,
           norm: Norm | None = None) -> tuple[int, int, int]:
    params = () if norm is None else tuple(t for t in (norm.scale, norm.bias) if t is not None)
    if not (x.is_cuda and w.device == x.device and (s is None or s.device == x.device)
            and all(t.device == x.device for t in params)):
        raise ValueError("x, w (and s and the norm's parameters) must lie on the same CUDA device")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or (
            s is not None and tuple(s.shape) != (w.shape[1],)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}"
                         f"{'' if s is None else f' s {tuple(s.shape)}'}")
    M, K = x.shape
    N = w.shape[1]
    s_dtype = None if s is None else s.dtype
    if norm is not None and not fold_takes(M, K, N, x.dtype, w.dtype, s_dtype, norm):
        raise (TypeError if x.dtype not in NORM_X_DTYPES else ValueError)(
            f"G1 with a folded norm takes bf16 x or up to {F32_MAX_ROWS} rows of fp32 x, bf16 "
            f"[K] norm parameters (a bias "
            f"for a LayerNorm) and what G1 takes; got x {x.dtype} {tuple(x.shape)}, w "
            f"{w.dtype} {tuple(w.shape)}, scale {norm.scale.dtype} {tuple(norm.scale.shape)}, "
            f"bias {None if norm.bias is None else (norm.bias.dtype, tuple(norm.bias.shape))}")
    if norm is None and not kernel_takes(M, K, N, x.dtype, w.dtype, s_dtype):
        raise (TypeError if x.dtype != torch.bfloat16 or w.dtype not in (torch.bfloat16, torch.int8)
               else ValueError)(
            f"G1 takes bf16 x by a bf16 weight or an int8 one with bf16 scales, K and N "
            f"multiples of {ALIGN}; got x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
            f"{tuple(w.shape)}, s {None if s is None else s.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and (s is None or s.is_contiguous())):
        raise ValueError("G1 takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if s is None else (s,))):
        raise ValueError("G1 reads x, w and s from 16-byte boundaries")
    return M, K, N


_prepared: set[int] = set()


def _library(device_index: int) -> ctypes.CDLL:
    """The library, with every kernel's attributes set on the device: once,
    at the first launch, so never while a CUDA graph is being captured."""
    lib = library("gemm", _SIGNATURES)
    if device_index not in _prepared:
        with torch.cuda.device(device_index):
            check(lib.zt_gemm_prepare(), "gemm_prepare")
        _prepared.add(device_index)
    return lib


def gemm(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None = None,
         plan: GemmPlan | None = None, norm: Norm | None = None) -> torch.Tensor:
    """G1 on CUDA tensors: ``x [M, K]`` bf16 by ``w [K, N]`` (bf16, or int8
    with ``s [N]`` bf16) -> ``[M, N]`` bf16, launched by :func:`gemm_plan`
    (or by ``plan``, which the card's checks use to hold other splits, row
    tiles and cluster sizes against the plain version and each other); CPU
    tensors take the plain version.  With ``norm``, the product of
    ``norm(x)`` rounded to bf16 (x bf16 or fp32), the norm folded into the
    launch (whatever :func:`folds` says: that is the op layer's choice).
    Under autograd (:func:`grad_required`) the product carries its gradient
    (:class:`_GemmGrad`)."""
    norm_params = () if norm is None else (norm.scale, norm.bias)
    if grad_required(x, w, s, *norm_params):
        if s is not None or norm is not None:
            raise ValueError("G1 carries a gradient only for a bf16 weight with no folded norm: "
                             "quantized weights are not trained, and a norm under grad runs "
                             "as N1 before the product")
        return _GemmGrad.apply(x, w, plan)
    return _gemm(x, w, s, plan, norm)


class _GemmGrad(torch.autograd.Function):
    """G1's product with the plain version's gradient (module note)."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        return _gemm(x, w, None, plan, None)

    @staticmethod
    def backward(ctx, dy):
        return (*gemm_backward(*ctx.saved_tensors, dy, ctx.needs_input_grad[:2]), None)


def gemm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                  wanted: tuple[bool, bool] = (True, True)) -> tuple:
    """``(dX, dW)`` of ``y = x @ w`` for the upstream ``dy`` (None where not
    ``wanted``): ``dY Wᵀ`` and ``Xᵀ dY`` by :func:`gemm_plain`, the
    gradient ``torch.autograd`` gives through it."""
    return (gemm_plain(dy, w.t()).to(x.dtype) if wanted[0] else None,
            gemm_plain(x.t(), dy).to(w.dtype) if wanted[1] else None)


def _gemm(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None, plan: GemmPlan | None,
          norm: Norm | None) -> torch.Tensor:
    """The forward product: G1's launch on CUDA tensors, the plain version
    on CPU ones."""
    if not x.is_cuda:
        return gemm_plain(x if norm is None else norm_plain(x, norm).to(torch.bfloat16), w, s)
    M, K, N = _check(x, w, s, norm)
    dev = x.device
    plan = plan or gemm_plan(M, K, N, sm_count(dev.index))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    common = (int(w.dtype == torch.int8), plan.n_split, plan.rows_per_split, int(plan.parallel),
              plan.bm, torch.cuda.current_stream(dev).cuda_stream)
    s_ptr = None if s is None else s.data_ptr()
    if norm is None:
        rc = _library(dev.index).zt_gemm(x.data_ptr(), w.data_ptr(), s_ptr, out.data_ptr(),
                                         M, K, N, *common)
        check(rc, "gemm")
        launch_counts["gemm"] += 1
        return out
    scale, bias = params_aligned(norm.scale), params_aligned(norm.bias)
    rc = _library(dev.index).zt_gemm_norm(
        x.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(), w.data_ptr(),
        s_ptr, out.data_ptr(), M, K, N, int(x.dtype == torch.float32), float(norm.eps),
        int(norm.rms), *common)
    check(rc, "gemm_norm")
    launch_counts["gemm_norm"] += 1
    return out
