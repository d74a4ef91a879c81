"""K8 int4 matmul (csrc/int4_matmul.cu) and its plain version.

Replaces ``int4_matmul_pallas`` (zonos_tpu/ops/pallas_kernels.py:294):
``x [M, din] @ dequant(q [din/2, dout], s [G, dout]) -> fp32 [M, dout]`` for
the few rows of a decode step.  ``q`` holds two 4-bit weights per byte in the
"halves" layout of ``quantize_weight_int4``: rows ``[0, din/2)`` in the low
nibble, rows ``[din/2, din)`` in the high one; ``s`` holds one bf16 scale per
``din / G`` rows and column.

What bounds it on an H100: at M <= 64 each weight feeds at most 64
multiply-adds, far below the card's ridge, so the floor is reading the packed
weights and their scales once (``din * dout / 2 + 2 * G * dout`` bytes) from
HBM.

Design (the source note has the details and a worked example): the kernel
runs ``mma.sync`` m16n8k16 on the tensor cores with the weights as A (16
columns x 16 k) and x as B (8 rows of x per n-tile, up to eight n-tiles
sharing each A fragment), so every packed byte is read and dequantized once
for any M.  k is permuted so that the two nibbles of one packed byte are one
A register's k-pair (rows p and p + din/2), and x is staged in shared memory
as the matching bf16 pairs; columns are permuted within a warp so that a lane
fills its A fragments from one 16-, 8- or 4-byte load per packed row, with
two batches of 128 bytes a lane in flight.  A CTA owns one warp's 128, 64
or 32 columns (by M) and its 8 warps take fixed slices of every 512 packed
rows; the packed rows are split over CTAs up to one wave (by din, dout and
the SM count, never M), and the last CTA of a column tile adds the splits in
split order.  So a row's result is the same bits alone and among up to 63
others, and ``matmul_w`` runs more rows in chunks of 64 through the same
plan.  Left for later: ``wgmma``, TMA, a thread-block-cluster reduction in
place of the partials and the counters' memset, a persistent kernel.

A layer's norm can be folded in (``int4_matmul(..., norm=)``): the CTA
computes its rows' statistics by N1's code (``csrc/row_stats.cuh``) and
normalises x as it stages the pairs, so the result is the bits of N1
followed by K8, with no launch for the norm.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import grad_required, launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count
from zonos_tpu_torch.kernels.row_norm import DTYPES as NORM_X_DTYPES  # bf16, fp32
from zonos_tpu_torch.kernels.row_norm import Norm, norm_plain, params_aligned

MAX_ROWS = 64  # the most rows the kernel takes (a decode step's batch with CFG)
COL_ALIGN = 16  # a lane's columns are all in or all out of dout; rows start on 16 bytes
K_STEP = 8  # packed rows per mma k-step (16 k: each byte's two nibbles); gs % K_STEP == 0
TILE = 128  # columns per CTA at M <= 16 (the split plan's tile); compiled into the kernel
MIN_TILE = 32  # columns per CTA at 33-64 rows: the most column tiles, one counter each
CHUNK_ROWS = 512  # packed rows a CTA stages at once, for every M; compiled into the kernel
SLICES = 8  # warps a CTA splits each chunk's rows over, for every M; compiled into the kernel
MAX_ROWS_PER_SPLIT = 1024  # packed rows of one split; compiled into the kernel
MIN_ROWS_PER_SPLIT = 64  # one k-step for each of up to eight warps over a split's rows
# the most rows a launch takes with a folded norm (past them N1 runs first: every CTA
# recomputes its rows' statistics over all of din)
FOLD_MAX_ROWS = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "zt_int4_matmul": [_P] * 6 + [_I] * 5 + [_P],
    "zt_int4_matmul_norm": [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
}


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-packed ``[..., din/2, dout]`` int8 -> ``[..., din, dout]`` int32
    in [-8, 7]: the sign-extended low nibbles (rows [0, din/2)) above the
    high nibbles (rows [din/2, din))."""
    q32 = q.to(torch.int32)
    lo = ((q32 & 0xF) ^ 0x8) - 0x8
    hi = q32 >> 4  # arithmetic shift of the sign-extended byte
    return torch.cat([lo, hi], dim=-2)


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The Pallas body's arithmetic: the weights are dequantized as a bf16
    product ``q.bf16 * s``, then ``x.bf16 @ w`` with fp32 accumulation."""
    din, dout = x.shape[-1], q.shape[-1]
    G = s.shape[-2]
    w = unpack_int4(q).to(torch.bfloat16).reshape(G, din // G, dout) * s[:, None, :]
    # bf16 values multiply exactly in fp32; only the sums round
    return x.to(torch.bfloat16).float() @ w.reshape(din, dout).float()


def kernel_takes(rows: int, din: int, dout: int, gs: int, x_dtype=torch.bfloat16,
                 q_dtype=torch.int8, s_dtype=torch.bfloat16) -> bool:
    """Whether K8 takes ``rows`` rows of x by a halves-packed ``[din/2, dout]``
    weight in groups of ``gs`` rows, with these dtypes (bf16 x, int8 q, bf16
    s); ``matmul_w`` unpacks what it does not."""
    return (x_dtype == torch.bfloat16 and q_dtype == torch.int8 and s_dtype == torch.bfloat16
            and 1 <= rows <= MAX_ROWS and gs % K_STEP == 0 and din % (2 * gs) == 0
            and dout % COL_ALIGN == 0)


def fold_takes(rows: int, din: int, dout: int, gs: int, x_dtype, q_dtype, s_dtype,
               norm: Norm) -> bool:
    """Whether K8 takes ``norm`` folded in front of the product: up to
    FOLD_MAX_ROWS rows of bf16 or fp32 x (normalised, then rounded to bf16),
    the norm's bf16 scale ``[din]`` and bias ``[din]`` (a LayerNorm's, or an
    RMSNorm's if any), the rest as :func:`kernel_takes`."""
    scale, bias = norm.scale, norm.bias
    return (x_dtype in NORM_X_DTYPES and rows <= FOLD_MAX_ROWS
            and kernel_takes(rows, din, dout, gs, torch.bfloat16, q_dtype, s_dtype)
            and scale.dtype == torch.bfloat16 and tuple(scale.shape) == (din,)
            and (bias is not None or norm.rms)
            and (bias is None or (bias.dtype == torch.bfloat16 and tuple(bias.shape) == (din,))))


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
           norm: Norm | None = None) -> tuple[int, int, int, int]:
    params = () if norm is None else tuple(t for t in (norm.scale, norm.bias) if t is not None)
    if not (x.is_cuda and q.device == x.device and s.device == x.device
            and all(t.device == x.device for t in params)):
        raise ValueError("x, q and s (and the norm's parameters) must lie on the same CUDA device")
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"bad ranks x {tuple(x.shape)} q {tuple(q.shape)} s {tuple(s.shape)}")
    M, din = x.shape
    dout, G = q.shape[1], s.shape[0]
    if din % G or din % (2 * (din // G)) or q.shape[0] * 2 != din or s.shape[1] != dout:
        raise ValueError(f"shapes x {tuple(x.shape)} q {tuple(q.shape)} s {tuple(s.shape)} "
                         "are not a halves-packed [din/2, dout] weight with an even group count")
    if norm is not None and not fold_takes(M, din, dout, din // G, x.dtype, q.dtype, s.dtype,
                                           norm):
        raise (TypeError if x.dtype not in NORM_X_DTYPES else ValueError)(
            f"int4 matmul with a folded norm takes 1..{FOLD_MAX_ROWS} rows of bf16 or fp32 x, "
            f"bf16 [din] norm parameters (a bias for a LayerNorm) and what it takes unfolded; "
            f"got x {x.dtype} {tuple(x.shape)}, scale {norm.scale.dtype} "
            f"{tuple(norm.scale.shape)}, bias "
            f"{None if norm.bias is None else (norm.bias.dtype, tuple(norm.bias.shape))}")
    if norm is None and not kernel_takes(M, din, dout, din // G, x.dtype, q.dtype, s.dtype):
        if (x.dtype, q.dtype, s.dtype) != (torch.bfloat16, torch.int8, torch.bfloat16):
            raise TypeError(f"int4 matmul takes bf16 x, int8 q, bf16 s; "
                            f"got {x.dtype}/{q.dtype}/{s.dtype}")
        raise ValueError(f"int4 matmul takes 1..{MAX_ROWS} rows, dout a multiple of {COL_ALIGN} "
                         f"and groups of a multiple of {K_STEP} rows; got {M} rows, dout {dout}, "
                         f"groups of {din // G}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int4 matmul takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, q, s)):
        raise ValueError("int4 matmul takes x, q and s starting on 16-byte boundaries")
    return M, din, dout, din // G


def split_count(din: int, dout: int, sms: int, n: int | None = None) -> int:
    """Splits of the packed rows: ``n`` if given, else as many as one wave of
    CTAs holds on ``sms`` SMs (one CTA per SM; ``chip_smoke.py --sweep``
    times the alternatives), each split at least MIN_ROWS_PER_SPLIT and at
    most MAX_ROWS_PER_SPLIT packed rows.  A split holds ``ceil(din / 2 / n)``
    rows rounded up to K_STEP (as the kernel computes it), so the count
    drops splits that rounding would leave empty."""
    half = din // 2
    least = -(-half // MAX_ROWS_PER_SPLIT)
    if n is None:
        n = sms // -(-dout // TILE)
    n = max(1, least, min(n, half // MIN_ROWS_PER_SPLIT))
    rows = -(-half // n)
    rows = -(-rows // K_STEP) * K_STEP
    return -(-half // rows)


def int4_plan(M: int, din: int, dout: int, sms: int, n: int | None = None) -> dict:
    """K8's launch for ``M`` rows: the packed rows' ``n_split`` splits of
    ``rows_per_split`` (from din, dout and ``sms`` alone), each staged in
    chunks of CHUNK_ROWS and summed in SLICES warp slices: what fixes a
    row's sums; and the CTA's columns, ``tile`` (128, 64 or 32 as M needs
    more n-tiles), which do not enter them."""
    n_split = split_count(din, dout, sms, n)
    rows = -(-(din // 2) // n_split)
    nt = 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8
    return {"n_split": n_split, "rows_per_split": -(-rows // K_STEP) * K_STEP,
            "chunk_rows": CHUNK_ROWS, "slices": SLICES,
            "tile": 128 if nt <= 2 else 64 if nt == 4 else 32}


def int4_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                n_split: int | None = None, norm: Norm | None = None) -> torch.Tensor:
    """K8 on CUDA tensors; CPU tensors take the plain version.  ``n_split``
    overrides the default split of the packed rows (for a sweep).  With
    ``norm``, the product of ``norm(x)`` rounded to bf16 (x bf16 or fp32),
    the norm folded into the launch.  Quantized weights are not trained: a
    call under autograd (``grad_required``) raises."""
    if grad_required(x, *(() if norm is None else (norm.scale, norm.bias))):
        raise ValueError("K8 carries no gradient: int4 weights are not trained")
    if not x.is_cuda:
        return int4_matmul_plain(x if norm is None else norm_plain(x, norm).to(torch.bfloat16),
                                 q, s)
    M, din, dout, gs = _check(x, q, s, norm)
    n_split = int4_plan(M, din, dout, sm_count(x.device.index), n_split)["n_split"]
    out = torch.empty((M, dout), dtype=torch.float32, device=x.device)
    part = (torch.empty((n_split, M, dout), dtype=torch.float32, device=x.device)
            if n_split > 1 else out)
    counters = torch.empty(-(-dout // MIN_TILE), dtype=torch.int32, device=x.device)
    lib = library("int4_matmul", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if norm is None:
        rc = lib.zt_int4_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                part.data_ptr(), counters.data_ptr(), M, din, dout, gs, n_split,
                                stream)
        check(rc, "int4_matmul")
        launch_counts["int4_matmul"] += 1
        return out
    scale, bias = params_aligned(norm.scale), params_aligned(norm.bias)
    rc = lib.zt_int4_matmul_norm(x.data_ptr(), scale.data_ptr(),
                                 None if bias is None else bias.data_ptr(), q.data_ptr(),
                                 s.data_ptr(), out.data_ptr(), part.data_ptr(),
                                 counters.data_ptr(), M, din, dout, gs, n_split,
                                 int(x.dtype == torch.float32), float(norm.eps), int(norm.rms),
                                 stream)
    check(rc, "int4_matmul_norm")
    launch_counts["int4_matmul_norm"] += 1
    return out
