"""K4 fused int8 layer tail (csrc/layer_tail.cu) and its plain version.

Replaces ``fused_layer_tail_pallas`` (zonos_tpu/ops/pallas_decode.py:94): the
part of an int8 transformer decode layer after attention, ``resid + wo-out +
SwiGLU-MLP(LayerNorm(resid + wo-out))``, with int8 ``wo [dk, d]``, ``w1 [d, 2I]``
(up half, then gate half) and ``w2 [I, d]``, each with bf16 per-column scales.

What bounds it on an H100: reading the int8 weights once a call (54.6 MB at
the flagship's width, ~16.3 us).  Each weight feeds ``2 * B2`` flops, so up to
``B2 = 128`` (7.0 GFLOP, 7.1 us at the bf16 tensor-core peak) bytes bound it.

Design (the source note has the details and a worked example): a counters
memset and four launches on the stream -- wo -> split partial sums; one CTA
per row adds them and the residual -> x2 (fp32) and runs the LayerNorm -> h
(bf16); w1 + SwiGLU -> act (bf16); w2 + x2 -> out -- where each weight pass
runs ``mma.sync`` m16n8k16 on the tensor cores with the dequantized weights as
A (16 columns x 16 k) and up to 128 rows of the activations as B (16 n-tiles
of 8 rows, from ``ldmatrix``), so every weight byte is read and dequantized
once for any ``B2 <= 128``; more rows take further row tiles that reread the
weights.  A k-pair of an A register is two weight rows, joined by one byte
permute, and dequantized exactly in bf16 without conversion instructions;
columns are permuted within a warp so that a lane's fragments are adjacent
bytes of each row.  The weight rows and x stream through a 3-stage cp.async
ring in shared memory (64 KB of weights in flight per SM).  Each pass splits
its contraction over about one wave of CTAs by its widths alone, and the
splits are added in split order (w1, w2: by the last CTA of a tile), so a
row's output does not depend on the batch.  Left for later: ``wgmma`` and TMA,
a thread-block-cluster reduction in place of the partials and the counters'
memset.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

ALIGN = 16  # dk, d and I must be multiples of it (a k-step; a 16-byte copy of columns)
TILE = 128  # columns a CTA takes (w1: 128 up and the matching 128 gate columns)
MAX_ROWS = 128  # rows of the input a CTA takes; more take row tiles that reread the weights
STAGE_ROWS = 128  # weight rows of one ring stage: a split has at least one stage
MAX_SUM_BYTES = 512 * 1024  # split partials the last CTA of a tile adds, at most

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_fused_layer_tail": [_P] * 16 + [_I] * 7 + [_F, _P],
}


def split_count(K: int, N: int, target_ctas: int, halves: int = 1) -> int:
    """Contraction splits of a pass over ``K`` rows into ``N`` columns (per
    half: ``halves`` 2 for w1's up and gate): about ``target_ctas`` CTAs over
    the column tiles (one per SM measured fastest: ``chip_smoke.py
    --sweep``), at least one ring stage each, and no more than the last CTA
    of a tile of MAX_ROWS rows can add up quickly (MAX_SUM_BYTES of fp32
    partials: 8 splits, or 4 for w1).  A split holds ``ceil(K / n)`` rows
    rounded up to 16 (as the kernel computes it), so the count drops splits
    that rounding would leave empty.  The row count never enters: the splits
    fix the order of a row's sums, so a row's output is the same bits alone
    and in any batch (more rows only add row tiles)."""
    tiles = -(-N // TILE)
    sum_cap = MAX_SUM_BYTES // (4 * MAX_ROWS * TILE * halves)
    n = max(1, min(target_ctas // tiles, K // STAGE_ROWS, sum_cap))
    rows = -(-K // n)
    rows = -(-rows // ALIGN) * ALIGN
    return -(-K // rows)


def tail_plan(B2: int, dk: int, d: int, I: int, target_ctas: int) -> dict:
    """K4's launch for ``B2`` rows: the wo, w1 and w2 passes' contraction
    ``splits`` (from the widths and ``target_ctas`` alone: they fix a row's
    sums), and what the row count sizes (its ``row_tiles`` of MAX_ROWS and
    the fp32 ``partial`` floats the passes' splits write)."""
    # (K, N, halves) of the wo, w1 and w2 passes; w1 sums up and gate columns
    passes = ((dk, d, 1), (d, I, 2), (I, d, 1))
    splits = tuple(split_count(K, N, target_ctas, hv) for K, N, hv in passes)
    return {"splits": splits, "row_tiles": -(-B2 // MAX_ROWS),
            "partial": max(n * hv * B2 * N for n, (_, N, hv) in zip(splits, passes))}


def fused_layer_tail_plain(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s,
                           eps: float = 1e-5) -> torch.Tensor:
    """The Pallas body's arithmetic: ``wo`` and ``w2`` dequantized as the bf16
    product ``q * s``; fp32 dot products; ``x2`` fp32; LayerNorm in fp32 with
    ``h`` rounded to bf16; ``w1``'s scales on the fp32 dot; ``u * sigmoid(g) *
    g`` in fp32 rounded to bf16 before ``w2``; the output cast once."""
    bf = torch.bfloat16
    I = w2q.shape[0]
    wo = woq.to(bf) * wos.to(bf)
    x2 = resid.float() + attn_out.to(bf).float() @ wo.float()
    mu = x2.mean(dim=-1, keepdim=True)
    var = (x2 - mu).square().mean(dim=-1, keepdim=True)
    hn = (x2 - mu) * torch.rsqrt(var + eps)
    h = (hn * ln_s.float() + ln_b.float()).to(bf).float()
    u = (h @ w1q[:, :I].to(bf).float()) * w1s[:I].float()
    g = (h @ w1q[:, I:].to(bf).float()) * w1s[I:].float()
    act = (u * torch.sigmoid(g) * g).to(bf)
    w2 = w2q.to(bf) * w2s.to(bf)
    return (x2 + act.float() @ w2.float()).to(attn_out.dtype)


def _refusal(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s):
    """Why the kernel does not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if it does."""
    bf16 = (attn_out, resid, wos, ln_s, ln_b, w1s, w2s)
    if any(t.dtype != torch.bfloat16 for t in bf16) or any(
            w.dtype != torch.int8 for w in (woq, w1q, w2q)):
        return TypeError, ("the layer tail takes bf16 activations, norms and scales and int8 "
                           f"weights; got {[t.dtype for t in bf16 + (woq, w1q, w2q)]}")
    if attn_out.dim() != 2 or resid.dim() != 2 or attn_out.shape[0] != resid.shape[0] \
            or attn_out.shape[0] < 1:
        return ValueError, f"bad shapes attn_out {tuple(attn_out.shape)} resid {tuple(resid.shape)}"
    dk, d, I = attn_out.shape[1], resid.shape[1], w2q.shape[0]
    want = {"woq": (dk, d), "wos": (d,), "ln_s": (d,), "ln_b": (d,), "w1q": (d, 2 * I),
            "w1s": (2 * I,), "w2q": (I, d), "w2s": (d,)}
    for (name, shape), t in zip(want.items(), (woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s)):
        if tuple(t.shape) != shape:
            return ValueError, f"{name} has shape {tuple(t.shape)}, expected {shape}"
    if min(dk, d, I) < ALIGN or dk % ALIGN or d % ALIGN or I % ALIGN:
        return ValueError, f"dk={dk}, d={d} and I={I} must be positive multiples of {ALIGN}"
    return None


def kernel_takes(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s) -> bool:
    """Whether K4 takes these operands, by their dtypes and shapes alone: bf16
    activations, norms and scales, int8 weights of matching shapes, and dk, d
    and I multiples of 16 (any number of rows).  The transformer runs the
    unfused tail where it does not (``models/backbone.py``)."""
    return _refusal(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s) is None


def _check(*args) -> tuple:
    attn_out = args[0]
    if not all(t.is_cuda and t.device == attn_out.device for t in args):
        raise ValueError("every operand of the layer tail must lie on the same CUDA device")
    refusal = _refusal(*args)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the layer tail takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("the layer tail reads every operand from 16-byte boundaries")
    return attn_out.shape[0], attn_out.shape[1], args[1].shape[1], args[8].shape[0]


def fused_layer_tail(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s,
                     eps: float = 1e-5, target_ctas: int | None = None) -> torch.Tensor:
    """K4 on CUDA tensors (a counters memset and four launches on the stream);
    CPU tensors take the plain version.  ``attn_out [B2, dk]``, ``resid [B2,
    d]`` -> the new residual ``[B2, d]`` in bf16.  ``target_ctas`` (default:
    the device's SM count) sets the passes' splits (for a sweep)."""
    args = (attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s)
    if not attn_out.is_cuda:
        return fused_layer_tail_plain(*args, eps=eps)
    B2, dk, d, I = _check(*args)
    dev = attn_out.device
    plan = tail_plan(B2, dk, d, I, target_ctas or sm_count(dev.index))
    splits, partial = plan["splits"], plan["partial"]
    row_tiles, col_tiles = plan["row_tiles"], -(-max(d, I) // TILE)
    x2 = torch.empty((B2, d), dtype=torch.float32, device=dev)
    h = torch.empty((B2, d), dtype=torch.bfloat16, device=dev)
    act = torch.empty((B2, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B2, d), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(partial, dtype=torch.float32, device=dev)
    counters = torch.empty(2 * col_tiles * row_tiles, dtype=torch.int32, device=dev)
    lib = library("layer_tail", _SIGNATURES)
    rc = lib.zt_fused_layer_tail(*(t.data_ptr() for t in args), x2.data_ptr(), h.data_ptr(),
                                 act.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                 counters.data_ptr(), B2, dk, d, I, *splits, float(eps),
                                 torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "fused_layer_tail")
    launch_counts["fused_layer_tail"] += 1
    return out
