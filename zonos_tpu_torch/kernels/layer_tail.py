"""K4 fused int8 layer tail (csrc/layer_tail.cu) and its plain version.

Replaces ``fused_layer_tail_pallas`` (zonos_tpu/ops/pallas_decode.py:94): the
part of an int8 transformer decode layer after attention, ``resid + wo-out +
SwiGLU-MLP(LayerNorm(resid + wo-out))``, with int8 ``wo [dk, d]``, ``w1 [d, 2I]``
(up half, then gate half) and ``w2 [I, d]``, each with bf16 per-column scales.

What bounds it on an H100: the int8 weights are read once per call (54.6 MB
at the flagship's width), and each feeds at most ``B2`` FMAs: bytes.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

TILE = 32  # output columns per CTA; d and I must be multiples of it
MAX_K = 8192  # the longest contraction the kernel stages in shared memory
MIN_SPLIT_ROWS = 256  # contraction rows of one split at least (8 per row lane)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_fused_layer_tail": [_P] * 15 + [_I] * 7 + [_F, _P],
}


def row_tile(B2: int) -> int:
    """Rows of the input a CTA takes (the kernel's MT)."""
    return 1 if B2 == 1 else 2 if B2 == 2 else 4 if B2 <= 4 else 8


def split_count(K: int, N: int, B2: int, target_ctas: int) -> int:
    """Contraction splits of a pass: about ``target_ctas`` CTAs over the
    column and row tiles (one per SM measured fastest: ``chip_smoke.py
    --sweep``), each split at least MIN_SPLIT_ROWS rows, none empty."""
    tiles = (N // TILE) * -(-B2 // row_tile(B2))
    n = max(1, min(-(-target_ctas // tiles), K // MIN_SPLIT_ROWS))
    return -(-K // -(-K // n))


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


def _check(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s) -> tuple:
    tensors = (attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s)
    if not all(t.is_cuda and t.device == attn_out.device for t in tensors):
        raise ValueError("every operand of the layer tail must lie on the same CUDA device")
    bf16 = (attn_out, resid, wos, ln_s, ln_b, w1s, w2s)
    if any(t.dtype != torch.bfloat16 for t in bf16) or any(
            w.dtype != torch.int8 for w in (woq, w1q, w2q)):
        raise TypeError("the layer tail takes bf16 activations, norms and scales and int8 "
                        f"weights; got {[t.dtype for t in tensors]}")
    if attn_out.dim() != 2 or resid.dim() != 2 or attn_out.shape[0] != resid.shape[0]:
        raise ValueError(f"bad shapes attn_out {tuple(attn_out.shape)} resid {tuple(resid.shape)}")
    B2, dk = attn_out.shape
    d = resid.shape[1]
    I = w2q.shape[0]
    want = {"woq": (dk, d), "wos": (d,), "ln_s": (d,), "ln_b": (d,), "w1q": (d, 2 * I),
            "w1s": (2 * I,), "w2q": (I, d), "w2s": (d,)}
    for (name, shape), t in zip(want.items(), (woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if d % TILE or I % TILE or max(dk, d, I) > MAX_K:
        raise ValueError(f"d={d} and I={I} must be multiples of {TILE}, "
                         f"and dk, d, I at most {MAX_K}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the layer tail takes contiguous tensors")
    return B2, dk, d, I


def fused_layer_tail(attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s,
                     eps: float = 1e-5, target_ctas: int | None = None) -> torch.Tensor:
    """K4 on CUDA tensors (three launches on the stream: wo, LayerNorm + w1 +
    SwiGLU, w2, each splitting its contraction over CTAs); CPU tensors take the
    plain version.  ``attn_out [B2, dk]``, ``resid [B2, d]`` -> the new
    residual ``[B2, d]`` in bf16.  ``target_ctas`` (default: the device's SM
    count) sets the passes' splits (for a sweep)."""
    args = (attn_out, resid, woq, wos, ln_s, ln_b, w1q, w1s, w2q, w2s)
    if not attn_out.is_cuda:
        return fused_layer_tail_plain(*args, eps=eps)
    B2, dk, d, I = _check(*args)
    dev = attn_out.device
    # (K, N, H) of the wo, w1 and w2 passes; H = 2 sums (up and gate) in the w1 pass
    passes = ((dk, d, 1), (d, I, 2), (I, d, 1))
    target = target_ctas or sm_count(dev.index)
    splits = [split_count(K, N, B2, target) for K, N, _ in passes]
    partial = max(n * H * B2 * N if n > 1 else 0 for n, (_, N, H) in zip(splits, passes))
    n_tiles = (max(d, I) // TILE) * -(-B2 // row_tile(B2))
    x2 = torch.empty((B2, d), dtype=torch.float32, device=dev)
    act = torch.empty((B2, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B2, d), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(max(partial, 1), dtype=torch.float32, device=dev)
    counters = torch.empty(3 * n_tiles, dtype=torch.int32, device=dev)  # one set per pass
    lib = library("layer_tail", _SIGNATURES)
    rc = lib.zt_fused_layer_tail(*(t.data_ptr() for t in args), x2.data_ptr(), act.data_ptr(),
                                 out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
                                 B2, dk, d, I, *splits, float(eps),
                                 torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "fused_layer_tail")
    launch_counts["fused_layer_tail"] += 1
    return out
