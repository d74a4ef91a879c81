"""Which operands each hand-written kernel of the port takes, on the CPU.

Every kernel module has a ``kernel_takes`` predicate over dtypes and shapes
alone; its wrapper's check raises exactly where it says no, and the op layer
asks it before a launch, computing anything else with the reference math (as
the JAX package computes any dtype and shape on any backend).  These tests
hold each predicate to the flagship shapes (yes), one shape past each of the
kernel's limits (no) and fp32 where the kernel takes bf16 (no).  The operands
are meta tensors: only their dtypes and shapes exist.  The card-only tests in
``test_torch_port_cuda.py`` check that the call sites then launch nothing and
return the reference result.
"""

from __future__ import annotations

import pytest
import torch

from zonos_tpu_torch.kernels import decode_attention as k12
from zonos_tpu_torch.kernels import gemm as g1
from zonos_tpu_torch.kernels import int4_matmul as k8
from zonos_tpu_torch.kernels import row_norm as n1
from zonos_tpu_torch.kernels import layer_tail as k4
from zonos_tpu_torch.kernels import sampling as k3
from zonos_tpu_torch.kernels import snake_conv as k5
from zonos_tpu_torch.kernels import ssd as k6
from zonos_tpu_torch.kernels import ssm_state as k7

BF, F32, F8, I8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn, torch.int8


def _t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attention(H=16, H_kv=4, D=128, dtype=BF, cache=None, S=2048):
    cache = dtype if cache is None else cache
    return k12.kernel_takes(_t(2, 1, H, D, dtype=dtype), _t(2, H_kv, S, D, dtype=cache),
                            _t(2, H_kv, S, D, dtype=cache))


def _held_out(cache=F8, dtype=BF, scales=None, D=128):
    scales = cache == I8 if scales is None else scales
    s = (_t(2, 4, 2048), _t(2, 4, 2048)) if scales else (None, None)
    return k12.kernel_takes(_t(2, 1, 16, D, dtype=dtype), _t(2, 4, 2048, D, dtype=cache),
                            _t(2, 4, 2048, D, dtype=cache), _t(2, 1, 4, D, dtype=dtype),
                            _t(2, 1, 4, D, dtype=dtype), *s)


def _fold_norm(K, rms=False, bias=(), scale=BF, scale_width=None):
    """A Norm of meta parameters: bf16 scale [K] (or ``scale_width``), bias
    [K] (``bias=None``: none; a shape: that shape)."""
    b = None if bias is None else _t(*(bias or (K,)), dtype=BF)
    return n1.Norm(_t(scale_width or K, dtype=scale), b, 1e-5, rms)


def _g1_fold(M=2, K=2048, N=3072, x=BF, w=BF, s=None, **norm):
    return g1.fold_takes(M, K, N, x, w, s, _fold_norm(K, **norm))


def _k8_fold(M=2, din=2048, dout=16384, x=BF, **norm):
    return k8.fold_takes(M, din, dout, 128, x, I8, BF, _fold_norm(din, **norm))


def _sample(V=1152, dtype=F32):
    return k3.kernel_takes(_t(1, 9, V, dtype=dtype), _t(1, 9, V))


def _tail(B2=2, dk=2048, d=2048, I=8192, dtype=BF):
    return k4.kernel_takes(_t(B2, dk, dtype=dtype), _t(B2, d, dtype=dtype), _t(dk, d, dtype=I8),
                           _t(d, dtype=BF), _t(d, dtype=dtype), _t(d, dtype=dtype),
                           _t(d, 2 * I, dtype=I8), _t(2 * I, dtype=BF), _t(I, d, dtype=I8),
                           _t(d, dtype=BF))


def _snake(C=1536, k=7, dilation=9, dtype=F32):
    return k5.kernel_takes(_t(1, 86 * 8, C, dtype=dtype), _t(C, dtype=dtype),
                           _t(C, C, k, dtype=dtype), _t(C, dtype=dtype), dilation)


def _ssd(P=64, N=128, dtype=F32, L=55):
    return k6.kernel_takes(_t(2, L, 64, P, dtype=dtype), _t(2, L, 64, dtype=dtype),
                           _t(64, dtype=dtype), _t(2, L, 1, N, dtype=dtype),
                           _t(2, L, 1, N, dtype=dtype), _t(64, dtype=dtype))


def _state(N=128, state=F32, dtype=F32, BH=128, P=64):
    return k7.kernel_takes(_t(BH, P, N, dtype=state), _t(BH, N, dtype=dtype),
                           _t(BH, N, dtype=dtype), _t(BH, 1, dtype=dtype), _t(BH, P, dtype=dtype))


def _quant_state(mode="int8", N=128, P=64, BH=128, scales=F32):
    width = N // 2 if mode == "int4" else N
    scale = None if scales is None else _t(BH, dtype=scales)
    return k7.kernel_takes(_t(BH, P, width, dtype=I8), _t(BH, N), _t(BH, N), _t(BH, 1),
                           _t(BH, P), scale)


CASES = {
    # K1/K2 over a bf16 cache: the flagship (16 query heads, 4 kv heads, head_dim 128)
    "K1K2 flagship": (_attention, {}, True),
    "K1K2 one kv head for 8 query heads": (_attention, dict(H=8, H_kv=1), True),
    "K1K2 fp32": (_attention, dict(dtype=F32), False),
    "K1K2 bf16 q, fp32 cache": (_attention, dict(cache=F32), False),
    "K1K2 head_dim 64": (_attention, dict(D=64), False),
    "K1K2 16 query heads a kv head": (_attention, dict(H=16, H_kv=1), False),
    "K1K2 3 query heads a kv head": (_attention, dict(H=12, H_kv=4), False),
    # K1/K2 over a quantized cache, the current row held out
    "K1K2 f8 cache": (_held_out, {}, True),
    "K1K2 int8 cache": (_held_out, dict(cache=I8), True),
    "K1K2 fp32 q over an f8 cache": (_held_out, dict(dtype=F32), False),
    "K1K2 int8 cache without scales": (_held_out, dict(cache=I8, scales=False), False),
    "K1K2 held-out bf16 cache": (_held_out, dict(cache=BF), False),
    "K1K2 f8 cache, head_dim 64": (_held_out, dict(D=64), False),
    # K3
    "K3 flagship": (_sample, {}, True),
    "K3 vocab 12288": (_sample, dict(V=12288), True),
    "K3 vocab 12289": (_sample, dict(V=12289), False),
    "K3 bf16": (_sample, dict(dtype=BF), False),
    # K4: any row count; dk, d, I multiples of 16, none capped
    "K4 flagship B2 2": (_tail, {}, True),
    "K4 B2 128": (_tail, dict(B2=128), True),
    "K4 B2 130 (two row tiles)": (_tail, dict(B2=130), True),
    "K4 I 8208 (past the old 8192 cap)": (_tail, dict(I=8208), True),
    "K4 narrow": (_tail, dict(dk=256, d=256, I=512), True),
    "K4 fp32": (_tail, dict(dtype=F32), False),
    "K4 d 2056": (_tail, dict(d=2056), False),
    "K4 I 8200": (_tail, dict(I=8200), False),
    "K4 dk 2040": (_tail, dict(dk=2040), False),
    # K5: 227 KB of shared memory hold the halo of a dilation up to 87 at k = 7, and of a
    # multiple of 4 up to 304 (one copy of the window)
    "K5 flagship": (_snake, {}, True),
    "K5 dilation 42": (_snake, dict(dilation=42), True),
    "K5 dilation 43": (_snake, dict(dilation=43), True),
    "K5 dilation 87": (_snake, dict(dilation=87), True),
    "K5 dilation 89": (_snake, dict(dilation=89), False),
    "K5 dilation 304": (_snake, dict(dilation=304), True),
    "K5 dilation 308": (_snake, dict(dilation=308), False),
    "K5 C 1538 (not a multiple of 4)": (_snake, dict(C=1538), False),
    "K5 even k": (_snake, dict(k=4, dilation=1), False),
    "K5 bf16": (_snake, dict(dtype=BF), False),
    # K6: headdim <= 64, d_state <= 128 (the flagship sits on both)
    "K6 flagship": (_ssd, {}, True),
    "K6 headdim 128": (_ssd, dict(P=128), False),
    "K6 d_state 256": (_ssd, dict(N=256), False),
    "K6 bf16": (_ssd, dict(dtype=BF), False),
    # K7: a state row of a power-of-two count (at most 32) of 16-byte slices
    "K7 flagship fp32": (_state, {}, True),
    "K7 bf16 state": (_state, dict(state=BF), True),
    "K7 f8 state": (_state, dict(state=F8), True),
    "K7 d_state 24 fp32 (6 slices)": (_state, dict(N=24), False),
    "K7 d_state 256 fp32 (64 slices)": (_state, dict(N=256), False),
    "K7 fp16 state": (_state, dict(state=torch.float16), False),
    "K7 bf16 inputs": (_state, dict(dtype=BF), False),
    # K7 on int8 / int4 states: rows of a power-of-two count (at most 32) of 16 values, at
    # most 16,384 values a head (one CTA holds it), fp32 scales
    "K7 int8 flagship": (_quant_state, {}, True),
    "K7 int4 flagship": (_quant_state, dict(mode="int4"), True),
    "K7 int8 d_state 512": (_quant_state, dict(N=512, P=32), True),
    "K7 int4 d_state 24": (_quant_state, dict(mode="int4", N=24), False),
    "K7 int8 d_state 1024 (64 pieces)": (_quant_state, dict(N=1024, P=16), False),
    "K7 int8 head of 32,768 values": (_quant_state, dict(P=256), False),
    "K7 int8 without scales": (_quant_state, dict(scales=None), False),
    "K7 int8 bf16 scales": (_quant_state, dict(scales=BF), False),
    # K8: at most 64 rows, dout % 16, groups of a multiple of 8 rows, bf16 x
    "K8 flagship w1": (lambda **kw: k8.kernel_takes(2, 2048, 16384, 128, **kw), {}, True),
    "K8 fp32 x": (lambda **kw: k8.kernel_takes(2, 2048, 16384, 128, **kw),
                  dict(x_dtype=F32), False),
    "K8 bf16 scales needed": (lambda **kw: k8.kernel_takes(2, 2048, 16384, 128, **kw),
                              dict(s_dtype=F32), False),
    "K8 65 rows": (lambda **kw: k8.kernel_takes(65, 2048, 2048, 128, **kw), {}, False),
    # G1: bf16 x by a bf16 weight, or an int8 one with bf16 scales; K and N multiples of 16
    "G1 flagship w2": (lambda **kw: g1.kernel_takes(2, 8192, 2048, **kw), {}, True),
    "G1 batch-64 prefill heads": (lambda **kw: g1.kernel_takes(9088, 2048, 10368, **kw), {}, True),
    "G1 int8 wqkv": (lambda **kw: g1.kernel_takes(2, 2048, 3072, BF, I8, BF, **kw), {}, True),
    "G1 hybrid in_proj (8512 columns)": (lambda **kw: g1.kernel_takes(2, 2048, 8512, **kw), {},
                                         True),
    "G1 fp32 model": (lambda **kw: g1.kernel_takes(2, 64, 48, F32, F32, **kw), {}, False),
    "G1 K 72": (lambda **kw: g1.kernel_takes(2, 72, 48, **kw), {}, False),
    "G1 N 40": (lambda **kw: g1.kernel_takes(2, 64, 40, **kw), {}, False),
    "G1 int8 without scales": (lambda **kw: g1.kernel_takes(2, 64, 48, BF, I8, **kw), {}, False),
    "G1 bf16 weight with scales": (lambda **kw: g1.kernel_takes(2, 64, 48, BF, BF, BF, **kw), {},
                                   False),
    # N1: bf16 or fp32 rows of a multiple of 16, bf16 scale and bias
    "N1 flagship LayerNorm": (lambda: n1.kernel_takes(_t(2, 1, 2048, dtype=BF), _t(2048, dtype=BF),
                                                      _t(2048, dtype=BF)), {}, True),
    "N1 hybrid fp32 residual": (lambda: n1.kernel_takes(_t(2, 1, 2048), _t(2048, dtype=BF)), {},
                                True),
    "N1 fp32 model": (lambda: n1.kernel_takes(_t(2, 1, 64), _t(64), _t(64)), {}, False),
    "N1 d 72": (lambda: n1.kernel_takes(_t(2, 72, dtype=BF), _t(72, dtype=BF)), {}, False),
    "N1 fp16 rows": (lambda: n1.kernel_takes(_t(2, 64, dtype=torch.float16), _t(64, dtype=BF)),
                     {}, False),
    "N1 scale of another width": (lambda: n1.kernel_takes(_t(2, 64, dtype=BF), _t(48, dtype=BF)),
                                  {}, False),
    # a norm folded into G1: bf16 x, or fp32 x (the hybrid's residual) up to 16 rows; the
    # norm's bf16 [K] scale and bias (a LayerNorm needs its bias); the rest as G1 takes
    "G1 fold flagship wqkv LayerNorm": (_g1_fold, {}, True),
    "G1 fold int8 wqkv": (_g1_fold, dict(w=I8, s=BF), True),
    "G1 fold hybrid in_proj fp32 residual, 16 rows": (_g1_fold, dict(M=16, N=8512, x=F32,
                                                                     rms=True, bias=None), True),
    "G1 fold hybrid out_proj RMSNorm": (_g1_fold, dict(K=4096, N=2048, rms=True, bias=None),
                                        True),
    "G1 fold batch-64 prefill (bf16)": (_g1_fold, dict(M=9088), True),
    "G1 fold fp32 x, 17 rows": (_g1_fold, dict(M=17, x=F32), False),
    "G1 fold fp16 x": (_g1_fold, dict(x=torch.float16), False),
    "G1 fold fp32 scale": (_g1_fold, dict(scale=F32), False),
    "G1 fold scale of another width": (_g1_fold, dict(scale_width=1024), False),
    "G1 fold LayerNorm without bias": (_g1_fold, dict(bias=None), False),
    "G1 fold K 72": (_g1_fold, dict(K=72), False),
    # a norm folded into K8: up to 16 rows of bf16 or fp32 x, as G1's parameters
    "K8 fold flagship w1": (_k8_fold, {}, True),
    "K8 fold hybrid fp32 residual RMSNorm, 16 rows": (_k8_fold, dict(M=16, x=F32, rms=True,
                                                                     bias=None), True),
    "K8 fold 17 rows": (_k8_fold, dict(M=17), False),
    "K8 fold fp16 x": (_k8_fold, dict(x=torch.float16), False),
    "K8 fold bias of another width": (_k8_fold, dict(bias=(1024,)), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_takes(case):
    fn, kwargs, want = CASES[case]
    assert fn(**kwargs) is want


@pytest.mark.parametrize("K,N,halves", [(2048, 2048, 1), (2048, 8192, 2), (8192, 2048, 1),
                                        (256, 512, 2), (48, 80, 1), (4096, 2048, 1)])
@pytest.mark.parametrize("B2", [1, 2, 8, 128, 130])
def test_layer_tail_split_count_fits_the_kernel(K, N, halves, B2):
    """Every split count the wrapper passes K4 gives splits of whole k-steps
    (16 rows, as the C launcher rounds them), none empty, each at least one
    ring stage where K allows; the default fills at most one wave of 132 SMs
    over the column tiles (a row tile's; more rows add row tiles, never
    change a row's splits), and a tile's partials stay within what its last
    CTA adds."""
    tiles = -(-N // k4.TILE)
    for target in (66, 132, 264):
        n = k4.split_count(K, N, target, halves)
        rows = -(-K // n)
        rows = -(-rows // k4.ALIGN) * k4.ALIGN  # zt_fused_layer_tail's rows per split
        assert (n - 1) * rows < K <= n * rows
        assert rows >= min(K, k4.STAGE_ROWS)
        assert n == 1 or n * tiles <= target
        assert n == 1 or n * min(B2, k4.MAX_ROWS) * k4.TILE * halves * 4 <= k4.MAX_SUM_BYTES
