"""The port's quantized serving (int8 and int4 weights, f8 and int8 KV caches)
against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both sides.  Covered: the
weight quantizers (bit-equal), ``matmul_w`` for plain, int8 and int4 weights,
the plain versions of K8 (int4 matmul) and K4 (fused int8 layer tail)
against the Pallas kernels run with ``interpret=True``, the KV row quantizer,
the held-out split decode attention over f8 and int8 caches, ``convert`` of
quantized weights, and greedy ``generate`` with codes identical to JAX's on
the tiny transformer (int8 weights with bf16, int8 and f8 KV caches; int4
weights) and on the tiny hybrid (int8 weights).

The JAX package stores a quantized KV cache only for a bf16 model
(``KVCache.create`` checks the dtype); the parity runs are fp32, so the tests
set the storage mode with ``monkeypatch.setenv`` and pass bf16 to JAX's own
``KVCache.create`` for the cache alone.

Tolerances: quantizers and the KV row quantizer bit-equal; bf16 outputs 2
bf16 ulps of max|ref| (other summation orders can move a rounding by one
ulp, and a bf16 operand by one more); fp32 outputs 1e-5 x max|ref| (the same
products, other summation orders); K4 against the unfused JAX tail 0.02 x
max|ref|, the JAX kernel test's bound; codes exactly.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models import backbone as jbb
from zonos_tpu.models import tts as jtts
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.attention import decode_attention_split
from zonos_tpu.ops.norms import layer_norm as jax_layer_norm
from zonos_tpu.ops.pallas_decode import fused_layer_tail_pallas
from zonos_tpu.ops.pallas_kernels import int4_matmul_pallas
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params, to_tensor
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels.decode_attention import decode_attention_split_plain
from zonos_tpu_torch.kernels.int4_matmul import (
    MAX_ROWS_PER_SPLIT,
    MIN_ROWS_PER_SPLIT,
    int4_matmul,
    int4_matmul_plain,
    kernel_takes,
    split_count,
)
from zonos_tpu_torch.kernels.int4_matmul import TILE as K8_TILE
from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail, fused_layer_tail_plain
from zonos_tpu_torch.models import backbone as tbb
from zonos_tpu_torch.ops import quant as tq
from zonos_tpu_torch.ops.sampling import SamplingParams

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["Hello world.", "Good morning, how are you?"]
MAX_NEW = 12
KV_ENV = {"f8": "ZONOS_TPU_KV_F8", "int8": "ZONOS_TPU_KV_INT8"}
TINY_TRANSFORMER = {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                    "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
TINY_HYBRID = {"d_model": 64, "n_layer": 3, "attn_layer_idx": [1], "attn_mlp_d_intermediate": 128,
               "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16,
                           "d_conv": 4, "ngroups": 1},
               "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                            "rotary_emb_dim": 8}}


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as numpy, floating types widened to fp32."""
    return (t.float() if t.is_floating_point() else t).numpy()


def _bf16(rng, shape, scale=1.0):
    """bf16 values from numpy, as (JAX array, torch tensor)."""
    a = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return a, to_tensor(np.asarray(a))


def _ulps(ref: np.ndarray, n: int = 2) -> float:
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _dict(base: dict, tiny: dict) -> dict:
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(tiny))
    return d


# ---------------------------------------------------------------------------
# weight quantization and matmul_w
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_int8_bit_equal(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = jbb.quantize_weight_int8(jnp.asarray(w))
    ours = tq.quantize_weight_int8(torch.from_numpy(w))
    assert ours["q"].dtype == torch.int8 and ours["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(_np(ours["s"]), np.asarray(ref["s"], np.float32))


@pytest.mark.parametrize("shape,group_size", [((256, 96), 64), ((2, 128, 48), 32)])
def test_quantize_int4_bit_equal(shape, group_size):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    w[..., 7, :] *= 30.0  # an outlier row in one group
    ref = jbb.quantize_weight_int4(jnp.asarray(w), group_size)
    ours = tq.quantize_weight_int4(torch.from_numpy(w), group_size)
    assert ours["q4"].dtype == torch.int8 and tuple(ours["q4"].shape) == ref["q4"].shape
    np.testing.assert_array_equal(ours["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(_np(ours["s4"]), np.asarray(ref["s4"], np.float32))


@pytest.mark.parametrize("din,group_size", [(100, 32), (96, 32)])
def test_quantize_int4_refuses_like_jax(din, group_size):
    w = np.zeros((din, 16), np.float32)
    with pytest.raises(ValueError):
        jbb.quantize_weight_int4(jnp.asarray(w), group_size)
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.from_numpy(w), group_size)


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_matmul_w_matches_jax(kind):
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng, (3, 5, 128))
    jw, tw = _bf16(rng, (128, 96), 128 ** -0.5)
    if kind == "int8":
        jw, tw = jbb.quantize_weight_int8(jw), tq.quantize_weight_int8(tw)
    elif kind == "int4":
        jw, tw = jbb.quantize_weight_int4(jw, 32), tq.quantize_weight_int4(tw, 32)
    ref = np.asarray(jbb.matmul_w(jx, jw), np.float32)
    ours = tq.matmul_w(tx, tw)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape
    assert np.abs(_np(ours) - ref).max() <= _ulps(ref)


# ---------------------------------------------------------------------------
# K8 and K4 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2, 64])
@pytest.mark.parametrize("group_size", [32, 128])
def test_int4_matmul_plain_matches_pallas(M, group_size):
    rng = np.random.default_rng(M + group_size)
    jx, tx = _bf16(rng, (M, 256))
    w = jnp.asarray(rng.normal(size=(256, 384)) / 16, jnp.float32)
    jw = jbb.quantize_weight_int4(w, group_size)
    q, s = to_tensor(np.asarray(jw["q4"])), to_tensor(np.asarray(jw["s4"]))
    ref = np.asarray(int4_matmul_pallas(jx, jw["q4"], jw["s4"], interpret=True))
    before = launch_counts["int4_matmul"]
    ours = int4_matmul(tx, q, s)  # a CPU tensor: the plain version
    assert launch_counts["int4_matmul"] == before
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (M, 384)
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(ours, int4_matmul_plain(tx, q, s))


@pytest.mark.parametrize("din,dout", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
                                      (2048, 10368), (2048, 8512), (4096, 2048), (256, 384)])
def test_int4_split_count_fits_the_kernel(din, dout):
    """Every split count the wrapper passes K8 gives splits of whole k-steps
    (8 packed rows, as the C launcher rounds them), none empty and none over
    the kernel's limit; the default fills at most one wave of 132 SMs unless
    the limit needs more splits."""
    half, tiles = din // 2, -(-dout // K8_TILE)
    least = -(-half // MAX_ROWS_PER_SPLIT)
    for n in (None, 1, 3, 5, 7, 64, 1000):
        splits = split_count(din, dout, 132, n)
        rows = -(-(-(-half // splits)) // 8) * 8  # zt_int4_matmul's rows per split
        assert rows <= MAX_ROWS_PER_SPLIT and (splits - 1) * rows < half <= splits * rows
        assert rows >= min(half, MIN_ROWS_PER_SPLIT)
        if n is None:
            assert splits == least or splits * tiles <= 132


def test_int4_kernel_takes_the_shapes_jax_sends_its_kernel():
    assert kernel_takes(64, 2048, 16384, 128) and kernel_takes(1, 256, 8512, 32)
    assert not kernel_takes(65, 2048, 2048, 128)  # a prefill: unpacked
    assert not kernel_takes(2, 256, 24, 32)  # dout % 16
    assert not kernel_takes(2, 256, 256, 4)  # groups not whole k-steps


def _tail_inputs(d, dk, inter, seed):
    rng = np.random.default_rng(seed)
    jattn, tattn = _bf16(rng, (2, dk), 0.1)
    jres, tres = _bf16(rng, (2, d))
    jw = {name: jbb.quantize_weight_int8(jnp.asarray(rng.normal(size=shape) * 0.05, jnp.float32))
          for name, shape in (("wo", (dk, d)), ("w1", (d, 2 * inter)), ("w2", (inter, d)))}
    jln_s = jnp.asarray(rng.normal(size=(d,)) * 0.2 + 1.0, jnp.bfloat16)
    jln_b = jnp.asarray(rng.normal(size=(d,)) * 0.1, jnp.bfloat16)
    tw = {n: {k: to_tensor(np.asarray(v)) for k, v in w.items()} for n, w in jw.items()}
    jargs = (jattn, jres, jw["wo"]["q"], jw["wo"]["s"], jln_s, jln_b, jw["w1"]["q"],
             jw["w1"]["s"], jw["w2"]["q"], jw["w2"]["s"])
    targs = tuple(to_tensor(np.asarray(a)) for a in jargs)
    return jargs, targs, jw


@pytest.mark.parametrize("dims", [(256, 256, 1024), (256, 512, 512)])
def test_layer_tail_plain_matches_pallas_and_unfused_jax(dims):
    d, dk, inter = dims
    jargs, targs, jw = _tail_inputs(d, dk, inter, d + dk)
    ref = np.asarray(fused_layer_tail_pallas(*jargs, eps=1e-5, two=128, tu=128, interpret=True),
                     np.float32)
    before = launch_counts["fused_layer_tail"]
    ours = fused_layer_tail(*targs, eps=1e-5)  # CPU tensors: the plain version
    assert launch_counts["fused_layer_tail"] == before
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (2, d)
    assert np.abs(_np(ours) - ref).max() <= _ulps(ref)
    # the unfused tail (zonos_tpu/models/backbone.py:302-306)
    attn, resid, ln_s, ln_b = jargs[0], jargs[1], jargs[4], jargs[5]
    x = resid + jbb.matmul_w(attn, jw["wo"]).astype(resid.dtype)
    u, gate = jnp.split(jbb.matmul_w(jax_layer_norm(x, ln_s, ln_b, 1e-5), jw["w1"]), 2, axis=-1)
    unfused = np.asarray(x + jbb.matmul_w(u * jax.nn.silu(gate), jw["w2"]).astype(x.dtype),
                         np.float32)
    assert np.abs(_np(fused_layer_tail_plain(*targs)) - unfused).max() <= \
        0.02 * np.abs(unfused).max()


# A numpy model of K4's lane maps (csrc/layer_tail.cu): which weight bytes a lane
# loads, how one byte permute and two masks make an A register's exact bf16 pair,
# which words of x are its B registers, and which output each accumulator is.
# The A and B fragments are assembled into mma.m16n8k16's 16 x 16 and 16 x 8
# tiles by PTX's fragment layout, multiplied, and the product dealt back out by
# the accumulator layout, so the model holds the kernel's maps to the layout
# the tensor cores use.

def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm (selector nibbles 0-7) on uint32 arrays."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_halves(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A uint32 array of bf16 pairs -> (low half, high half) as fp32."""
    lo = ((bits & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (bits & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


def _bf16_round(v: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (nearest, ties to even) -> fp32, for finite values."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _int8_pair(lo_row: np.ndarray, hi_row: np.ndarray, b: int) -> tuple[np.ndarray, np.ndarray]:
    """int8_pair of layer_tail.cu: byte b of two rows' words -> the exact values."""
    p = _byte_perm(lo_row, hi_row, b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12))
    mag = _bf16_halves((p & 0x007F007F) | 0x43004300)
    base = _bf16_halves((p & 0x00800080) | 0x43004300)
    return mag[0] - base[0], mag[1] - base[1]  # a bf16x2 subtract; exact


def _ldmatrix_b(xp: np.ndarray, nt: int, k0: int):
    """ldmatrix.x4 as layer_tail.cu issues it for n-tiles nt, nt + 1 at k-step k0: lane l
    addresses row l % 8 of n-tile nt + l // 16 at k0 + 8 * ((l // 8) % 2); lane t receives
    row t // 4, columns 2 (t % 4) and 2 (t % 4) + 1 of matrix i in register i.  Returns
    [n-tile][b0, b1][low, high half] arrays over the 32 lanes."""
    lane = np.arange(32)
    rows = np.zeros((4, 8, 8), np.float32)  # the four 8 x 8 matrices
    for lt in range(32):
        n = nt * 8 + (lt // 16) * 8 + lt % 8
        k = k0 + ((lt // 8) % 2) * 8
        rows[lt // 8, lt % 8] = xp[n, k:k + 8] if n < xp.shape[0] else 0
    regs = [(rows[i, lane // 4, 2 * (lane % 4)], rows[i, lane // 4, 2 * (lane % 4) + 1])
            for i in range(4)]
    return [[regs[0], regs[1]], [regs[2], regs[3]]]


def _lane_model_pass(q: np.ndarray, s, x: np.ndarray, N: int, halves: int) -> np.ndarray:
    """One weight pass as the kernel's lanes compute it: int8 ``q [K, halves * N]``,
    bf16-valued scales ``s [N]`` multiplied into the weights (wo, w2) or None
    (w1), bf16-valued ``x [B2, K]`` -> the fp32 sums ``[halves, B2, N]``."""
    K, B2 = q.shape[0], x.shape[0]
    NT = -(-B2 // 8)
    xp = np.zeros((NT * 8, K), np.float32)
    xp[:B2] = x
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    out = np.full((halves, B2, N), np.nan, np.float32)
    for col0 in range(0, N, 128):  # a CTA's columns
        for warp in range(8):
            lcol = col0 + warp * 16 + 2 * gid  # the lane's two columns
            for h in range(halves):
                acc = np.zeros((NT, 32, 4), np.float64)
                for k0 in range(0, K, 16):
                    def word(off):  # the lane's two bytes of weight row k0 + 2 tig + off
                        w = np.zeros(32, np.uint32)
                        for bb in range(2):
                            c = lcol + bb
                            cc = h * N + np.minimum(c, N - 1)
                            v = np.where(c < N, q[k0 + 2 * tig + off, cc], 0)
                            w |= (v.astype(np.uint8).astype(np.uint32)) << (8 * bb)
                        return w

                    w = [word(0), word(1), word(8), word(9)]
                    regs = []
                    for e in range(4):
                        b, r = e & 1, 2 * (e >> 1)
                        lo, hi = _int8_pair(w[r], w[r + 1], b)
                        if s is not None:  # the bf16x2 multiply by the column's scale
                            sc = s[np.minimum(lcol + b, N - 1)]
                            lo, hi = _bf16_round(lo * sc), _bf16_round(hi * sc)
                        regs.append((lo, hi))
                    A = np.zeros((16, 16), np.float64)  # mma's A: row = column, col = k
                    for e, (r_off, k_off) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        A[gid + r_off, 2 * tig + k_off] = regs[e][0]
                        A[gid + r_off, 2 * tig + k_off + 1] = regs[e][1]
                    for nt in range(NT):
                        b = _ldmatrix_b(xp, nt - nt % 2, k0)[nt % 2]  # [reg, half, lane]
                        B = np.zeros((16, 8), np.float64)  # mma's B: row = k, col = n
                        for r, k_off in ((0, 0), (1, 8)):
                            B[2 * tig + k_off, gid] = b[r][0]
                            B[2 * tig + k_off + 1, gid] = b[r][1]
                        D = A @ B
                        for e in range(4):  # c0..c3 = D[gid (+8)][2 tig (+1)]
                            acc[nt, :, e] += D[gid + 8 * (e >> 1), 2 * tig + (e & 1)]
                for nt in range(NT):
                    for e in range(4):  # the epilogue's map
                        rows = nt * 8 + 2 * tig + (e & 1)
                        cols = lcol + (e >> 1)
                        ok = (rows < B2) & (cols < N)
                        out[h, rows[ok], cols[ok]] = acc[nt, ok, e]
    assert not np.isnan(out).any(), "an output no lane wrote"
    return out


def test_layer_tail_int8_pair_is_exact():
    """The byte permute, two masks and a bf16 subtract give every int8 value
    exactly, in either half and from any byte of the words."""
    v = np.arange(-128, 128, dtype=np.int64)
    words = np.zeros(256, np.uint32)
    for b in range(4):
        words |= (np.roll(v, 37 * b).astype(np.uint8).astype(np.uint32)) << (8 * b)
    other = np.roll(words, 101)
    def byte_values(w, b):
        return ((w >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.float32)

    for b in range(4):
        lo, hi = _int8_pair(words, other, b)
        assert np.array_equal(lo, byte_values(words, b))
        assert np.array_equal(hi, byte_values(other, b))
        assert set(lo.tolist()) == set(range(-128, 128))


@pytest.mark.parametrize("B2", [1, 2, 9, 13])
def test_layer_tail_lane_maps_match_plain(B2):
    """The whole tail through the lane model (the LayerNorm and epilogues as
    the kernel computes them) agrees with ``fused_layer_tail_plain`` within
    K4's card tolerance, 1e-2 x max|ref|.  Widths are not multiples of a
    CTA's 128 columns (d 48, I 80), so the masks of the last tile count too;
    B2 covers one and two n-tiles."""
    dk, d, I = 32, 48, 80
    rng = np.random.default_rng(B2)
    bf = torch.bfloat16
    attn = torch.tensor(rng.normal(size=(B2, dk)), dtype=bf)
    resid = torch.tensor(rng.normal(size=(B2, d)), dtype=bf)
    ws = {n: tq.quantize_weight_int8(torch.tensor(rng.normal(size=shape) / shape[0] ** 0.5,
                                                  dtype=torch.float32))
          for n, shape in (("wo", (dk, d)), ("w1", (d, 2 * I)), ("w2", (I, d)))}
    ln_s = torch.tensor(1 + 0.1 * rng.normal(size=d), dtype=bf)
    ln_b = torch.tensor(0.1 * rng.normal(size=d), dtype=bf)
    ref = fused_layer_tail_plain(attn, resid, ws["wo"]["q"], ws["wo"]["s"], ln_s, ln_b,
                                 ws["w1"]["q"], ws["w1"]["s"], ws["w2"]["q"], ws["w2"]["s"]).float()

    def f(t):
        return t.float().numpy()

    x2 = f(resid) + _lane_model_pass(ws["wo"]["q"].numpy(), f(ws["wo"]["s"]), f(attn), d, 1)[0]
    mu = x2.mean(-1, keepdims=True)
    rstd = 1 / np.sqrt(((x2 - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    h = _bf16_round((x2 - mu) * rstd * f(ln_s) + f(ln_b))
    up, gate = _lane_model_pass(ws["w1"]["q"].numpy(), None, h, I, 2)
    u, g = up * f(ws["w1"]["s"])[:I], gate * f(ws["w1"]["s"])[I:]
    act = _bf16_round(u / (1 + np.exp(-g)) * g)
    got = x2 + _lane_model_pass(ws["w2"]["q"].numpy(), f(ws["w2"]["s"]), act, d, 1)[0]
    assert np.abs(_bf16_round(got) - ref.numpy()).max() <= 1e-2 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# quantized KV caches
# ---------------------------------------------------------------------------


def test_quantize_kv_rows_bit_equal():
    rows = np.random.default_rng(4).normal(size=(2, 3, 5, 16)).astype(np.float32) * 3
    rows[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    qj, sj = jbb.quantize_kv_rows(jnp.asarray(rows))
    qt, st = tbb.quantize_kv_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("storage", ["f8", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 9])
def test_split_attention_matches_jax(storage, dtype, pos):
    rng = np.random.default_rng(5)
    B, H, Hkv, S, D = 2, 8, 2, 16, 32
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k_new, v_new = (jnp.asarray(rng.normal(size=shape), jdt)
                       for shape in ((B, 1, H, D), (B, 1, Hkv, D), (B, 1, Hkv, D)))
    rows = [jnp.asarray(rng.normal(size=(B, Hkv, S, D)) * 2, jdt) for _ in range(2)]
    if storage == "int8":
        (kc, ks), (vc, vs) = (jbb.quantize_kv_rows(r) for r in rows)
    else:
        (kc, vc), ks, vs = (r.astype(jnp.float8_e4m3fn) for r in rows), None, None
    ref = np.asarray(decode_attention_split(q, kc, vc, k_new, v_new, jnp.int32(pos),
                                            k_scale=ks, v_scale=vs), np.float32)
    t = lambda a: None if a is None else to_tensor(np.asarray(a))  # noqa: E731
    ours = decode_attention_split_plain(t(q), t(kc), t(vc), t(k_new), t(v_new), pos, t(ks), t(vs))
    assert ours.dtype == t(q).dtype and tuple(ours.shape) == ref.shape
    tol = 1e-5 * np.abs(ref).max() if dtype == "float32" else _ulps(ref)
    assert np.abs(_np(ours) - ref).max() <= tol


def test_kv_cache_write_clips_f8_and_quantizes_int8():
    """f8 rows are clipped to +-448 before the cast (the port saturates where
    JAX's cast gives NaN past ~464); int8 rows are stored with their scales."""
    cfg = ZonosConfig.from_dict(_dict(TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER)).backbone
    rows = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 3, 2, 16)).astype(np.float32))
    rows[0, 0, 0, 0] = 1000.0
    f8 = tbb.KVCache.create(cfg, 2, 8, torch.float32, kv="f8")
    f8.write(1, 4, rows, -rows)
    assert f8.k.dtype == torch.float8_e4m3fn and f8.k_scale is None
    assert float(f8.k[1, 0, 0, 4, 0]) == 448.0 and float(f8.v[1, 0, 0, 4, 0]) == -448.0
    assert torch.isfinite(f8.k.float()).all() and (f8.k[:, :, :, :4].float() == 0).all()
    i8 = tbb.KVCache.create(cfg, 2, 8, torch.float32, kv="int8")
    i8.write(0, 2, rows, rows)
    q, s = tbb.quantize_kv_rows(rows.transpose(1, 2))
    assert torch.equal(i8.k[0, :, :, 2:5], q) and torch.equal(i8.k_scale[0, :, :, 2:5], s)
    with pytest.raises(ValueError):
        tbb.KVCache.create(cfg, 2, 8, kv="int4")


# ---------------------------------------------------------------------------
# convert and the model's serving modes
# ---------------------------------------------------------------------------


def test_convert_keeps_quantized_weights():
    jm = JaxZonos(JaxZonosConfig.from_dict(_dict(TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER)),
                  seed=0)
    jm.quantize_int8()
    jm.params["backbone"]["layers"]["w1"] = jbb.quantize_weight_int4(
        jnp.asarray(np.random.default_rng(7).normal(size=(2, 64, 256)), jnp.float32), 32)
    p = convert_zonos_params(jax.tree.map(np.asarray, jm.params), dtype=torch.float32)
    layers = p["backbone"]["layers"]
    assert layers["wqkv"]["q"].dtype == torch.int8 and layers["wqkv"]["s"].dtype == torch.bfloat16
    assert layers["w1"]["q4"].dtype == torch.int8 and layers["w1"]["s4"].dtype == torch.bfloat16
    assert p["heads"]["s"].dtype == torch.bfloat16
    assert p["embeddings"].dtype == torch.float32  # the float leaves are recast


def test_set_storage_refuses_unknown_modes():
    m = Zonos(ZonosConfig.from_dict(_dict(TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER)),
              device="cpu")
    with pytest.raises(ValueError):
        m.set_storage(kv="int4")
    with pytest.raises(ValueError):
        m.set_storage(ssm="f16")
    for ssm in ("int8", "int4"):  # the quantized SSM states are ported
        assert m.set_storage(ssm=ssm).storage == {"kv": None, "ssm": ssm}
    assert m.set_storage(kv="f8", ssm="bf16").storage == {"kv": "f8", "ssm": "bf16"}


# ---------------------------------------------------------------------------
# greedy generate against JAX
# ---------------------------------------------------------------------------


def _jax_model(base: dict, tiny: dict, weights: str | None) -> JaxZonos:
    jm = JaxZonos(JaxZonosConfig.from_dict(_dict(base, tiny)), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    if weights == "int8":
        jm.quantize_int8()
    elif weights == "int4":
        jm.quantize_int4(group_size=32)
    return jm


def _port_model(jm: JaxZonos, base: dict, tiny: dict) -> Zonos:
    return Zonos(ZonosConfig.from_dict(_dict(base, tiny)),
                 params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")


def _jax_generate(jm: JaxZonos, prefix: np.ndarray, cfg_scale: float, kv: str | None) -> list:
    """JAX greedy codes with the KV cache in ``kv`` storage."""
    with pytest.MonkeyPatch.context() as mp:
        for var in KV_ENV.values():
            mp.delenv(var, raising=False)
        if kv is not None:
            mp.setenv(KV_ENV[kv], "1")
            create = jbb.KVCache.create
            mp.setattr(jtts, "KVCache", SimpleNamespace(
                create=lambda cfg, batch, seqlen, dtype=None: create(cfg, batch, seqlen,
                                                                     jnp.bfloat16)))
        jm._generate_cache.clear()
        try:
            return jm.generate(jnp.asarray(prefix), max_new_tokens=MAX_NEW, cfg_scale=cfg_scale,
                               batch_size=2, sampling_params=JaxSamplingParams.greedy(),
                               progress_bar=False)
        finally:
            jm._generate_cache.clear()


@pytest.fixture(scope="module")
def transformer_models():
    models = {}
    for weights in ("int8", "int4"):
        jm = _jax_model(TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER, weights)
        models[weights] = (jm, _port_model(jm, TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER))
    return models


@pytest.fixture(scope="module")
def transformer_prefix(transformer_models):
    jm, tm = transformer_models["int8"]
    spk = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
    jp = np.asarray(jm.prepare_conditioning(jax_make_cond_dict(text=TEXTS, speaker=spk)))
    tp = tm.prepare_conditioning(make_cond_dict(text=TEXTS, speaker=spk))
    assert np.abs(tp.numpy() - jp).max() <= 1e-5 * np.abs(jp).max()
    return jp, tp


def test_port_quantize_equals_converted_jax_quantize(transformer_models):
    """The port's own ``quantize_int8``/``quantize_int4`` give the weights that
    JAX's give (the greedy runs below convert JAX's)."""
    for weights in ("int8", "int4"):
        jm, tm = transformer_models[weights]
        fresh = _port_model(_jax_model(TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER, None),
                            TRANSFORMER_CONFIG_DICT, TINY_TRANSFORMER)
        if weights == "int8":
            fresh.quantize_int8()
        else:
            fresh.quantize_int4(group_size=32)
        for name in ("wqkv", "wo", "w1", "w2"):
            for key, t in fresh.params["backbone"]["layers"][name].items():
                assert torch.equal(t, tm.params["backbone"]["layers"][name][key]), (weights, name)
        for key, t in fresh.params["heads"].items():
            assert torch.equal(t, tm.params["heads"][key])


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
@pytest.mark.parametrize("weights,kv", [("int8", None), ("int8", "int8"), ("int8", "f8"),
                                        ("int4", None)])
def test_greedy_generate_matches_jax(transformer_models, transformer_prefix, weights, kv,
                                     cfg_scale):
    jm, tm = transformer_models[weights]
    jp, tp = transformer_prefix
    ref = _jax_generate(jm, jp, cfg_scale, kv)
    made = []
    ops = tm.backbone

    def recording_make_cache(*args, **kwargs):
        made.append(ops.make_cache(*args, **kwargs))
        return made[-1]

    tm.backbone = dataclasses.replace(ops, make_cache=recording_make_cache)
    try:
        tm.set_storage(kv=kv)
        ours = tm.generate(tp, max_new_tokens=MAX_NEW, cfg_scale=cfg_scale, batch_size=2,
                           sampling_params=SamplingParams.greedy())
    finally:
        tm.backbone = ops
        tm.set_storage()
    want = {None: torch.float32, "f8": torch.float8_e4m3fn, "int8": torch.int8}[kv]
    assert made[0].k.dtype == want
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_hybrid_int8_greedy_generate_matches_jax():
    jm = _jax_model(HYBRID_CONFIG_DICT, TINY_HYBRID, "int8")
    tm = _port_model(jm, HYBRID_CONFIG_DICT, TINY_HYBRID)
    assert all("q" in lp[n] for lp in tm.params["backbone"]["layers_list"]
               for n in ("in_proj", "out_proj", "wqkv", "wo", "w1", "w2") if n in lp)
    spk = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
    jp = np.asarray(jm.prepare_conditioning(jax_make_cond_dict(text=TEXTS, speaker=spk)))
    tp = tm.prepare_conditioning(make_cond_dict(text=TEXTS, speaker=spk))
    ref = _jax_generate(jm, jp, 2.0, None)
    ours = tm.generate(tp, max_new_tokens=MAX_NEW, cfg_scale=2.0, batch_size=2,
                       sampling_params=SamplingParams.greedy())
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_quantized_serving_runs_without_jax_or_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["zonos_tpu"] = None
        import copy
        from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
        from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
        d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
        d["backbone"].update({TINY_TRANSFORMER!r})
        for quantize, kv in (("quantize_int8", "int8"), ("quantize_int4", "f8")):
            m = Zonos(ZonosConfig.from_dict(d), device="cpu")
            getattr(m, quantize)(**({{"group_size": 32}} if quantize == "quantize_int4" else {{}}))
            codes = m.set_storage(kv=kv).generate(
                m.prepare_conditioning(make_cond_dict(text="Hi there.")), max_new_tokens=6, seed=1)
            assert codes[0].shape[0] == 9
        assert not any(n == "jax" or n.startswith(("jax.", "zonos_tpu."))
                       for n, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"
