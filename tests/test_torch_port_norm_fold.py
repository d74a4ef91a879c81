"""A layer's norm folded into the product that reads it, on the CPU.

``ops/quant.py`` ``norm_matmul`` computes ``matmul_w(norm(x).to(dtype), w)``:
on the card G1 or K8 normalise x as they stage it, by N1's own code
(``csrc/row_stats.cuh``); on the CPU the composition itself runs.  These
tests hold the CPU route against the JAX package's norm, cast and
``matmul_w``, and hold numpy models of the kernels' statistics order and of
where K8's staging puts each normalised element (G1's writes are modelled in
``test_torch_port_gemm_maps.py``).  The card-only tests in
``test_torch_port_cuda.py`` hold the folded launches against N1 and then the
product bit for bit.

Tolerances: the products 2 bf16 ulps of max|ref|, as
``test_torch_port_quant.py`` holds ``matmul_w``; the statistics model bit for
bit against itself under every assignment of rows to warps, and 1e-6
relative against fp64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.models import backbone as jbb
from zonos_tpu.ops import norms as jnorms
from zonos_tpu_torch.convert import to_tensor
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.ops import quant as tq
from zonos_tpu_torch.ops.norms import apply_norm

D_IN, D_OUT = 128, 96


def _ulps(ref: np.ndarray, n: int = 2) -> float:
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _weights(rng, kind: str):
    w = jnp.asarray(rng.normal(size=(D_IN, D_OUT)) * D_IN ** -0.5, jnp.bfloat16)
    tw = to_tensor(np.asarray(w))
    if kind == "int8":
        return jbb.quantize_weight_int8(w), tq.quantize_weight_int8(tw)
    if kind == "int4":
        return jbb.quantize_weight_int4(w, 32), tq.quantize_weight_int4(tw, 32)
    return w, tw


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_matmul_matches_jax(kind, x_dtype, rms):
    """The norm (LayerNorm with bias, RMSNorm without), the cast to bf16
    and the product by a bf16, int8 or int4 weight, against JAX's."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(3, 5, D_IN)) * 2 + 3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=D_IN)).astype(np.float32)
    bias = (0.1 * rng.normal(size=D_IN)).astype(np.float32)
    jx = jnp.asarray(x, x_dtype)
    js, jb = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
    jh = jnorms.rms_norm(jx, js, 1e-5) if rms else jnorms.layer_norm(jx, js, jb, 1e-5)
    jw, tw = _weights(rng, kind)
    ref = np.asarray(jbb.matmul_w(jh.astype(jnp.bfloat16), jw), np.float32)

    tx = to_tensor(np.asarray(jx))
    norm = Norm(to_tensor(np.asarray(js)), None if rms else to_tensor(np.asarray(jb)), 1e-5, rms)
    ours = tq.norm_matmul(tx, norm, tw, torch.bfloat16)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape
    assert np.abs(ours.float().numpy() - ref).max() <= _ulps(ref)
    # on the CPU the op is the composition itself, bit for bit
    assert torch.equal(ours, tq.matmul_w(apply_norm(tx, norm).to(torch.bfloat16), tw))


# ---------------------------------------------------------------------------
# the statistics order of csrc/row_stats.cuh
# ---------------------------------------------------------------------------

F = np.float32


def _warp_stats(row: np.ndarray, eps: float, rms: bool) -> tuple[np.float32, np.float32]:
    """row_stats::stats_rows as one warp computes it in fp32: lane l keeps 8
    partial sums, partial i adding elements l * 8 + i, l * 8 + i + 256, ...
    in increasing order (the 32 lanes and 8 partials side by side); a lane's
    partials meet as ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), the
    lanes by the butterfly xor 16, 8, 4, 2, 1; each lane's total must come
    out the same.  LayerNorm: the sum, then the squared deviations from the
    mean the same way."""
    d = row.shape[0]
    steps = -(-d // 256)
    vals = np.zeros((steps * 256,), F)
    vals[:d] = row
    vals = vals.reshape(steps, 32, 8)  # [step][lane][i]: element step * 256 + lane * 8 + i
    inside = (np.arange(steps * 256) < d).reshape(steps, 32, 8)

    def lanes_sum(term):
        part = np.zeros((32, 8), F)
        for st in range(steps):
            part = np.where(inside[st], (part + term(vals[st])).astype(F), part)
        p = [part[:, i] for i in range(8)]
        lane = (((p[0] + p[1]).astype(F) + (p[2] + p[3]).astype(F)).astype(F)
                + ((p[4] + p[5]).astype(F) + (p[6] + p[7]).astype(F)).astype(F)).astype(F)
        for o in (16, 8, 4, 2, 1):
            lane = (lane + lane[np.arange(32) ^ o]).astype(F)
        assert (lane == lane[0]).all()  # every lane holds the same total
        return lane[0]

    first = F(lanes_sum(lambda v: (v * v).astype(F) if rms else v) / F(d))
    if rms:
        return F(0), F(1 / np.sqrt(np.float64(F(first + F(eps)))))
    var = F(lanes_sum(lambda v: ((v - first).astype(F) ** 2).astype(F)) / F(d))
    return first, F(1 / np.sqrt(np.float64(F(var + F(eps)))))


def _rows_of_warps(rows: int, warps: int, first: int = 0) -> dict[int, int]:
    """Row -> the warp that computes it when ``warps`` warps take rows
    w, w + warps, ... (G1's consumer warps: 4 a warpgroup; K8's 8; N1: one
    warp a row, 8 a CTA)."""
    return {r: (r - first) % warps for r in range(first, rows)}


@pytest.mark.parametrize("d", [16, 2048, 4096])
@pytest.mark.parametrize("rms", [False, True])
def test_fold_statistics_are_n1_s(d, rms):
    """The statistics a fold's warps compute (G1: 4 or 8 consumer warps over
    a tile's rows; K8: 8 warps over up to 64 rows) are N1's: each row by one
    whole warp in the header's lane order, whatever warp and whatever other
    rows, so the models give the same bits; and they are the row's mean and
    rsqrt(var + eps) within 1e-6 of fp64."""
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(12, d)) * 2 + 3).astype(F)
    n1 = {r: _warp_stats(x[r], 1e-5, rms) for r in range(12)}  # N1: row r, warp r % 8
    for warps in (4, 8):  # G1's consumer warps (one or two warpgroups), K8's warps
        owners = _rows_of_warps(12, warps)
        assert sorted(owners) == list(range(12))  # every row once, by one whole warp
        for r in (0, warps - 1, 11):  # the row's own warp, whatever the others hold
            batch = np.stack([x[r]] + [rng.normal(size=d).astype(F) for _ in range(3)])
            assert _warp_stats(batch[0], 1e-5, rms) == n1[r]
    for r in range(12):
        xd = x[r].astype(np.float64)
        mean = 0.0 if rms else xd.mean()
        ms = (xd ** 2).mean() if rms else ((xd - mean) ** 2).mean()
        assert abs(n1[r][0] - mean) <= 1e-6 * max(abs(mean), 1.0)
        assert abs(n1[r][1] - 1 / np.sqrt(ms + 1e-5)) <= 1e-6 / np.sqrt(ms + 1e-5)


# ---------------------------------------------------------------------------
# K8's staging of the normalised pairs (csrc/int4_matmul.cu stage)
# ---------------------------------------------------------------------------


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bits, rounded to nearest even (finite values)."""
    u = v.astype(F).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _byte_perm(x: int, y: int, s: int) -> int:
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * n)) & 0xF] << (8 * n) for n in range(4))


@pytest.mark.parametrize("M,din", [(2, 256), (16, 512), (5, 2048)])
def test_k8_stages_each_normalised_element_with_its_own_column(M, din):
    """K8's stage with a folded norm: item (row n, block j) of a chunk of
    packed rows c0.. loads 8 values at columns c0 + j and 8 at half + c0 + j,
    normalises each with its own column's scale and bias, rounds to bf16 and
    pairs them as (x[c0 + j + i], x[half + c0 + j + i]) words; the model of
    those words equals the pairs of the normalised x, rounded once."""
    rng = np.random.default_rng(M + din)
    x = (rng.normal(size=(M, din)) * 2 + 3).astype(F)
    scale = _bf16_bits((1 + 0.1 * rng.normal(size=din)).astype(F))
    bias = _bf16_bits((0.1 * rng.normal(size=din)).astype(F))
    sc, b = (scale << 16).view(F), (bias << 16).view(F)
    stats = [_warp_stats(x[n], 1e-5, False) for n in range(M)]
    half, chunk = din // 2, 512
    for c0 in range(0, half, chunk):
        cn = min(chunk, half - c0)
        blocks = cn // 8
        xs = np.zeros((M, cn), np.uint32)
        seen = np.zeros((M, cn), int)
        for i in range(M * blocks):
            n, j = i // blocks, (i % blocks) * 8
            words = []
            for at in (c0 + j, half + c0 + j):
                cols = at + np.arange(8)
                t = ((x[n, cols] - stats[n][0]).astype(F) * stats[n][1]).astype(F)
                t = (t * sc[cols]).astype(F)
                t = (t + b[cols]).astype(F)
                bits = _bf16_bits(t)
                words.append([int(bits[2 * k]) | (int(bits[2 * k + 1]) << 16) for k in range(4)])
            lo, hi = words
            for k in range(4):
                xs[n, j + 2 * k] = _byte_perm(lo[k], hi[k], 0x5410)
                xs[n, j + 2 * k + 1] = _byte_perm(lo[k], hi[k], 0x7632)
                seen[n, j + 2 * k:j + 2 * k + 2] += 1
        assert (seen == 1).all()
        mean = np.array([s[0] for s in stats], F)[:, None]
        r = np.array([s[1] for s in stats], F)[:, None]
        normed = ((((x - mean).astype(F) * r).astype(F) * sc).astype(F) + b).astype(F)
        want = _bf16_bits(normed[:, c0:c0 + cn]) | (_bf16_bits(normed[:, half + c0:half + c0 + cn])
                                                    << 16)
        np.testing.assert_array_equal(xs, want)
