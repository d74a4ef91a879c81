"""K3, the fused sampler: its plain version against the Pallas kernel, and
the CPU-checkable model of its Hopper kernel.

The plain version (``fused_sample_plain``, the CPU path of the wrapper) is
held against ``fused_sample_pallas`` run in interpret mode at every branch
the kernel must get right: a temperature other than 1, ``quad`` > 0,
``linear`` 0 (no unified stage), min-p with and without the unified stage,
a vocabulary that is not a multiple of 4, rows with a single finite logit
(EOS mode) and rows whose top two logits and noise are equal (the lowest
index wins).  Ids must be equal.

The Hopper kernel (``csrc/sampling.cu``) runs only on the card.  Here a
numpy model of its warp route (the lane-to-entry map, each lane's sums in the
kernel's order, the xor butterflies, and its algebra: log p as (t - m) -
log s, min-p's top as 1 / s2, the race on raw - m2) is held against the
plain version: ids equal outside near ties (the plain version's top two
scores within 1e-4, the tolerance ``chip_smoke.py`` holds the kernel to),
and exactly on the EOS-mode and tied rows.  The launch plan
(``sample_plan``) is checked for every vocabulary from 1 to 12,288: each entry
read by exactly one lane (or thread, on the CTA route), each row by one warp,
the route and the lane map a function of the shape alone.  The parameter
points and operands are ``tests/_k3_cases.py``'s, shared with the card tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _k3_cases import DEFAULT, NEAR_TIE, POINTS  # tests/, on sys.path under pytest
from _k3_cases import operands as _operands
from zonos_tpu.ops.pallas_kernels import _sampling_kernel, fused_sample_pallas
from zonos_tpu_torch.kernels.sampling import (
    MAX_VOCAB,
    WARP_CHUNKS,
    WARP_MAX_VOCAB,
    WARPS_PER_CTA,
    fused_sample,
    fused_sample_plain,
    fused_sample_scores_plain,
    sample_plan,
)

CTA_THREADS = 256  # the CTA route's threads (csrc/sampling.cu kThreads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _pallas_ids(logits, gumbel, temperature=1.0, **kw):
    """``fused_sample_pallas``'s kernel body in interpret mode on the given
    noise (the public function draws its own from a key)."""
    B, K, V = logits.shape
    kernel = functools.partial(_sampling_kernel, temperature=temperature, **kw)
    spec = pl.BlockSpec((1, K, V), lambda b: (b, 0, 0))
    out = pl.pallas_call(kernel, grid=(B,), in_specs=[spec, spec],
                         out_specs=pl.BlockSpec((1, K, 1), lambda b: (b, 0, 0)),
                         out_shape=jax.ShapeDtypeStruct((B, K, 1), jnp.int32),
                         interpret=True)(jnp.asarray(logits), jnp.asarray(gumbel))
    return np.asarray(out[..., 0])


@pytest.mark.parametrize("point", ["T 0.7", "quad 0.1", "linear 0", "linear 0, min_p 0.1",
                                   "conf -1"])
def test_fused_sample_plain_matches_pallas_at_each_branch(point):
    """The public Pallas function with per-row keys; the plain version on the
    same noise (drawn by JAX, passed in as numpy)."""
    B, K, V = 2, 9, 1152
    keys = jax.random.split(jax.random.key(7), B)
    keyed = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (K, V), jnp.float32))(keys))
    # the tied row's equal noise cannot come from a key: it is compared through the kernel body
    logits, gumbel, known = _operands(21, B, V, gumbel=keyed)
    kw = POINTS[point]
    ref = np.asarray(fused_sample_pallas(keys, jnp.asarray(logits), interpret=True, **kw))
    ours = fused_sample_plain(_t(logits), _t(keyed), **kw).numpy()
    np.testing.assert_array_equal(ours, ref)
    ours_tied = fused_sample_plain(_t(logits), _t(gumbel), **kw).numpy()
    np.testing.assert_array_equal(ours_tied, _pallas_ids(logits, gumbel, **kw))
    for (b, k), want in known.items() if kw["conf"] >= 0 else ():
        assert ours[b, k] == want or (b, k) == (0, 1)
        assert ours_tied[b, k] == want


@pytest.mark.parametrize("V", [1025, 1152, 2049])
@pytest.mark.parametrize("point", ["default", "min_p 0.1"])
def test_fused_sample_plain_matches_pallas_on_given_noise(V, point):
    """V 1025 and 2049 are not multiples of 4; the EOS-mode and tied rows
    give their known ids."""
    logits, gumbel, known = _operands(V, 2, V)
    kw = POINTS[point]
    ours = fused_sample(_t(logits), _t(gumbel), **kw).numpy()  # the CPU path: the plain version
    np.testing.assert_array_equal(ours, _pallas_ids(logits, gumbel, **kw))
    for (b, k), want in known.items():
        assert ours[b, k] == want


# ---------------------------------------------------------------------------
# the warp route's model
# ---------------------------------------------------------------------------


def _lane_entries(J: int) -> np.ndarray:
    """[32, J, 4]: the entry lane l holds in slot (j, c), 4 (32 j + l) + c."""
    lanes, js, cs = np.arange(32)[:, None, None], np.arange(J)[None, :, None], np.arange(4)
    return 4 * (32 * js + lanes) + cs


def _butterfly(a: np.ndarray, op) -> np.ndarray:
    """The kernel's ``v = op(v, __shfl_xor_sync(v, o))``, o = 16 .. 1, over
    the lane axis (1)."""
    for o in (16, 8, 4, 2, 1):
        a = op(a, a[:, np.arange(32) ^ o])
    return a


def _lane_sum(a: np.ndarray) -> np.ndarray:
    """[R, 32, J, 4] -> [R, 32]: one partial per c over j, then (0 + 1) + (2 + 3)."""
    acc = np.zeros(a.shape[:2] + (4,), np.float32)
    for j in range(a.shape[2]):
        acc = acc + a[:, :, j, :]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _warp_model(logits: np.ndarray, noise: np.ndarray, linear, conf, quad, min_p,
                temperature=1.0) -> np.ndarray:
    """ids [B, K] as csrc/sampling.cu fused_sample_warp_kernel computes them, in fp32."""
    B, K, V = logits.shape
    assert sample_plan(V).route == "warp"
    f32 = np.float32
    idx = _lane_entries(WARP_CHUNKS)
    valid = idx < V
    at = np.where(valid, idx, 0)
    x, g = logits.reshape(-1, V), noise.reshape(-1, V)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        v = np.where(valid, x[:, at], -np.inf).astype(f32)  # [R, 32, J, 4]
        g = np.where(valid, g[:, at], 0).astype(f32)
        v = v * (f32(1) / f32(temperature))
        m = _butterfly(v.max(axis=(2, 3)), np.maximum)[:, :, None, None]
        v = v - m
        e = np.exp(v)
        s = _butterfly(_lane_sum(e), np.add)[:, :, None, None]
        if linear > 0:
            v = np.maximum(v - np.log(s), np.log(f32(1e-20)))
            ent = -(f32(1) / s) * _butterfly(_lane_sum(e * v), np.add)[:, :, None, None]
            lin = f32(linear) + ent * f32(conf)
            raw = np.where(valid, v * lin - v * v * f32(quad), -np.inf).astype(f32)
            m2 = _butterfly(raw.max(axis=(2, 3)), np.maximum)[:, :, None, None]
            # the kernel's shortcut where lin > 0 and quad >= 0: raw at the largest entry
            # (t - m = 0), equal to the reduction's max
            lp_top = np.maximum(f32(0) - np.log(s), np.log(f32(1e-20)))
            short = lp_top * lin - lp_top * lp_top * f32(quad)
            rising = (lin > 0) & (quad >= 0)
            np.testing.assert_array_equal(np.where(rising, short, m2), m2)
            v = raw - m2
            e = np.exp(v)
            s = _butterfly(_lane_sum(e), np.add)[:, :, None, None]
        inv = f32(1) / s
        p = e * inv
        score = np.where((p > 0) & ~(p < f32(min_p) * inv) & valid, v + g, -np.inf)
    # the butterfly's (value, lowest index) order is total, so the warp's winner is the
    # row's first maximum in entry order
    flat = np.full((score.shape[0], WARP_MAX_VOCAB), -np.inf, np.float32)
    flat[:, idx.reshape(-1)] = score.reshape(score.shape[0], -1)
    return flat[:, :V].argmax(axis=1).reshape(B, K)


@pytest.mark.parametrize("V", [1024, 1025, 1152])
@pytest.mark.parametrize("point", list(POINTS))
def test_warp_model_matches_plain(V, point):
    B = 4
    logits, gumbel, known = _operands(100 + V, B, V)
    kw = POINTS[point]
    scores = fused_sample_scores_plain(_t(logits), _t(gumbel), **kw)
    ref = scores.argmax(-1).numpy()
    top2 = scores.topk(2, dim=-1).values.numpy()
    near_tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    ours = _warp_model(logits, gumbel, **kw)
    assert not np.any((ours != ref) & ~near_tie)
    assert near_tie.sum() <= 1  # the tied row: top two scores equal
    for (b, k), want in known.items() if kw["conf"] >= 0 else ():
        assert ours[b, k] == want and ref[b, k] == want


def test_warp_model_ids_do_not_depend_on_the_batch():
    """A row's id from the model alone and inside a batch of 64: equal (the
    lane map and the sums depend on V alone)."""
    logits, gumbel, _ = _operands(5, 64, 1152)
    ids = _warp_model(logits, gumbel, **DEFAULT)
    for b in (0, 37, 63):
        np.testing.assert_array_equal(_warp_model(logits[b:b + 1], gumbel[b:b + 1], **DEFAULT)[0],
                                      ids[b])


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


def test_lane_maps_read_each_entry_once():
    """The warp route's slots are a permutation of 0 .. WARP_MAX_VOCAB - 1:
    each lane holds 4 J entries, no two lanes the same one."""
    idx = _lane_entries(WARP_CHUNKS)
    assert idx.shape == (32, WARP_CHUNKS, 4) and 128 * WARP_CHUNKS == WARP_MAX_VOCAB
    np.testing.assert_array_equal(np.sort(idx.reshape(-1)), np.arange(WARP_MAX_VOCAB))


def test_sample_plan_at_every_vocabulary():
    """For every V from 1 to MAX_VOCAB: the warp route up to WARP_MAX_VOCAB,
    so that every entry 0 .. V - 1 is read by exactly one lane (the slots past
    V masked); the CTA route past it, each entry read by thread i % 256 (the
    row fits 48 KB).  The plan takes V alone: a row's lane map, and so its
    sums, do not depend on the row count."""
    V = np.arange(1, MAX_VOCAB + 1)
    plans = [sample_plan(int(v)) for v in V]
    route = np.array([p.route for p in plans])
    warps = np.array([p.warps for p in plans])
    warp = V <= WARP_MAX_VOCAB
    assert (route[warp] == "warp").all() and (route[~warp] == "cta").all()
    assert (warps[warp] == WARPS_PER_CTA).all() and (warps[~warp] == 1).all()
    idx = _lane_entries(WARP_CHUNKS).reshape(-1)
    for v in V[warp][::37].tolist() + [WARP_MAX_VOCAB]:
        np.testing.assert_array_equal(np.sort(idx[idx < v]), np.arange(v))
    assert 4 * V[~warp].max() <= 48 * 1024
    for v in V[~warp][::97]:
        owned = np.arange(CTA_THREADS)[:, None] + CTA_THREADS * np.arange(-(-v // CTA_THREADS))
        np.testing.assert_array_equal(np.sort(owned[owned < v]), np.arange(v))


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_warp_route_reads_each_row_once(warps):
    """The launcher's grid of ceil(rows / warps) CTAs, warp w of CTA b on row
    b * warps + w (csrc/sampling.cu): each row in exactly one warp, the
    warps past the last row idle."""
    for rows in (1, 9, 36, 576, 577, 4096):
        grid = -(-rows // warps)
        row = np.arange(grid)[:, None] * warps + np.arange(warps)[None, :]
        np.testing.assert_array_equal(row[row < rows], np.arange(rows))
        assert (row >= rows).sum() < warps


def test_sample_plan_at_the_flagship_shapes():
    assert sample_plan(1152) == ("warp", WARPS_PER_CTA)  # 9 x 128 = 1152: no slot masked
    assert sample_plan(1025) == ("warp", WARPS_PER_CTA)
    assert sample_plan(1153) == sample_plan(12288) == ("cta", 1)
