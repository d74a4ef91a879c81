"""Launch plans and arithmetic of K7, K2, K1 and K5 that the CPU can check.

K7 (the Mamba2 decode-state step) cuts each bh row's state into slabs
(``slab_plan``) and widens f8 through f16; on int8 and int4 states one CTA
holds a head in pieces of 16 values; K2 (one-pass decode attention,
the band of lengths up to 256) splits a cache's rows over the CTAs of a
thread-block cluster and combines their partial softmaxes in rank order; K1
(decode attention, the bands past 256) does the same over clusters of up to
16 CTAs, each CTA walking its chunk in stages carried online.  The host fixes
each band's cluster size (``band_plan``); each CTA computes its rows from
the length on the card (``rank_rows``), some CTAs getting none.
K5 (the DAC snake-conv) computes tiles chosen by shape (``conv_plan``) over
chunks of 8 input channels and a halo window.  The kernels run only on the
card; here the plans are checked for coverage and a numpy or torch model of
each kernel's arithmetic is held against the plain versions and JAX's
``decode_attention`` and DAC residual unit.

Tolerances: the f8 widening exactly; the K2 and K1 models 1e-6 x max|ref|
against the plain versions (the same sums in another order; K1's against
them in float64, since over 2000 rows the fp32 plain version's own rounding
reaches ~9e-7), 1e-5 against JAX (the existing port tests' bound); the K5 model 1e-5 x max|ref|
against the plain version and JAX's residual unit (fp32 sums of up to C_in x k
products in another order; the existing K5 parity tests' bound).
"""

from __future__ import annotations

import itertools
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.models.dac.codec import _res_unit as jax_res_unit
from zonos_tpu.ops.attention import decode_attention as jax_decode_attention
from zonos_tpu_torch.kernels.decode_attention import (
    BANDS,
    MAX_CLUSTER,
    MAX_FLASH_CLUSTER,
    ONE_CTA_ROWS,
    ROWS_PER_PASS,
    Band,
    BandPlan,
    attention_scale,
    band_of,
    band_plan,
    decode_attention_plain,
    decode_attention_split_plain,
    rank_rows,
)
from zonos_tpu_torch.kernels.snake_conv import (
    TILES,
    ci_chunk,
    conv_plan,
    snake_conv1d_plain,
)
from zonos_tpu_torch.kernels.ssm_state import (
    MAX_SLAB_BYTES,
    QUANT_THREADS,
    QUANT_VALUES_PER_THREAD,
    quantize_state,
    slab_plan,
)

SMS = 132  # an H100 SXM's SMs, as the wrappers read them from the card


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _slab_coverage(BH: int, P: int, rows: int, per_bh: int) -> np.ndarray:
    """How often K7's grid ``(BH, per_bh)`` visits each state row: CTA ``(bh,
    s)`` takes rows ``[s * rows, + rows)`` of bh row ``bh``
    (csrc/ssm_state.cu)."""
    seen = np.zeros((BH, P), np.int64)
    for s in range(per_bh):  # every bh row at once
        p0 = s * rows
        assert p0 < P  # no CTA without rows
        seen[:, p0:min(p0 + rows, P)] += 1
    return seen


@pytest.mark.parametrize("itemsize", [4, 2, 1])  # fp32, bf16, f8 state
@pytest.mark.parametrize("P", [16, 50, 64])
@pytest.mark.parametrize("BH", [1, 2, 128, 130, 1024])
def test_slab_plan_covers_every_state_row_once(BH, P, itemsize):
    for N in (64, 128):
        rows, per_bh = slab_plan(BH, P, N, itemsize, SMS)
        assert rows >= 1 and rows * N * itemsize <= MAX_SLAB_BYTES
        assert (_slab_coverage(BH, P, rows, per_bh) == 1).all()


@pytest.mark.parametrize("itemsize", [4, 1])
def test_slab_plan_past_65535_bh_rows(itemsize):
    """Batch 512 with CFG on the hybrid (64 SSM heads): 65,536 bh rows, past
    grid.y's 65,535, go on grid.x (2^31 - 1); the slabs of a bh row on grid.y."""
    BH, P, N = 2 * 512 * 64, 64, 128
    rows, per_bh = slab_plan(BH, P, N, itemsize, SMS)
    assert BH <= 2**31 - 1 and per_bh <= 65535
    assert (_slab_coverage(BH, P, rows, per_bh) == 1).all()


def test_slab_plan_at_the_flagship_shapes():
    """Batch 1 with CFG (BH 128, fp32 state) is cut into 8-row slabs, 1024
    CTAs; batch 8 with CFG (BH 1024, f8 state) keeps one 8 KB slab a bh row."""
    assert slab_plan(128, 64, 128, 4, SMS) == (8, 8)
    assert slab_plan(1024, 64, 128, 1, SMS) == (64, 1)


def _quant_threads(P: int, N: int) -> int:
    """The int8/int4 kernel's CTA, as csrc/ssm_state.cu ``launch_quant`` sizes
    it: whole warps of two of a head's ``P * N / 16`` pieces a thread, at most
    ``QUANT_THREADS`` (which then hold up to four pieces each)."""
    return min(QUANT_THREADS, 32 * -(-P * (N // 16) // 64))


@pytest.mark.parametrize("P,N", [(64, 128), (50, 128), (64, 64), (64, 256), (16, 512),
                                 (4, 16), (1, 16), (3, 32)])
def test_quant_kernel_holds_every_piece_once(P, N):
    """The int8/int4 kernel's map (csrc/ssm_state.cu ``quant_step_kernel``):
    thread t of ``_quant_threads`` holds pieces ``j * threads + t``, j < 4,
    each 16 values of row ``i / lanes`` from column ``(t % lanes) * 16``; a
    row's lanes share a warp (the y shuffle), every piece of the head is held
    once, and a thread's column is the same in every piece (its C and B)."""
    lanes, per = N // 16, QUANT_VALUES_PER_THREAD // 16
    threads = _quant_threads(P, N)
    assert threads % 32 == 0 and 32 <= threads <= QUANT_THREADS and 32 % lanes == 0
    held = np.zeros((P, N), np.int64)
    for t in range(threads):
        for j in range(per):
            i = j * threads + t
            if i >= P * lanes:
                continue
            r, n0 = divmod(i, lanes)
            assert n0 * 16 == (t % lanes) * 16
            assert (i - t % lanes) // 32 == i // 32  # the row's first lane is in this warp
            held[r, n0 * 16:(n0 + 1) * 16] += 1
    assert (held == 1).all()
    if (P, N) == (64, 128):  # the flagship: 256 threads, 2 pieces each
        assert threads == 256


def test_quant_kernel_int4_byte_layout():
    """The kernel packs q[2i] in byte i's low nibble and q[2i+1] in its high
    nibble, as ``quantize_state`` (and JAX's _store_ssm) do, and reads a
    nibble back as ``((v & 15) ^ 8) - 8`` and ``v >> 4``."""
    s = torch.arange(-7, 9, dtype=torch.float32)[None, None, :].clamp(max=7)
    q, scale = quantize_state(s, "int4")
    assert float(scale) == float(torch.tensor(7.0) * torch.tensor(1 / 7, dtype=torch.float32))
    v = q.numpy().astype(np.int32).ravel()
    lo, hi = ((v & 15) ^ 8) - 8, v >> 4
    np.testing.assert_array_equal(np.stack([lo, hi], -1).ravel(),
                                  np.rint(s.numpy().ravel() / float(scale)))


def test_f8_integer_decode_equals_torch_cast():
    """K7 widens f8 state through f16 (csrc/ssm_state.cu: an e4m3 pair to an
    f16 pair in one instruction, then to fp32).  That is exact: all 256 e4m3
    bytes, normals and subnormals, round-trip through float16 bit for bit to
    torch's float8_e4m3fn -> float32, and 0x7F and 0xFF stay NaN."""
    byte = np.arange(256, dtype=np.uint8)
    ref = torch.from_numpy(byte.copy()).view(torch.float8_e4m3fn).float().numpy()
    got = ref.astype(np.float16).astype(np.float32)
    nan = np.isnan(ref)
    assert nan.sum() == 2 and (byte[nan] & 0x7F == 0x7F).all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), ref[~nan].view(np.uint32))


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _split(kernel: str, length: int, bh_kv: int, S: int = 4096,
           held_out: bool = False) -> tuple[int, int, int]:
    """(grid, used, chunk): the cluster size of the band holding ``length``
    cache rows (one more attended with the held-out row) and the split the
    CTAs compute on the card."""
    plan = band_plan(kernel, band_of(length + held_out), bh_kv, S, held_out, SMS)
    used, chunk = rank_rows(length, plan.n, plan.min_rows)
    assert plan.lo <= length <= plan.hi and chunk <= plan.chunk_max
    return plan.n, used, chunk


def _covers_once(length: int, grid: int, used: int, chunk: int) -> None:
    """Every row in exactly one rank; the ranks past ``used`` hold none."""
    assert 1 <= used <= grid and chunk % ROWS_PER_PASS == 0
    seen = np.zeros(length, np.int64)
    for rank in range(used):
        r0 = min(rank * chunk, length)
        seen[r0:min(r0 + chunk, length)] += 1
    assert (seen == 1).all(), (length, grid, used, chunk)


@pytest.mark.parametrize("bh_kv", [1, 8, 64, 512])
def test_cluster_plan_covers_every_row_once(bh_kv):
    for length in range(0, 257):  # 0: a quantized cache at pos 0, the held-out row alone
        grid, used, chunk = _split("K2", length, bh_kv, held_out=length == 0)
        assert grid <= MAX_CLUSTER
        _covers_once(length, grid, used, chunk)
    assert _split("K2", 0, bh_kv, held_out=True)[1:] == (1, 0)


def test_cluster_plan_at_the_flagship_shapes():
    """Batch 1 with CFG (8 pairs): 8 ranks over the band up to 256 rows, 32
    rows a rank at 256, one CTA a rank; up to 64 rows one rank; batch 64 with
    CFG (512 pairs): the same 8 ranks, so that a row splits its cache rows
    as it does alone, run by one CTA a pair (one CTA a pair already fills
    the card)."""
    assert band_plan("K2", Band(1, 256), 8, 2048, False, SMS) == BandPlan(8, 32, 1, 256, 64, 8)
    assert band_plan("K2", Band(1, 256), 8, 2048, True, SMS) == BandPlan(8, 32, 0, 255, 64, 8)
    assert rank_rows(256, 8, 32) == (8, 32)
    assert rank_rows(65, 8, 32) == (3, 32)
    assert rank_rows(64, 8, 32) == (1, 64)
    b64 = band_plan("K2", Band(1, 256), 512, 2048, False, SMS)
    assert (b64.n, b64.grid) == (8, 1)
    assert rank_rows(256, 8, 32) == (8, 32)


def test_bands_cover_every_length_once():
    """The bands tile [1, inf): K2's up to 256, K1's beyond; a band past the
    cache, or a length outside the band given, raises on the host."""
    assert [band_of(n) for n in (1, 256, 257, 512, 513, 10**6)] == [
        Band(1, 256), Band(1, 256), Band(257, 512), Band(257, 512), Band(513, None),
        Band(513, None)]
    assert [Band(*b).kernel for b in BANDS] == ["K2", "K1", "K1"]
    with pytest.raises(ValueError):
        band_of(0)
    with pytest.raises(ValueError):
        band_plan("K1", Band(513, None), 8, 512, False, SMS)  # a 512-row cache has no such band
    with pytest.raises(ValueError):
        Band(257, 512).check(513)
    Band(257, 512).check(257)


def _attend(qh, k, v, rows, scale, k_scale, v_scale, state):
    """One online-softmax step of a state (m, l, acc) over cache ``rows`` (a
    range): M = max(m, max s), l e^(m - M) + sum e^(s - M), acc e^(m - M) +
    sum p v."""
    m, l, acc = state
    rows = slice(rows.start, rows.stop)
    s = torch.einsum("bhgd,bhkd->bhgk", qh, k[:, :, rows].float()) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, rows]
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    pv = p if v_scale is None else p * v_scale[:, :, None, rows]
    return (m_new, l * corr + p.sum(-1),
            acc * corr[..., None] + torch.einsum("bhgk,bhkd->bhgd", pv, v[:, :, rows].float()))


def _merge(states):
    """The ranks' states combined in order: M = max m, L = sum l e^(m - M),
    O = sum acc e^(m - M) (a rank without rows, m = -inf, weighs 0)."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    return (M, sum(l * torch.exp(m - M) for m, l, _ in states),
            sum(acc * torch.exp(m - M)[..., None] for m, _, acc in states))


def _k2_model(q, k, v, length, n, chunk, k_new=None, v_new=None, k_scale=None,
              v_scale=None, stage_rows=None):
    """K2's arithmetic in fp32: rank r keeps (m, l, acc) over cache rows
    [r * chunk, min((r + 1) * chunk, length)), rank 0 started from the held-out
    row (m = its score, l = 1, acc = its v); then the ranks combine in order:
    M = max m_r, L = sum l_r e^(m_r - M), out = sum acc_r e^(m_r - M) / L.
    With ``stage_rows`` (K1) a rank walks its rows in stages of that many,
    carrying (m, l, acc) online from one to the next; K2 takes its chunk as
    one stage.  q [B, 1, H, D], k/v [B, H_kv, S, D], scales [B, H_kv, S]."""
    B, _, H, D = q.shape
    H_kv = k.shape[1]
    qh = q.transpose(1, 2).reshape(B, H_kv, H // H_kv, D).float()  # [B, H_kv, G, D]
    scale = attention_scale(D)
    parts = []
    for rank in range(n):
        r0 = min(rank * chunk, length)
        r1 = min(r0 + chunk, length)
        state = (torch.full(qh.shape[:3], float("-inf")), torch.zeros(qh.shape[:3]),
                 torch.zeros(qh.shape))
        if rank == 0 and k_new is not None:
            kn, vn = k_new[:, 0].float(), v_new[:, 0].float()  # [B, H_kv, D]
            m = torch.einsum("bhgd,bhd->bhg", qh, kn) * scale
            state = (m, torch.ones_like(m), vn[:, :, None, :].expand_as(qh).clone())
        step = stage_rows or max(chunk, 1)
        for s0 in range(r0, r1, step):
            state = _attend(qh, k, v, range(s0, min(s0 + step, r1)), scale, k_scale, v_scale,
                            state)
        parts.append(state)
    _, L, O = _merge(parts)
    return (O / L[..., None]).reshape(B, H, 1, D).transpose(1, 2)


def _plans(length: int, bh_kv: int, held_out: bool = False) -> set[tuple[int, int]]:
    """K2's split at ``bh_kv`` pairs, and the same rows over a full cluster of
    8 (chunks a multiple of 16 rows), so that short caches exercise the
    combine as well."""
    _, used, chunk = _split("K2", length, bh_kv, held_out=held_out)
    full = -(-(-(-length // MAX_CLUSTER)) // ROWS_PER_PASS) * ROWS_PER_PASS
    return {(used, chunk), (MAX_CLUSTER, full)}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _qkv(rng, B, H, H_kv, S, D=128):
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((B, 1, H, D), (B, H_kv, S, D), (B, H_kv, S, D)))


@pytest.mark.parametrize("bh_kv_scale", [1, 64])  # the plans of batch 1 and batch 64 (CFG)
@pytest.mark.parametrize("length", [1, 31, 33, 129, 256])
def test_k2_model_matches_plain(length, bh_kv_scale):
    rng = np.random.default_rng(length)
    q, k, v = _qkv(rng, 2, 16, 4, 256)
    ref = decode_attention_plain(q, k, v, length)
    for n, chunk in _plans(length, 8 * bh_kv_scale):
        assert _rel_err(_k2_model(q, k, v, length, n, chunk), ref) <= 1e-6


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("pos", [0, 30, 128, 255])
def test_k2_model_with_held_out_row_matches_split_plain(pos, storage):
    """Rank 0's held-out start, pos 0 (the held-out row alone) included, against
    the plain split version, in fp32 (an fp32 cache, or int8 rows with their
    fp32 scales, both read in fp32 by the plain version)."""
    rng = np.random.default_rng(100 + pos)
    q, k, v = _qkv(rng, 2, 16, 4, 256)
    k_new, v_new = (torch.from_numpy(rng.normal(size=(2, 1, 4, 128)).astype(np.float32))
                    for _ in range(2))
    scales = (None, None)
    if storage == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(2, 4, 256, 128)).astype(np.int8))
                for _ in range(2))
        scales = tuple(torch.from_numpy((rng.random((2, 4, 256)) * 0.02 + 0.005)
                                        .astype(np.float32)) for _ in range(2))
    ref = decode_attention_split_plain(q, k, v, k_new, v_new, pos, *scales)
    for n, chunk in _plans(pos, 8, held_out=True):
        got = _k2_model(q, k, v, pos, n, chunk, k_new, v_new, *scales)
        assert _rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("length", [1, 32, 33, 129, 256])
def test_k2_model_matches_jax(length, G):
    rng = np.random.default_rng(7 * length + G)
    q, k, v = _qkv(rng, 1, 4 * G, 4, 256)
    ref = jax_decode_attention(q.numpy(), k.numpy(), v.numpy(), jnp.int32(length))
    for n, chunk in _plans(length, 4):
        np.testing.assert_allclose(_k2_model(q, k, v, length, n, chunk).numpy(),
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

FLASH_STAGE_ROWS = {"bf16": 64, "f8": 128, "int8": 128}  # csrc: one 32 KB ring slot of K and V


@pytest.mark.parametrize("bh_kv", [1, 8, 16, 64, 512, 1024])
def test_flash_plan_covers_every_row_once(bh_kv):
    for length in list(range(256, 300)) + list(range(300, 4097, 37)) + [4095, 4096]:
        grid, used, chunk = _split("K1", length, bh_kv, held_out=length == 256)
        assert grid <= MAX_FLASH_CLUSTER and (used == 1 or chunk >= ONE_CTA_ROWS)
        # batch 1's split (8 pairs) at every batch: a row's split is its own
        assert grid == _split("K1", length, 8, held_out=length == 256)[0]
        _covers_once(length, grid, used, chunk)


def test_flash_plan_at_the_flagship_shapes():
    """Batch 1 with CFG (8 pairs): clusters of 8 up to 512 rows and of 16
    beyond (128 CTAs on 132 SMs); at 2000 rows 16 CTAs of 128, at 512 8 of
    64; batch 2 (16 pairs) and batch 64 (512 pairs) with CFG the same, so
    that a row's split does not depend on the batch (at pos 1999 with the
    held-out row: 16 CTAs of 128).  A split may leave its last CTA without
    rows (1665 rows: 15 x 112 = 1680)."""
    assert _split("K1", 2000, 8) == (16, 16, 128)
    assert _split("K1", 4095, 8) == (16, 16, 256)
    assert _split("K1", 512, 8) == (8, 8, 64)
    assert _split("K1", 300, 8) == (8, 5, 64)
    assert _split("K1", 2000, 16) == (16, 16, 128)
    assert _split("K1", 1999, 512, held_out=True) == (16, 16, 128)
    assert _split("K1", 1665, 8) == (16, 16, 112)
    assert band_plan("K1", Band(513, None), 8, 4096, False, SMS) == BandPlan(16, 64, 513, 4096,
                                                                             256, 16)
    # batch 64 with CFG: the same split, one CTA a pair running its 16 ranks in turn
    assert band_plan("K1", Band(513, None), 512, 4096, False, SMS) == BandPlan(16, 64, 513, 4096,
                                                                               256, 1)


# the lengths each band is checked at: its edges, and inside it lengths where the split
# changes and where its last CTAs get no rows
BAND_LENGTHS = {(1, 256): (1, 2, 64, 65, 129, 250, 256),
                (257, 512): (257, 258, 300, 449, 512),
                (513, None): (513, 1000, 1665, 2047, 2048)}


@pytest.mark.parametrize("bh_kv", [8, 512])  # the plans of batch 1 and batch 64 (CFG)
@pytest.mark.parametrize("band", list(BAND_LENGTHS))
def test_band_plan_model_matches_plain(band, bh_kv):
    """Each band's fixed plan over every length checked in it: the kernel's
    torch model (its grid, the ranks past the split and the empty ones
    holding no rows) against the plain version in float64."""
    S = 2048
    q, k, v = _qkv(np.random.default_rng(band[0] + bh_kv), 2, 16, 4, S)
    kernel = Band(*band).kernel
    plan = band_plan(kernel, Band(*band), bh_kv, S, False, SMS)
    for length in BAND_LENGTHS[band]:
        used, chunk = rank_rows(length, plan.n, plan.min_rows)
        assert used <= plan.n and chunk <= plan.chunk_max
        ref = decode_attention_plain(q.double(), k.double(), v.double(), length)
        got = _k2_model(q, k, v, length, used, chunk,
                        stage_rows=FLASH_STAGE_ROWS["bf16"] if kernel == "K1" else None)
        assert _rel_err(got.double(), ref) <= 1e-6, length


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("band", list(BAND_LENGTHS))
def test_band_plan_model_with_held_out_row_matches_split_plain(band, storage):
    """The same over a quantized cache: ``pos = length - 1`` cache rows (pos 0
    included) plus the held-out row, in stages of 128 rows past 256."""
    S = 2048
    rng = np.random.default_rng(300 + band[0])
    q, k, v = _qkv(rng, 2, 16, 4, S)
    k_new, v_new = (torch.from_numpy(rng.normal(size=(2, 1, 4, 128)).astype(np.float32))
                    for _ in range(2))
    scales = (None, None)
    if storage == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(2, 4, S, 128)).astype(np.int8))
                for _ in range(2))
        scales = tuple(torch.from_numpy((rng.random((2, 4, S)) * 0.02 + 0.005)
                                        .astype(np.float32)) for _ in range(2))
    kernel = Band(*band).kernel
    plan = band_plan(kernel, Band(*band), 8, S, True, SMS)
    for length in BAND_LENGTHS[band]:
        pos = length - 1
        used, chunk = rank_rows(pos, plan.n, plan.min_rows)
        ref = decode_attention_split_plain(q.double(), k, v, k_new.double(), v_new.double(), pos,
                                           *(t if t is None else t.double() for t in scales))
        got = _k2_model(q, k, v, pos, used, chunk, k_new, v_new, *scales,
                        stage_rows=128 if kernel == "K1" else None)
        assert _rel_err(got.double(), ref) <= 1e-6, pos


@pytest.mark.parametrize("storage", ["bf16", "f8"])  # the stage each cache's K1 walks
@pytest.mark.parametrize("bh_kv_scale", [1, 64])  # the plans of batch 1 and batch 64 (CFG)
@pytest.mark.parametrize("length", [257, 1000, 2000, 4095])
def test_k1_model_matches_plain(length, bh_kv_scale, storage):
    rng = np.random.default_rng(length + bh_kv_scale)
    q, k, v = _qkv(rng, 2, 16, 4, 4096)
    ref = decode_attention_plain(q.double(), k.double(), v.double(), length)
    _, n, chunk = _split("K1", length, 8 * bh_kv_scale)
    got = _k2_model(q, k, v, length, n, chunk, stage_rows=FLASH_STAGE_ROWS[storage])
    assert _rel_err(got.double(), ref) <= 1e-6


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("pos", [256, 999, 1999, 4095])
def test_k1_model_with_held_out_row_matches_split_plain(pos, storage):
    """Rank 0's held-out start and stages of 128 rows (an f8 or int8 cache's),
    against the plain split version in float64, at the plans of batch 1 and
    batch 64 (CFG)."""
    rng = np.random.default_rng(200 + pos)
    S = 4096
    q, k, v = _qkv(rng, 2, 16, 4, S)
    k_new, v_new = (torch.from_numpy(rng.normal(size=(2, 1, 4, 128)).astype(np.float32))
                    for _ in range(2))
    scales = (None, None)
    if storage == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(2, 4, S, 128)).astype(np.int8))
                for _ in range(2))
        scales = tuple(torch.from_numpy((rng.random((2, 4, S)) * 0.02 + 0.005)
                                        .astype(np.float32)) for _ in range(2))
    ref = decode_attention_split_plain(q.double(), k, v, k_new.double(), v_new.double(), pos,
                                       *(t if t is None else t.double() for t in scales))
    for bh_kv in (8, 512):
        _, n, chunk = _split("K1", pos, bh_kv, held_out=True)
        got = _k2_model(q, k, v, pos, n, chunk, k_new, v_new, *scales, stage_rows=128)
        assert _rel_err(got.double(), ref) <= 1e-6


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("length", [257, 1000, 2000, 4095])
def test_k1_model_matches_jax(length, G):
    rng = np.random.default_rng(11 * length + G)
    q, k, v = _qkv(rng, 1, 4 * G, 4, 4096)
    ref = jax_decode_attention(q.numpy(), k.numpy(), v.numpy(), jnp.int32(length))
    _, n, chunk = _split("K1", length, 4)
    got = _k2_model(q, k, v, length, n, chunk, stage_rows=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

DAC_UNITS_86 = [(768, 688), (384, 5504), (192, 22016), (96, 44032)]  # (C, T) at 86 frames


def _tile_threads(tile: int) -> tuple[int, int, int]:
    """(threads along time, along channels, time steps a thread) of a tile:
    csrc/snake_conv.cu runs RT = 8 time steps a thread at 128 rows, 4 below."""
    tt, tc = TILES[tile]
    rt = 8 if tt == 128 else 4
    return tt // rt, tc // 8, rt


def _tile_outputs(tile: int, T: int, C_out: int, batch: int = 1) -> np.ndarray:
    """How often the kernel's grid and thread maps write each output
    (csrc/snake_conv.cu: CTA (bx, by, b) at t0 = bx * TT, co0 = by * TC;
    thread (ty, tx) at times t0 + ty*4 + g*4*kTY + i, channels co0 + tx*4 +
    h*TC/2 + e, masked at T and C_out)."""
    tt, tc = TILES[tile]
    kty, ktx, rt = _tile_threads(tile)
    seen = np.zeros((batch, T, C_out), np.int64)
    ty, tx = np.meshgrid(np.arange(kty), np.arange(ktx), indexing="ij")
    for b, bx, by in itertools.product(range(batch), range(-(-T // tt)), range(-(-C_out // tc))):
        for g, i, h, e in itertools.product(range(rt // 4), range(4), range(2), range(4)):
            t = bx * tt + ty * 4 + g * 4 * kty + i
            co = by * tc + tx * 4 + h * (tc // 2) + e
            ok = (t < T) & (co < C_out)
            np.add.at(seen, (b, t[ok], co[ok]), 1)
    return seen


@pytest.mark.parametrize("tile", range(len(TILES)))
@pytest.mark.parametrize("T,C_out,batch", [(300, 200, 1), (688, 96, 2), (33, 100, 1)])
def test_conv_tiles_cover_every_output_once(tile, T, C_out, batch):
    assert (_tile_outputs(tile, T, C_out, batch) == 1).all()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("C,T", DAC_UNITS_86)
def test_conv_plan_at_every_dac_width(C, T, batch):
    """At 86 frames no column tile is masked (96 divides every width) and the
    plan takes the tile the card measured fastest (``chip_smoke.py --sweep``):
    64 x 96 at (768, 688), where 88 CTAs leave SMs idle but a wave of 32 x 96
    tiles was slower, and 128 x 96 elsewhere and at batch 2 but for (768, 688)."""
    for k, dil in ((7, 1), (7, 3), (7, 9), (1, 1)):
        tt, tc = TILES[conv_plan(T, C, C, k, dil, SMS, batch)]
        assert C % tc == 0
        assert (tt, tc) == ((64, 96) if (C, batch) == (768, 1) else (128, 96))


def _snake_np(v, a):
    return v + np.sin(a * v) ** 2 / (a + 1e-9)


def _k5_model(x, alpha, w, b, dilation, residual=None, tile=0):
    """K5's tiling in fp32 numpy: CTA tiles of TILES[tile]; for each chunk of
    ``ci_chunk(k)`` input channels the raw window of TT + (k-1) * dilation rows from t0 - pad,
    zero outside [0, T) and past C_in, the snake applied to it, then tap j's
    product of the window shifted by j * dilation with the chunk's weight
    slice; bias and residual in the epilogue, masked stores.  x [B, T, C_in],
    w [C_out, C_in, k] (torch's layout) -> [B, T, C_out]."""
    x, alpha, w, b = (t.numpy() for t in (x, alpha, w, b))
    B, T, C_in = x.shape
    C_out, _, k = w.shape
    w_kio = np.transpose(w, (2, 1, 0))  # [k, C_in, C_out], as the kernel reads it
    tt, tc = TILES[tile]
    pad, rows, ci = (k - 1) * dilation // 2, tt + (k - 1) * dilation, ci_chunk(k)
    y = np.zeros((B, T, C_out), np.float32)
    for bi, t0, co0 in itertools.product(range(B), range(0, T, tt), range(0, C_out, tc)):
        acc = np.zeros((tt, tc), np.float32)
        for ci0 in range(0, C_in, ci):
            win = np.zeros((rows, ci), np.float32)
            t = t0 - pad + np.arange(rows)
            ok = (t >= 0) & (t < T)
            cs = min(ci, C_in - ci0)
            win[ok, :cs] = x[bi, t[ok], ci0:ci0 + cs]
            win[:, :cs] = _snake_np(win[:, :cs], alpha[ci0:ci0 + cs]).astype(np.float32)
            ws = np.zeros((k, ci, tc), np.float32)
            co = min(tc, C_out - co0)
            ws[:, :cs, :co] = w_kio[:, ci0:ci0 + cs, co0:co0 + co]
            for j in range(k):
                acc += win[j * dilation:j * dilation + tt] @ ws[j]
        t_n, c_n = min(tt, T - t0), min(tc, C_out - co0)
        y[bi, t0:t0 + t_n, co0:co0 + c_n] = acc[:t_n, :c_n] + b[co0:co0 + c_n]
    if residual is not None:
        y += residual.numpy()
    return torch.from_numpy(y)


def _conv_inputs(rng, B, T, C_in, C_out, k):
    return (torch.from_numpy(rng.normal(size=(B, T, C_in)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 1.5, size=(C_in,)).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(C_out, C_in, k)) * 0.1).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(C_out,)) * 0.1).astype(np.float32)))


@pytest.mark.parametrize("tile", range(len(TILES)))
@pytest.mark.parametrize("k,dilation", [(7, 1), (7, 3), (7, 9), (1, 1)])
def test_k5_model_matches_plain(k, dilation, tile):
    """Widths and a length that are not multiples of any tile or chunk: C_in
    20 (two and a half chunks), C_out 100 (a part-filled column tile), T 150,
    batch 2, with and without the residual."""
    rng = np.random.default_rng(10 * k + dilation + 100 * tile)
    x, alpha, w, b = _conv_inputs(rng, 2, 150, 20, 100, k)
    res = torch.from_numpy(rng.normal(size=(2, 150, 100)).astype(np.float32))
    for residual in (None, res):
        ref = snake_conv1d_plain(x, alpha, w, b, dilation, residual)
        got = _k5_model(x, alpha, w, b, dilation, residual, tile)
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_k5_model_residual_unit_matches_jax(dilation):
    """Two model launches, the residual added in the second's epilogue, as
    snake_residual_unit runs them, against JAX's DAC residual unit at C 20, T
    150 (JAX's conv layout [k, C_in, C_out])."""
    rng = np.random.default_rng(dilation)
    C, T = 20, 150
    x = rng.normal(size=(1, T, C)).astype(np.float32)
    p = {"alpha1": rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32),
         "conv1": {"w": (rng.normal(size=(7, C, C)) * 0.1).astype(np.float32),
                   "b": (rng.normal(size=(C,)) * 0.1).astype(np.float32)},
         "alpha2": rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32),
         "conv2": {"w": (rng.normal(size=(1, C, C)) * 0.1).astype(np.float32),
                   "b": (rng.normal(size=(C,)) * 0.1).astype(np.float32)}}
    ref = np.array(jax_res_unit(p, x, dilation))

    def conv(name):
        return (torch.from_numpy(np.ascontiguousarray(np.transpose(p[name]["w"], (2, 1, 0)))),
                torch.from_numpy(p[name]["b"]))

    xt = torch.from_numpy(x)
    tile = conv_plan(T, C, C, 7, dilation, SMS)
    y = _k5_model(xt, torch.from_numpy(p["alpha1"]), *conv("conv1"), dilation, tile=tile)
    got = _k5_model(y, torch.from_numpy(p["alpha2"]), *conv("conv2"), 1, residual=xt, tile=tile)
    assert _rel_err(got, torch.from_numpy(ref)) <= 1e-5


# ---------------------------------------------------------------------------
# the first CPU exp of a process (the port's plain versions run on it)
# ---------------------------------------------------------------------------


_FIRST_EXP = textwrap.dedent("""
    import numpy as np, torch
    {imports}
    x = -torch.from_numpy(np.random.default_rng(0).random(200_000).astype(np.float32)) * 10
    first, again = torch.exp(x), torch.exp(x)
    print(int(torch.equal(first, again)))
""")


def _first_exp_is_exact(imports: str) -> bool:
    """Whether a fresh process's first CPU exp equals its second."""
    out = subprocess.run([sys.executable, "-c", _FIRST_EXP.format(imports=imports)],
                         capture_output=True, text=True, timeout=300, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    return out.stdout.strip().splitlines()[-1] == "1"


def test_first_cpu_exp_after_importing_the_port_is_exact(record_property):
    """torch's CPU exp can be off by ~1e-4 in part of its first multi-threaded
    call of a process; importing the port makes that first call itself, so
    the next is already exact (in a fresh process, each time).  Without the
    import, how often the first call still differs is measured and recorded
    (``first_exp_differs_without_the_port``, not held to anything): once it
    stays 0 across torch releases, the import's call can go."""
    for _ in range(3):
        assert _first_exp_is_exact("import zonos_tpu_torch")
    differs = sum(not _first_exp_is_exact("") for _ in range(3))
    record_property("first_exp_differs_without_the_port", f"{differs}/3")
    print(f"first CPU exp differed from the second in {differs} of 3 fresh processes "
          f"without the port (torch {torch.__version__})")
