"""A request's rows give the same bits alone and in a batch on the card:
the plans of the port's products and attention kernels on the CPU.

G1 (``kernels/gemm.py``: every bf16 and int8 ``matmul_w`` on the card), K1/K2
(``band_plan``), K4 (``tail_plan``) and K8 (``int4_plan``) fix the order of a
row's sums from the widths and the card's SM count alone: the plans are held
here for every row count or (batch row, kv head) count tried at each
flagship shape.  A numpy model of G1's splits and k-steps matches its plain
version within 2 bf16 ulps and gives a row the same bits alone and among
127 others; the int4 chunking routes each row of 128 as its own 2-row call;
``matmul_w`` on the CPU is what it always was.  The card-side checks (each
kernel against its plain version, a row alone against in a batch of 64, bit
for bit) are the ``cuda``-marked tests in ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``'s ``[cobatch]``.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from zonos_tpu_torch.kernels import gemm as g1
from zonos_tpu_torch.kernels import int4_matmul as k8
from zonos_tpu_torch.kernels import layer_tail as k4
from zonos_tpu_torch.kernels.decode_attention import BANDS, Band, band_plan, rank_rows
from zonos_tpu_torch.ops import quant
from zonos_tpu_torch.ops.quant import (
    int4_matmul_unpacked,
    matmul_w,
    quantize_weight_int4,
    quantize_weight_int8,
)

SMS = 132  # an H100 SXM
ROWS = (1, 2, 8, 128, 9088)  # row counts (and kv pairs) tried: batch 1 to a batch-64 prefill
# [din, dout] of every weight matmul_w gives G1 on the flagships (the heads: 9 x 1152 columns)
WEIGHTS = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w1": (2048, 16384), "w2": (8192, 2048),
           "heads": (2048, 10368), "in_proj": (2048, 8512), "out_proj": (4096, 2048)}


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 rounded to the nearest bf16 (ties to even), as fp32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.view(np.float32)


def _ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_gemm_order_does_not_depend_on_the_rows(name):
    """G1's splits (what fixes a row's sums) are the same at every row
    count, at most a portable cluster of 8; only the row tile (one or two
    consumer warpgroups) and how the splits run (a cluster's CTAs or in
    turn) change, and each split holds whole ring stages, none empty."""
    K, N = WEIGHTS[name]
    plans = [g1.gemm_plan(M, K, N, SMS) for M in ROWS]
    assert len({(p.n_split, p.rows_per_split) for p in plans}) == 1
    p = plans[0]
    assert p.rows_per_split % g1.STAGE_ROWS == 0
    assert (p.n_split - 1) * p.rows_per_split < K <= p.n_split * p.rows_per_split
    assert p.n_split <= g1.MAX_SPLITS
    assert "M" not in inspect.signature(g1.split_count).parameters
    assert [q.bm for q in plans] == [64, 64, 64, 128, 128]
    assert g1.gemm_plan(142, K, N, SMS).bm == 64  # 3 tiles of 64 rows, not 2 of 128
    assert not plans[-1].parallel  # a prefill's tiles fill the card: the splits in turn


@pytest.mark.parametrize("held_out", [False, True])
@pytest.mark.parametrize("band", BANDS)
def test_attention_plan_does_not_depend_on_the_batch(band, held_out):
    """K1's and K2's plan over each band, and so every row's split of its
    cache rows, is the same at every number of (batch row, kv head) pairs."""
    band = Band(*band)
    S = 4096
    plans = [band_plan(band.kernel, band, bh_kv, S, held_out, SMS) for bh_kv in ROWS]
    assert len({p.split for p in plans}) == 1
    assert all(p.n % p.grid == 0 for p in plans)  # each CTA runs a whole number of ranks
    plan = plans[0]
    for length in (max(band.lo - held_out, 0), 300, 2000):
        if plan.lo <= length <= plan.hi:
            used, chunk = rank_rows(length, plan.n, plan.min_rows)
            assert used <= plan.n and chunk <= plan.chunk_max


def test_attention_plans_at_the_flagship_shapes():
    """K2: 8 ranks over lengths up to 256; K1: 8 up to 512 rows and 16
    beyond; at batch 1 and at batch 64 with CFG alike.  Batch 1's pairs get
    one CTA a rank, batch 64's one CTA a pair."""
    for bh_kv, per_rank in ((8, True), (512, False)):
        for kernel, band, n in (("K2", Band(1, 256), 8), ("K1", Band(257, 512), 8),
                                ("K1", Band(513, None), 16)):
            plan = band_plan(kernel, band, bh_kv, 2048, False, SMS)
            assert plan.n == n and plan.grid == (n if per_rank else 1)


@pytest.mark.parametrize("dk,d,inter", [(2048, 2048, 8192), (256, 256, 512)])
def test_layer_tail_splits_do_not_depend_on_the_rows(dk, d, inter):
    """K4's three passes split their contractions alike at every row count;
    only the row tiles and the partials' size follow the rows."""
    plans = [k4.tail_plan(B2, dk, d, inter, SMS) for B2 in ROWS]
    assert len({p["splits"] for p in plans}) == 1
    assert [p["row_tiles"] for p in plans] == [-(-B2 // k4.MAX_ROWS) for B2 in ROWS]
    for B2, p in zip(ROWS, plans):
        for n, (N, halves) in zip(p["splits"], ((d, 1), (inter, 2), (d, 1))):
            assert n * min(B2, k4.MAX_ROWS) * k4.TILE * halves * 4 <= k4.MAX_SUM_BYTES or n == 1


@pytest.mark.parametrize("name", ["wqkv", "wo", "w1", "w2", "heads", "in_proj", "out_proj"])
def test_int4_order_does_not_depend_on_the_rows(name):
    """K8's splits, chunks and warp slices are the same for 1 to 64 rows;
    more rows take narrower column tiles only."""
    din, dout = WEIGHTS[name]
    plans = [k8.int4_plan(M, din, dout, SMS) for M in (1, 2, 8, 16, 17, 32, 33, 64)]
    fixed = {(p["n_split"], p["rows_per_split"], p["chunk_rows"], p["slices"]) for p in plans}
    assert len(fixed) == 1
    assert [p["tile"] for p in plans] == [128, 128, 128, 128, 64, 64, 32, 32]


# ---------------------------------------------------------------------------
# G1's order, modelled
# ---------------------------------------------------------------------------


def _gemm_model(x: np.ndarray, w: np.ndarray, plan: g1.GemmPlan) -> np.ndarray:
    """G1's arithmetic in numpy: per split, the wgmma k-steps of 16 in
    increasing k into an fp32 accumulator from 0 (each step's 16 products
    summed in fp32; the tensor cores' order inside a step is not modelled),
    the splits added in order into a total from 0 (in turn in one CTA, or by
    a cluster rank reading each split's partial in split order: the same
    adds), rounded to bf16 once.  Every row is computed on its own (an
    elementwise reduction over the k axis)."""
    M, K = x.shape
    total = np.zeros((M, w.shape[1]), np.float32)
    for s in range(plan.n_split):
        k0, k1 = s * plan.rows_per_split, min(K, (s + 1) * plan.rows_per_split)
        acc = np.zeros_like(total)
        for k in range(k0, k1, 16):
            acc = acc + (x[:, k:k + 16, None] * w[None, k:k + 16, :]).sum(axis=1,
                                                                           dtype=np.float32)
        total = total + acc
    return _bf16(total)


@pytest.mark.parametrize("K,N", [(512, 48), (1024, 32), (768, 16)])
def test_gemm_model_matches_plain_and_keeps_a_row_alone(K, N):
    """The model of G1's order (splits from ``gemm_plan`` at a card of 8 SMs,
    so that narrow weights still split) within 2 bf16 ulps of max|ref| of
    the plain version, and a pair of rows alone the same bits as inside 128
    rows."""
    rng = np.random.default_rng(K + N)
    x = _bf16(rng.normal(size=(128, K)).astype(np.float32))
    w = _bf16((rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32))
    plan = g1.gemm_plan(128, K, N, 8)
    assert plan.n_split > 1
    got = _gemm_model(x, w, plan)
    ref = g1.gemm_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()).float()
    top = float(ref.abs().max())
    assert float((torch.from_numpy(got) - ref).abs().max()) <= 2 * _ulp(top)
    alone = _gemm_model(x[[5, 70]], w, g1.gemm_plan(2, K, N, 8))
    np.testing.assert_array_equal(alone.view(np.uint32), got[[5, 70]].view(np.uint32))


def test_gemm_plain_int8_is_the_scaled_product():
    """The int8 plain version: the product by the integers rounded to bf16,
    then times the bf16 scales in bf16, as JAX's ``(x @ q) * s``."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).bfloat16()
    w = quantize_weight_int8(torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)))
    got = g1.gemm_plain(x, w["q"], w["s"])
    want = (x.float() @ w["q"].float()).bfloat16() * w["s"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("rows,K,N,dtypes,takes", [
    (2, 2048, 3072, (torch.bfloat16, torch.bfloat16, None), True),
    (9088, 8192, 2048, (torch.bfloat16, torch.int8, torch.bfloat16), True),
    (2, 64, 48, (torch.float32, torch.float32, None), False),  # the fp32 test models
    (2, 72, 48, (torch.bfloat16, torch.bfloat16, None), False),  # K not a multiple of 16
    (2, 64, 40, (torch.bfloat16, torch.bfloat16, None), False),  # N not a multiple of 16
    (2, 64, 48, (torch.bfloat16, torch.int8, None), False),  # int8 without scales
])
def test_gemm_takes_by_dtype_and_shape(rows, K, N, dtypes, takes):
    assert g1.kernel_takes(rows, K, N, *dtypes) is takes


# ---------------------------------------------------------------------------
# the int4 route and matmul_w on the CPU
# ---------------------------------------------------------------------------


def test_int4_chunks_route_every_row_as_its_own_call(monkeypatch):
    """``int4_rows`` gives K8 at most 64 rows a launch; under K8's plain
    version each row of 128 gets what its own 2-row call gives it."""
    calls = []

    def k8_rowwise(x, q, s):  # K8's plain version, one row at a time: a row-wise order
        calls.append(x.shape[0])
        return torch.cat([k8.int4_matmul_plain(x[i:i + 1], q, s) for i in range(x.shape[0])])

    monkeypatch.setattr(quant, "int4_matmul", k8_rowwise)
    rng = np.random.default_rng(4)
    w = quantize_weight_int4(torch.from_numpy((rng.normal(size=(256, 64)) / 16)
                                              .astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32)).bfloat16()
    out = quant.int4_rows(x, w["q4"], w["s4"])
    assert calls == [64, 64]
    for r in (0, 63, 64, 127):
        pair = [r, (r + 1) % 128]
        assert torch.equal(quant.int4_rows(x[pair], w["q4"], w["s4"]), out[pair])
    assert calls[-1] == 2


def _old_matmul_w(x, w):
    """``matmul_w`` on the CPU as it was before G1: the expression held."""
    if isinstance(w, dict) and "q4" in w:
        return int4_matmul_unpacked(x, w["q4"], w["s4"])
    if isinstance(w, dict) and "q" in w:
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_matmul_w_on_the_cpu_is_unchanged(kind, dtype):
    rng = np.random.default_rng(7)
    wf = torch.from_numpy((rng.normal(size=(256, 96)) / 16).astype(np.float32))
    w = {"plain": lambda: wf.to(dtype), "int8": lambda: quantize_weight_int8(wf),
         "int4": lambda: quantize_weight_int4(wf)}[kind]()
    x = torch.from_numpy(rng.normal(size=(2, 5, 256)).astype(np.float32)).to(dtype)
    got, want = matmul_w(x, w), _old_matmul_w(x, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
