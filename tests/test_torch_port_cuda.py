"""The port's CUDA kernels against their plain versions, and the decode
step's CUDA graphs against the eager loop, on the card.

Marked ``cuda``; each test skips (from its fixture) where no card is
present.  On a machine with one: ``python -m pytest -m cuda
tests/test_torch_port_cuda.py``.  ``chip_smoke.py`` runs the same checks at
the flagship shapes.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _k3_cases as k3_cases  # tests/, on sys.path under pytest
import _k6_plans as k6_plans
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels.decode_attention import (
    decode_attention_plain,
    decode_attention_single,
    decode_attention_single_held_out,
    decode_attention_split_plain,
    flash_decode_attention,
    flash_decode_attention_held_out,
)
from zonos_tpu_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain
from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail, fused_layer_tail_plain
from zonos_tpu_torch.kernels.sampling import (
    fused_sample,
    fused_sample_plain,
    fused_sample_scores_plain,
)
from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain
from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain
from zonos_tpu_torch.kernels.ssm_state import (
    dequantize_state,
    fused_state_step,
    fused_state_step_plain,
    quantize_state,
    storage_ulp,
)
from zonos_tpu_torch.models.backbone import quantize_kv_rows
from zonos_tpu_torch.ops.quant import quantize_weight_int4, quantize_weight_int8
from zonos_tpu_torch.ops.sampling import gumbel_of_uniform

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("length", [1, 300, 640])
def test_decode_attention_kernels_match_plain(gen, length):
    q = torch.randn((2, 1, 16, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 4, 640, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 4, 640, 128), generator=gen, device="cuda").bfloat16()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
    tol = 2 * 2.0 ** (int(torch.floor(torch.log2(ref.abs().max()))) - 7)  # 2 bf16 ulps
    before = dict(launch_counts)
    for fn in (flash_decode_attention, decode_attention_single):
        assert (fn(q, k, v, length).float() - ref).abs().max() <= tol
    assert launch_counts["flash_decode_attention"] == before["flash_decode_attention"] + 1
    assert launch_counts["decode_attention_single"] == before["decode_attention_single"] + 1


def test_decode_attention_kernel_rejects_fp32(gen):
    q = torch.randn((1, 1, 16, 128), generator=gen, device="cuda")
    k = torch.randn((1, 4, 64, 128), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        flash_decode_attention(q, k, k, 10)


@pytest.mark.parametrize("min_p", [0.0, 0.1])
def test_fused_sample_kernel_matches_plain(gen, min_p):
    logits = torch.randn((4, 9, 1152), generator=gen, device="cuda") * 3
    logits[..., 1025:] = float("-inf")
    noise = gumbel_of_uniform(torch.rand((4, 9, 1152), generator=gen, device="cuda"))
    kw = dict(linear=0.55, conf=0.4, quad=0.0, min_p=min_p)
    assert torch.equal(fused_sample(logits, noise, **kw), fused_sample_plain(logits, noise, **kw))


def _k3_operands(seed, B, V):
    """``tests/_k3_cases.py``'s logits and noise [B, 9, V] on the card, and
    the rows whose id is known (EOS mode; a tie the lowest index wins)."""
    logits, noise, known = k3_cases.operands(seed, B, V)
    return torch.from_numpy(logits).cuda(), torch.from_numpy(noise).cuda(), known


@pytest.mark.parametrize("point", list(k3_cases.POINTS))
@pytest.mark.parametrize("V", [1025, 1152, 2048, 2049, 12288])
@pytest.mark.parametrize("B", [1, 4, 64])
def test_fused_sample_routes_match_plain(gen, B, V, point):
    """Both of K3's routes (the warp route up to 1152 entries, the CTA route
    past it) at every branch: ids equal to the plain version's except where
    its top two scores lie within 1e-4; the EOS-mode and tied rows exact."""
    logits, noise, known = _k3_operands(B * V, B, V)
    kw = k3_cases.POINTS[point]
    scores = fused_sample_scores_plain(logits, noise, **kw)
    top2 = scores.topk(2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) < k3_cases.NEAR_TIE
    before = launch_counts["fused_sample"]
    got = fused_sample(logits, noise, **kw)
    assert launch_counts["fused_sample"] == before + 1
    assert not bool(((got != scores.argmax(-1)) & ~near_tie).any())
    for (b, k), want in known.items() if kw["conf"] >= 0 else ():
        assert int(got[b, k]) == want


@pytest.mark.parametrize("V", [1025, 1152, 2048, 12288])
def test_fused_sample_row_alone_equals_row_in_batch(gen, V):
    """A row's ids alone, at batch 4 and inside batch 64 are equal bit for bit
    (the plan's lane map and sums depend on V alone)."""
    logits, noise, _ = _k3_operands(V, 64, V)
    kw = k3_cases.DEFAULT
    ids = fused_sample(logits, noise, **kw)
    for b in (0, 37, 60):
        assert torch.equal(fused_sample(logits[b:b + 1], noise[b:b + 1], **kw)[0], ids[b])
        assert torch.equal(fused_sample(logits[b:b + 4], noise[b:b + 4], **kw), ids[b:b + 4])


@pytest.mark.parametrize("V", [1024, 1152])
def test_fused_sample_unaligned_rows_give_the_same_ids(gen, V):
    """Rows 4 bytes off 16-byte alignment take the warp route's 4-byte loads of
    the same lane map: the same ids bit for bit."""
    logits, noise, _ = _k3_operands(V, 4, V)
    n = logits.numel()
    buf = torch.empty(2 * n + 1, device="cuda")
    lg, nz = buf[1:n + 1].view(logits.shape), buf[n + 1:].view(logits.shape)
    lg.copy_(logits)
    nz.copy_(noise)
    assert lg.data_ptr() % 16 == 4
    for kw in k3_cases.POINTS.values():
        assert torch.equal(fused_sample(lg, nz, **kw), fused_sample(logits, noise, **kw))


@pytest.mark.parametrize("k,dilation", [(7, 9), (1, 1)])
def test_snake_conv_kernel_matches_plain(gen, k, dilation):
    x = torch.randn((2, 300, 96), generator=gen, device="cuda")
    alpha = 0.5 + torch.rand((96,), generator=gen, device="cuda")
    w = torch.randn((80, 96, k), generator=gen, device="cuda") * 0.05
    b = torch.randn((80,), generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the fp32 reference really in fp32
    try:
        ref = snake_conv1d_plain(x, alpha, w, b, dilation)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got = snake_conv1d(x, alpha, w, b, dilation)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def _fp32_plain(fn, *args):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the fp32 reference really in fp32
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# every DAC width at a T that is a multiple of no tile (and at 86 frames for 768), batch 1
# and 2
K5_SHAPES = [(768, 688, 1), (768, 1001, 2), (384, 1001, 2), (192, 700, 2), (96, 1001, 1)]


@pytest.mark.parametrize("tile", [0, 1, 2])
@pytest.mark.parametrize("k,dilation", [(7, 1), (7, 3), (7, 9), (1, 1)])
@pytest.mark.parametrize("C,T,B", K5_SHAPES)
def test_snake_conv_tiles_match_plain(gen, C, T, B, k, dilation, tile):
    """Each of K5's tiles (launched through the C entry point, whatever the
    plan would pick) with and without the residual; tolerance 1e-4 x
    max|ref|."""
    from zonos_tpu_torch.kernels import snake_conv as k5
    from zonos_tpu_torch.kernels._build import check, library

    x = torch.randn((B, T, C), generator=gen, device="cuda")
    alpha = 0.5 + torch.rand((C,), generator=gen, device="cuda")
    w = torch.randn((C, C, k), generator=gen, device="cuda") * 0.02
    b = torch.randn((C,), generator=gen, device="cuda")
    w_kio = w.permute(2, 1, 0).contiguous()
    for res in (None, x):
        ref = _fp32_plain(snake_conv1d_plain, x, alpha, w, b, dilation, res)
        got = torch.empty_like(ref)
        check(library("snake_conv", k5._SIGNATURES).zt_snake_conv1d(
            x.data_ptr(), alpha.data_ptr(), w_kio.data_ptr(), b.data_ptr(),
            res.data_ptr() if res is not None else None, got.data_ptr(), B, T, C, C, k,
            dilation, tile, torch.cuda.current_stream().cuda_stream), "snake_conv1d")
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("C,T,B", K5_SHAPES)
def test_snake_residual_unit_kernel_matches_plain(gen, C, T, B, dilation):
    """The residual unit through the wrapper (two launches, the tile of
    ``conv_plan``); tolerance 1e-4 x max|ref|."""
    from zonos_tpu_torch.kernels.snake_conv import snake_residual_unit

    def conv(k):
        return {"w": torch.randn((C, C, k), generator=gen, device="cuda") * 0.02,
                "b": torch.randn((C,), generator=gen, device="cuda") * 0.01}

    p = {"alpha1": 0.5 + torch.rand((C,), generator=gen, device="cuda"), "conv1": conv(7),
         "alpha2": 0.5 + torch.rand((C,), generator=gen, device="cuda"), "conv2": conv(1)}
    x = torch.randn((B, T, C), generator=gen, device="cuda")

    def plain():
        y = snake_conv1d_plain(x, p["alpha1"], p["conv1"]["w"], p["conv1"]["b"], dilation)
        return snake_conv1d_plain(y, p["alpha2"], p["conv2"]["w"], p["conv2"]["b"], 1, x)

    ref = _fp32_plain(plain)
    before = launch_counts["snake_conv1d"]
    got = snake_residual_unit(p, x, dilation)
    assert launch_counts["snake_conv1d"] == before + 2
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def _ssd_inputs(gen, B, L, H, G, P, N):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (rnd(B, L, H, P), rnd(B, L, H).abs() * 0.5, -rnd(H).abs(), rnd(B, L, G, N),
            rnd(B, L, G, N), rnd(H), rnd(B, H, P, N))


def _ssd_matches_plain(gen, B, L, H, G, P, N):
    x, dt, A, Bm, Cm, D, init = _ssd_inputs(gen, B, L, H, G, P, N)
    before = launch_counts["ssd_chunked"]
    for state in (init, None):
        ref_y, ref_s = ssd_chunked_plain(x, dt, A, Bm, Cm, D, state)
        y, s = ssd_chunked(x, dt, A, Bm, Cm, D, state)
        assert (y - ref_y).abs().max() <= 1e-4 * ref_y.abs().max()
        assert (s - ref_s).abs().max() <= 1e-4 * ref_s.abs().max()
    assert launch_counts["ssd_chunked"] == before + 2


# L 1 to 150 at the flagship P and N (sub-chunk, a chunk less one, one or two rows past a
# chunk); two groups at widths that are not tile multiples (P 16 / N 16, P 20 / N 12)
@pytest.mark.parametrize("L,G,P,N", [(37, 1, 64, 128), (150, 1, 64, 128), (70, 2, 16, 16),
                                     (1, 1, 64, 128), (63, 1, 64, 128), (65, 1, 64, 128),
                                     (129, 1, 64, 128), (129, 2, 16, 16), (70, 2, 20, 12),
                                     (129, 2, 20, 12)])
def test_ssd_chunked_kernel_matches_plain(gen, L, G, P, N):
    _ssd_matches_plain(gen, 2, L, 4, G, P, N)


@pytest.mark.parametrize("L", [69, 150])
def test_ssd_chunked_kernel_matches_plain_at_batch_16(gen, L):
    """The flagship widths (64 heads) at 16 rows: the batch-8 prefill with CFG."""
    _ssd_matches_plain(gen, 16, L, 64, 1, 64, 128)


@pytest.mark.parametrize("L", [55, 150])
def test_ssd_chunked_row_alone_equals_row_in_batch(gen, L):
    """A row's y and final state alone, at batch 2 and inside batch 16 are
    equal bit for bit (the plan depends on the widths alone)."""
    x, dt, A, Bm, Cm, D, init = _ssd_inputs(gen, 16, L, 64, 1, 64, 128)

    def rows(t, r, n):
        return None if t is None else t[r:r + n].contiguous()

    for state in (init, None):
        y16, s16 = ssd_chunked(x, dt, A, Bm, Cm, D, state)
        for r in (0, 5, 14):
            for n in (1, 2):
                y, s = ssd_chunked(rows(x, r, n), rows(dt, r, n), A, rows(Bm, r, n),
                                   rows(Cm, r, n), D, rows(state, r, n))
                assert torch.equal(y, y16[r:r + n]) and torch.equal(s, s16[r:r + n])


@pytest.mark.parametrize("H,G,P,N", [(64, 1, 64, 128), (8, 2, 20, 12), (4, 2, 16, 16),
                                     (24, 8, 36, 100)])
def test_ssd_plan_fits_the_card(gen, H, G, P, N):
    """Every plan at these widths: the kernel refuses it where the CPU copy of its
    checks (``tests/_k6_plans.py``) does, else its shared memory is the copy's and
    the card holds at least one of its clusters; the default plan is one it takes."""
    import ctypes
    import itertools

    from zonos_tpu_torch.kernels import ssd as k6

    lib = k6._library(0)
    assert k6.ssd_plan(2, 64, H, G, P, N, 132) in k6_plans.plans(H, G, P, N)
    for groups, cluster in itertools.product((1, 2, 4, 8), (1, 2, 4, 8, 16)):
        plan = k6.SsdPlan(groups, cluster)
        if k6_plans.refusal(H, G, P, N, plan) is not None:
            assert lib.zt_ssd_chunked_smem(H, G, P, N, groups, cluster) == -1
            continue
        smem = lib.zt_ssd_chunked_smem(H, G, P, N, groups, cluster)
        assert smem == k6_plans.smem_bytes(P, N, plan)
        fit = ctypes.c_int(0)
        assert lib.zt_ssd_chunked_max_active_clusters(H, G, P, N, groups, cluster,
                                                      ctypes.byref(fit)) == 0
        assert fit.value >= 1, plan


def test_ssd_chunked_kernel_rejects_bf16(gen):
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(gen, 1, 64, 4, 1, 64, 128)
    with pytest.raises(TypeError):
        ssd_chunked(x.bfloat16(), dt, A, Bm, Cm, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_fused_state_step_kernel_matches_plain(gen, dtype):
    BH, P, N = 24, 64, 128
    state = (torch.randn((BH, P, N), generator=gen, device="cuda") * 4).to(dtype)
    C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
    dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
    xdt = torch.randn((BH, P), generator=gen, device="cuda")
    xdt[0, 0] = 1e4  # leaves the f8 range: stored as +-448
    ref_state = state.clone()
    ref_y, _ = fused_state_step_plain(ref_state, C, B, dA, xdt)
    y, out = fused_state_step(state, C, B, dA, xdt)
    assert out is state
    assert (y - ref_y).abs().max() <= 1e-5 * ref_y.abs().max()
    assert torch.isfinite(state.float()).all()
    # at most one storage ulp where the fp32 products round differently
    assert ((state.float() - ref_state.float()).abs() <= storage_ulp(ref_state)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("BH,P,N", [(128, 64, 128), (1024, 64, 128), (130, 64, 128),
                                    (128, 50, 128), (128, 64, 64), (65536, 16, 128)])
def test_fused_state_step_slabs_match_plain(gen, BH, P, N, dtype):
    """K7's slab plan at the flagship shapes and off them (a BH and a P that
    end in part-filled grids and slabs; N 64; 65,536 bh rows, batch 512 with
    CFG on the hybrid, past grid.y's limit): y within 1e-5 x max|ref|, every
    stored value within one storage ulp, finite, f8 saturated to +-448."""
    state = (torch.randn((BH, P, N), generator=gen, device="cuda") * 4).to(dtype)
    C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
    dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
    xdt = torch.randn((BH, P), generator=gen, device="cuda")
    xdt[0, 0] = 1e4
    ref_state = state.clone()
    ref_y, _ = fused_state_step_plain(ref_state, C, B, dA, xdt)
    before = launch_counts["fused_state_step"]
    y, _ = fused_state_step(state, C, B, dA, xdt)
    assert launch_counts["fused_state_step"] == before + 1
    assert (y - ref_y).abs().max() <= 1e-5 * ref_y.abs().max()
    assert torch.isfinite(state.float()).all()
    assert ((state.float() - ref_state.float()).abs() <= storage_ulp(ref_state)).all()
    if dtype == torch.float8_e4m3fn:
        assert state.float()[0, 0].abs().max() == 448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_fused_state_step_keeps_a_nan_as_plain_does(gen, dtype):
    """A NaN in xdt makes its state row NaN, stored as NaN (f8: the NaN byte,
    not a saturated value) and read back as NaN by the next step, as the plain
    version does: over two steps the NaNs of y and of the state sit where the
    plain version's do, and the rest agrees as above."""
    BH, P, N = 128, 64, 128
    state = (torch.randn((BH, P, N), generator=gen, device="cuda") * 4).to(dtype)
    ref_state = state.clone()
    for step in range(2):
        C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
        dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
        xdt = torch.randn((BH, P), generator=gen, device="cuda")
        xdt[1, 3] = float("nan")
        ref_y, _ = fused_state_step_plain(ref_state, C, B, dA, xdt)
        y, _ = fused_state_step(state, C, B, dA, xdt)
        assert torch.equal(torch.isnan(y), torch.isnan(ref_y))
        assert bool(torch.isnan(y[1, 3])) == (step == 1)
        ok = ~torch.isnan(ref_y)
        assert (y[ok] - ref_y[ok]).abs().max() <= 1e-5 * ref_y[ok].abs().max()
        nan = torch.isnan(ref_state.float())
        assert nan[1, 3].all() and nan.sum() == N
        assert torch.equal(torch.isnan(state.float()), nan)
        assert ((state.float() - ref_state.float())[~nan].abs()
                <= storage_ulp(ref_state)[~nan]).all()


def test_fused_state_step_kernel_rejects_fp16(gen):
    state = torch.zeros((4, 64, 128), dtype=torch.float16, device="cuda")
    C = torch.zeros((4, 128), device="cuda")
    with pytest.raises(TypeError):
        fused_state_step(state, C, C, torch.ones((4, 1), device="cuda"),
                         torch.zeros((4, 64), device="cuda"))


def _quant_state(gen, BH, P, N, mode):
    spread = 10.0 ** (torch.rand((BH, 1, 1), generator=gen, device="cuda") * 4 - 2)
    q, scale = quantize_state(torch.randn((BH, P, N), generator=gen, device="cuda") * spread,
                              mode)
    C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
    dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
    xdt = torch.randn((BH, P), generator=gen, device="cuda") * spread[:, :, 0]
    return q.contiguous(), C, B, dA, xdt, scale.reshape(BH).contiguous()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("BH,P,N", [(128, 64, 128), (1024, 64, 128), (130, 64, 128),
                                    (128, 50, 128), (128, 64, 64), (128, 64, 256),
                                    (128, 16, 512), (3, 4, 16)])
def test_fused_state_step_quant_matches_plain(gen, mode, BH, P, N):
    """K7 on an int8 or int4 state (one CTA a head) against its plain
    version over three steps: y within 1e-5 x max|ref|, scales within one
    fp32 ulp, stored values within one grid step, at most 1e-3 of the bytes
    apart; the int8 or int4 launch counted, not the float one."""
    q, C, B, dA, xdt, scale = _quant_state(gen, BH, P, N, mode)
    ref_q, ref_scale = q.clone(), scale.clone()
    for _ in range(3):
        before = dict(launch_counts)
        ref_y, _ = fused_state_step_plain(ref_q, C, B, dA, xdt, ref_scale)
        y, out = fused_state_step(q, C, B, dA, xdt, scale)
        assert out is q
        assert launch_counts[f"fused_state_step_{mode}"] == before[f"fused_state_step_{mode}"] + 1
        assert launch_counts["fused_state_step"] == before["fused_state_step"]
        assert (y - ref_y).abs().max() <= 1e-5 * ref_y.abs().max()
        ulp = torch.nextafter(ref_scale, torch.full_like(ref_scale, float("inf"))) - ref_scale
        assert ((scale - ref_scale).abs() <= ulp).all()
        got = dequantize_state(q, scale.view(-1, 1, 1), mode)
        want = dequantize_state(ref_q, ref_scale.view(-1, 1, 1), mode)
        assert ((got - want).abs() <= ref_scale.view(-1, 1, 1) * 1.00001).all()
        assert (q != ref_q).float().mean() <= 1e-3
        xdt = xdt.flip(0).contiguous()  # the next step's inputs


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_fused_state_step_quant_row_alone_equals_row_in_batch(gen, mode):
    """One backbone row's 64 heads launched alone equal the same heads inside
    batch 8 with CFG (16 rows), bit for bit: y, stored bytes and scales."""
    q, C, B, dA, xdt, scale = _quant_state(gen, 1024, 64, 128, mode)
    row = slice(5 * 64, 6 * 64)
    alone = [t[row].clone() for t in (q, C, B, dA, xdt, scale)]
    y_all, _ = fused_state_step(q, C, B, dA, xdt, scale)
    y_one, _ = fused_state_step(*alone)
    assert torch.equal(y_one, y_all[row])
    assert torch.equal(alone[0], q[row]) and torch.equal(alone[5], scale[row])


def test_fused_state_step_quant_refuses_what_it_does_not_take(gen):
    q, C, B, dA, xdt, scale = _quant_state(gen, 4, 64, 128, "int8")
    with pytest.raises(ValueError, match="scales"):
        fused_state_step(q, C, B, dA, xdt)
    big = torch.zeros((4, 256, 128), dtype=torch.int8, device="cuda")  # 32,768 values a head
    with pytest.raises(ValueError, match="a CTA holds"):
        fused_state_step(big, C, B, dA, torch.zeros((4, 256), device="cuda"), scale)


def _bf16_ulps(ref: torch.Tensor, n: int) -> float:
    return n * 2.0 ** (int(torch.floor(torch.log2(ref.abs().max()))) - 7)


def _quantized_cache(gen, storage, B=2, Hkv=4, S=640, D=128):
    rows = [torch.randn((B, Hkv, S, D), generator=gen, device="cuda") * 2 for _ in range(2)]
    if storage == "int8":
        (k, ks), (v, vs) = (quantize_kv_rows(r) for r in rows)
        return k, v, ks, vs
    return (*(r.to(torch.float8_e4m3fn) for r in rows), None, None)


@pytest.mark.parametrize("storage", ["f8", "int8"])
@pytest.mark.parametrize("pos", [0, 255, 300, 639])
def test_decode_attention_held_out_kernels_match_plain(gen, storage, pos):
    """Tolerance: 4 bf16 ulps of max|ref| for f8 (the plain version reads an
    f8 cache's weights and values in bf16, as JAX does; the kernels keep
    fp32), 2 for int8 (fp32 throughout; the kernels round once)."""
    k, v, ks, vs = _quantized_cache(gen, storage)
    q = torch.randn((2, 1, 16, 128), generator=gen, device="cuda").bfloat16()
    k_new, v_new = (torch.randn((2, 1, 4, 128), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(), pos, ks, vs)
    tol = _bf16_ulps(ref, 4 if storage == "f8" else 2)
    before = dict(launch_counts)
    for fn in (flash_decode_attention_held_out, decode_attention_single_held_out):
        got = fn(q, k, v, k_new, v_new, pos, ks, vs)
        assert (got.float() - ref).abs().max() <= tol
    for name in ("flash_decode_attention", "decode_attention_single"):
        assert launch_counts[f"{name}_{storage}"] == before[f"{name}_{storage}"] + 1


# K2's cluster plan at its edges: one CTA (up to 64 rows), three (65 to 96), four (97 to
# 128), five to eight (129 to 256) at 1 and 2 batch rows; two beyond 64 rows at 32 (128
# pairs); one CTA a pair at 128
K2_LENGTHS = [1, 31, 32, 33, 64, 65, 66, 100, 129, 192, 224, 255, 256]
K2_BATCHES = [1, 2, 32, 128]


@pytest.mark.parametrize("length", K2_LENGTHS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B", K2_BATCHES)
def test_decode_attention_cluster_kernel_matches_plain(gen, B, G, length):
    """K2 (one cluster a pair, 1 to 8 CTAs) at 1, 2, 32 and 128 batch rows and
    1, 4 and 8 query heads a kv head; tolerance 2 bf16 ulps of max|ref|."""
    q = torch.randn((B, 1, 4 * G, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, 4, 320, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
    before = launch_counts["decode_attention_single"]
    got = decode_attention_single(q, k, v, length)
    assert launch_counts["decode_attention_single"] == before + 1
    assert (got.float() - ref).abs().max() <= _bf16_ulps(ref, 2)


@pytest.mark.parametrize("length", K2_LENGTHS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B", K2_BATCHES)
@pytest.mark.parametrize("storage", ["f8", "int8"])
def test_decode_attention_cluster_kernel_held_out_matches_plain(gen, storage, B, G, length):
    """K2 over f8 and int8 caches at pos = length - 1 (pos 0: the held-out row
    alone); tolerance 4 bf16 ulps of max|ref| for f8, 2 for int8, as above."""
    k, v, ks, vs = _quantized_cache(gen, storage, B=B, S=320)
    q = torch.randn((B, 1, 4 * G, 128), generator=gen, device="cuda").bfloat16()
    k_new, v_new = (torch.randn((B, 1, 4, 128), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    pos = length - 1
    ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(), pos, ks, vs)
    before = launch_counts[f"decode_attention_single_{storage}"]
    got = decode_attention_single_held_out(q, k, v, k_new, v_new, pos, ks, vs)
    assert launch_counts[f"decode_attention_single_{storage}"] == before + 1
    assert (got.float() - ref).abs().max() <= _bf16_ulps(ref, 4 if storage == "f8" else 2)


# K1's plans past 256 rows: 9 to 16 CTAs a cluster at 1 and 4 batch rows (CFG), 2 to 8 at
# 64; one to four stages a rank (64 rows bf16, 128 f8/int8); S 4096 for 4095
K1_LENGTHS = [257, 511, 1000, 2000, 2047, 4095]
K1_POS = [256, 257, 2047, 4095]
K1_BATCHES = [2, 8, 128]


@pytest.mark.parametrize("length", K1_LENGTHS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B", K1_BATCHES)
def test_flash_cluster_kernel_matches_plain(gen, B, G, length):
    """K1 (one cluster of up to 16 CTAs a pair, stages carried online) at 2,
    8 and 128 batch rows and 1, 4 and 8 query heads a kv head; tolerance 2
    bf16 ulps of max|ref|."""
    S = 4096 if length > 2048 else 2048
    q = torch.randn((B, 1, 4 * G, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, 4, S, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
    before = launch_counts["flash_decode_attention"]
    got = flash_decode_attention(q, k, v, length)
    assert launch_counts["flash_decode_attention"] == before + 1
    assert (got.float() - ref).abs().max() <= _bf16_ulps(ref, 2)


@pytest.mark.parametrize("pos", K1_POS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B", K1_BATCHES)
@pytest.mark.parametrize("storage", ["f8", "int8"])
def test_flash_cluster_kernel_held_out_matches_plain(gen, storage, B, G, pos):
    """K1 over f8 and int8 caches with the held-out row; tolerance 4 bf16 ulps
    of max|ref| for f8, 2 for int8, as above."""
    S = 4096 if pos >= 2048 else 2048
    k, v, ks, vs = _quantized_cache(gen, storage, B=B, S=S)
    q = torch.randn((B, 1, 4 * G, 128), generator=gen, device="cuda").bfloat16()
    k_new, v_new = (torch.randn((B, 1, 4, 128), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(), pos, ks, vs)
    before = launch_counts[f"flash_decode_attention_{storage}"]
    got = flash_decode_attention_held_out(q, k, v, k_new, v_new, pos, ks, vs)
    assert launch_counts[f"flash_decode_attention_{storage}"] == before + 1
    assert (got.float() - ref).abs().max() <= _bf16_ulps(ref, 4 if storage == "f8" else 2)


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float8_e4m3fn, torch.int8])
def test_flash_plan_fits_the_card(gen, storage):
    """The card holds all 8 clusters of K1's batch-1 plan at 2000 and 4095
    rows (16 CTAs each) at once up to 4 query heads a kv head (the flagship's;
    at 8 a CTA's registers fill an SM, and at least one cluster fits); the
    batch-64 plan splits the rows as batch 1's, one CTA a pair running them."""
    from zonos_tpu_torch.kernels._build import sm_count
    from zonos_tpu_torch.kernels.decode_attention import band_of, band_plan, max_active_clusters

    sms = sm_count(torch.cuda.current_device())
    for G in (1, 2, 4, 8):
        for S in (2048, 4096):  # the band past 512 rows, cut at the cache's end
            plan = band_plan("K1", band_of(S), 8, S, False, sms)
            assert plan.n == 16
            assert max_active_clusters(storage, G, plan.n, plan.chunk_max) >= (8 if G <= 4 else 1)
        plan = band_plan("K1", band_of(2000), 512, 2048, True, sms)
        assert plan.split == band_plan("K1", band_of(2000), 8, 2048, True, sms).split
        assert plan.grid == 1


def test_decode_attention_held_out_rejects_bf16_cache(gen):
    q = torch.randn((1, 1, 16, 128), generator=gen, device="cuda").bfloat16()
    k = torch.zeros((1, 4, 64, 128), dtype=torch.bfloat16, device="cuda")
    new = torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        decode_attention_single_held_out(q, k, k, new, new, 10)


@pytest.mark.parametrize("M", [1, 2, 7, 8, 9, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("din,dout", [(2048, 2048), (2048, 8512), (4096, 2048), (8192, 2048)])
@pytest.mark.parametrize("group_size", [32, 128])
def test_int4_matmul_kernel_matches_plain(gen, M, din, dout, group_size):
    """Same bf16 products as the plain version, other fp32 summation order:
    1e-5 x max|ref|.  M covers each n-tile count of the kernel (1, 2, 4, 8
    tiles of 8 rows) and its edges; in_proj's 8512 columns end in a
    part-filled tile; w2's din 8192 takes four splits at least."""
    w = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
    qw = quantize_weight_int4(w, group_size)
    x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
    ref = int4_matmul_plain(x, qw["q4"], qw["s4"])
    before = launch_counts["int4_matmul"]
    got = int4_matmul(x, qw["q4"], qw["s4"])
    assert launch_counts["int4_matmul"] == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dout,group_size", [(24, 32), (256, 4)])
def test_matmul_w_unpacks_what_the_int4_kernel_does_not_take(gen, dout, group_size):
    """dout % 16 != 0 or a group size that is not a multiple of 8: the
    unpack, as JAX dispatches by shape, and no K8 launch."""
    from zonos_tpu_torch.ops.quant import int4_matmul_unpacked, matmul_w

    w = quantize_weight_int4(torch.randn((256, dout), generator=gen, device="cuda") / 16,
                             group_size)
    x = torch.randn((2, 256), generator=gen, device="cuda").bfloat16()
    before = launch_counts["int4_matmul"]
    got = matmul_w(x, w)
    assert launch_counts["int4_matmul"] == before
    assert torch.equal(got, int4_matmul_unpacked(x, w["q4"], w["s4"]))


def test_matmul_w_sends_an_unaligned_view_to_the_int4_kernel(gen):
    """x at an offset that is not a multiple of 16 bytes still goes to K8."""
    from zonos_tpu_torch.ops.quant import matmul_w

    w = quantize_weight_int4(torch.randn((256, 128), generator=gen, device="cuda") / 16, 32)
    x = torch.randn((3 * 256 + 1,), generator=gen, device="cuda").bfloat16()[1:].view(3, 256)
    before = launch_counts["int4_matmul"]
    got = matmul_w(x, w)
    assert launch_counts["int4_matmul"] == before + 1
    ref = int4_matmul_plain(x, w["q4"], w["s4"]).bfloat16()
    assert (got.float() - ref.float()).abs().max() <= _bf16_ulps(ref.float(), 1)


def test_split_kernels_on_two_streams_match_plain(gen):
    """K8 and K4 calls queued on two streams at once: each call's split
    counters are its own, so both results match their plain versions."""
    qw = quantize_weight_int4(torch.randn((2048, 2048), generator=gen, device="cuda") / 45.0, 128)
    xs = [torch.randn((2, 2048), generator=gen, device="cuda").bfloat16() for _ in range(2)]
    tails = [_tail_args(gen, 2) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append((int4_matmul(xs[i], qw["q4"], qw["s4"]),
                                fused_layer_tail(*tails[i])))
    torch.cuda.synchronize()
    for i in range(2):
        ref = int4_matmul_plain(xs[i], qw["q4"], qw["s4"])
        ref_tail = fused_layer_tail_plain(*tails[i]).float()
        for got, got_tail in outs[i]:
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
            assert (got_tail.float() - ref_tail).abs().max() <= 1e-2 * ref_tail.abs().max()


def test_int4_matmul_kernel_rejects_what_it_does_not_take(gen):
    qw = quantize_weight_int4(torch.randn((256, 256), generator=gen, device="cuda"), 128)
    with pytest.raises(ValueError):  # more rows than a decode step has
        int4_matmul(torch.zeros((65, 256), dtype=torch.bfloat16, device="cuda"), qw["q4"], qw["s4"])
    with pytest.raises(TypeError):
        int4_matmul(torch.zeros((2, 256), device="cuda"), qw["q4"], qw["s4"])
    with pytest.raises(ValueError):  # the kernel reads x in 16-byte pieces
        x = torch.zeros((2 * 256 + 1,), dtype=torch.bfloat16, device="cuda")[1:].view(2, 256)
        int4_matmul(x, qw["q4"], qw["s4"])


def _tail_args(gen, B2, d=2048, inter=8192):
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    wo = quantize_weight_int8(rnd(d, d, scale=d ** -0.5))
    w1 = quantize_weight_int8(rnd(d, 2 * inter, scale=d ** -0.5))
    w2 = quantize_weight_int8(rnd(inter, d, scale=inter ** -0.5))
    return (rnd(B2, d).bfloat16(), rnd(B2, d).bfloat16(), wo["q"], wo["s"],
            (1 + rnd(d, scale=0.1)).bfloat16(), rnd(d, scale=0.1).bfloat16(),
            w1["q"], w1["s"], w2["q"], w2["s"])


@pytest.mark.parametrize("B2,d,inter", [(B2, 2048, 8192) for B2 in (1, 2, 8, 9, 13, 64, 128, 130)]
                         + [(2, 256, 512), (130, 256, 512)])
def test_fused_layer_tail_kernel_matches_plain(gen, B2, d, inter):
    """Other fp32 summation orders, which can move the bf16 roundings of h,
    the activation and the output: 1e-2 x max|ref|, half the JAX test's
    fused-vs-unfused bound.  B2 covers the n-tile edges (8 rows a tile, 16
    tiles a CTA) and a second row tile past 128; one narrow width too."""
    args = _tail_args(gen, B2, d, inter)
    ref = fused_layer_tail_plain(*args).float()
    before = launch_counts["fused_layer_tail"]
    got = fused_layer_tail(*args).float()
    assert launch_counts["fused_layer_tail"] == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


# ---------------------------------------------------------------------------
# G1, N1, and a row alone against the same row in a batch of 64 (128 rows with CFG)
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 10368),
               (2048, 8512), (4096, 2048)]  # the flagships' wqkv, wo, w1, w2, heads, in/out_proj


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (int(np.floor(np.log2(max(x, 1e-30)))) - 7)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("M", [1, 2, 17, 142])
@pytest.mark.parametrize("din,dout", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(gen, din, dout, M, int8):
    """G1 within 1 bf16 ulp of max|ref| of its plain version (the fp32 sums
    of the same bf16 products, in another order, rounded once)."""
    from zonos_tpu_torch.kernels.gemm import gemm, gemm_plain

    wf = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
    w = tuple(quantize_weight_int8(wf).values()) if int8 else (wf.bfloat16(),)
    x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
    before = launch_counts["gemm"]
    got = gemm(x, *w).float()
    assert launch_counts["gemm"] == before + 1
    ref = gemm_plain(x, *w).float()
    assert (got - ref).abs().max() <= _bf16_ulp(float(ref.abs().max()))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_split", range(1, 9))
def test_gemm_plans_match_plain_and_each_other(gen, n_split, int8):
    """Every cluster size G1 launches (splits of 256 contraction rows, K = 256
    n): at 2 and 100 rows, each launch (64- or 128-row tiles, the splits as a
    cluster's CTAs or in turn in one CTA) within 1 bf16 ulp of max|ref| of
    the plain version and the same bits as every other."""
    from zonos_tpu_torch.kernels.gemm import GemmPlan, gemm, gemm_plain

    K, N = 256 * n_split, 384
    wf = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    w = tuple(quantize_weight_int8(wf).values()) if int8 else (wf.bfloat16(),)
    for M in (2, 100):
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        ref = gemm_plain(x, *w).float()
        outs = [gemm(x, *w, plan=GemmPlan(n_split, 256, bm, parallel))
                for bm in (64, 128) for parallel in (True, False)]
        assert (outs[0].float() - ref).abs().max() <= _bf16_ulp(float(ref.abs().max()))
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 2, 130, 9088])
def test_row_norm_kernel_matches_plain(gen, rows, dtype):
    """N1's LayerNorm and RMSNorm (with a bias too) within 2 ulps of max|ref|
    in the output dtype of the plain versions."""
    from zonos_tpu_torch.kernels.row_norm import (
        layer_norm,
        layer_norm_plain,
        rms_norm,
        rms_norm_plain,
    )

    d = 2048
    x = (3 + 2 * torch.randn((rows, d), generator=gen, device="cuda")).to(dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    for got, ref in ((layer_norm(x, scale, bias), layer_norm_plain(x, scale, bias)),
                     (rms_norm(x, scale), rms_norm_plain(x, scale)),
                     (rms_norm(x, scale, bias=bias), rms_norm_plain(x, scale, bias=bias))):
        top = float(ref.float().abs().max())
        ulp = _bf16_ulp(top) if dtype == torch.bfloat16 else top * 2.0 ** -22
        assert got.dtype == dtype and (got.float() - ref.float()).abs().max() <= 2 * ulp


def _alone_and_in_batch(gen, fn, make):
    """fn on a pair of rows (a request with CFG) and on 128 rows (batch 64)
    with the pair at rows 0 and 64: the pair's outputs bit for bit."""
    one = make(2)
    ref = fn(*one)
    args = make(128)
    for a, a1 in zip(args, one):
        a[[0, 64]] = a1
    got = fn(*args)[[0, 64]]
    torch.cuda.synchronize()
    return torch.equal(got, ref)


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def test_row_alone_equals_row_in_batch_64(gen):
    """G1 (bf16 and int8, a decode step and a 71-row prefill), K8 through
    ``matmul_w`` (128 rows: two chunks of 64), N1, K2 (length 200), K1
    (2000) and K4: a request's rows give the same bits alone and in a batch
    of 64 with CFG."""
    from zonos_tpu_torch.kernels.gemm import gemm
    from zonos_tpu_torch.kernels.row_norm import layer_norm
    from zonos_tpu_torch.ops.quant import matmul_w

    w = (torch.randn((8192, 2048), generator=gen, device="cuda") / 90.0)
    w_in = (torch.randn((2048, 8512), generator=gen, device="cuda") / 45.0).bfloat16()
    w8 = quantize_weight_int8(w)
    w4 = quantize_weight_int4(w, 128)
    scale, bias = _rnd(gen, 2048) + 1, _rnd(gen, 2048) * 0.1
    tail = _tail_args(gen, 2)
    cases = {
        "G1 bf16": (lambda x: gemm(x, w.bfloat16()), lambda B: (_rnd(gen, B, 8192),)),
        "G1 int8": (lambda x: gemm(x, w8["q"], w8["s"]), lambda B: (_rnd(gen, B, 8192),)),
        "G1 prefill": (lambda x: matmul_w(x, w.bfloat16()), lambda B: (_rnd(gen, B, 71, 8192),)),
        "G1 in_proj": (lambda x: gemm(x, w_in), lambda B: (_rnd(gen, B, 2048),)),
        "K8": (lambda x: matmul_w(x, w4), lambda B: (_rnd(gen, B, 8192),)),
        "N1": (lambda x: layer_norm(x, scale, bias), lambda B: (_rnd(gen, B, 71, 2048),)),
        "K2": (lambda q, k, v: decode_attention_single(q, k, v, 200),
               lambda B: (_rnd(gen, B, 1, 16, 128), _rnd(gen, B, 4, 256, 128),
                          _rnd(gen, B, 4, 256, 128))),
        "K1": (lambda q, k, v: flash_decode_attention(q, k, v, 2000),
               lambda B: (_rnd(gen, B, 1, 16, 128), _rnd(gen, B, 4, 2048, 128),
                          _rnd(gen, B, 4, 2048, 128))),
        "K4": (lambda a, r: fused_layer_tail(a, r, *tail[2:]),
               lambda B: (_rnd(gen, B, 2048), _rnd(gen, B, 2048))),
    }
    differ = [name for name, (fn, make) in cases.items()
              if not _alone_and_in_batch(gen, fn, make)]
    assert not differ, differ


def test_hybrid_decode_step_row_alone_equals_row_in_batch_64(gen):
    """A full-width two-layer hybrid (a Mamba2 layer, then an attention
    layer): a 6-step prefill and two decode steps of a request's pair of
    rows alone give the same bits as the same rows at 0 and 64 of 128 (batch
    64 with CFG): G1, N1, the tap-order causal conv, K6, K7 with its B.C,
    the prefill's attention and K2."""
    from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, ZonosConfig
    from zonos_tpu_torch.models import hybrid

    cfg_dict = copy.deepcopy(HYBRID_CONFIG_DICT)
    cfg_dict["backbone"].update({"n_layer": 2, "attn_layer_idx": [1]})
    cfg = ZonosConfig.from_dict(cfg_dict).backbone
    params = hybrid.init_hybrid_params(cfg, gen, dtype=torch.bfloat16, device="cuda")

    def run(x):
        cache = hybrid.create_hybrid_cache(cfg, x.shape[0], 64, torch.bfloat16, "cuda",
                                           ssm_state="fp32")
        outs = [hybrid.hybrid_prefill(cfg, params, x[:, :6], cache)[0]]
        for step in range(2):
            outs.append(hybrid.hybrid_decode_step(cfg, params, x[:, 6 + step:7 + step], cache,
                                                  6 + step)[0])
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        assert _alone_and_in_batch(gen, run, lambda B: (_rnd(gen, B, 8, cfg.d_model),))


def test_fused_layer_tail_kernel_rejects_bf16_weights(gen):
    args = list(_tail_args(gen, 2, d=256, inter=256))
    args[2] = args[2].bfloat16()  # a bf16 wo
    with pytest.raises(TypeError):
        fused_layer_tail(*args)


# ---------------------------------------------------------------------------
# the op layer's dispatch: what a kernel does not take (kernel_takes says no)
# is computed with the reference math and launches nothing
# ---------------------------------------------------------------------------


def _tiny_backbone(d_model, dtype):
    """A two-layer int8 transformer backbone made on the CPU, and its copy on the card."""
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT, ZonosConfig
    from zonos_tpu_torch.models.backbone import init_transformer_params

    cfg_dict = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    cfg_dict["backbone"].update({"d_model": d_model, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                                 "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    cfg = ZonosConfig.from_dict(cfg_dict).backbone
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0), dtype=dtype)
    for name in ("wo", "w1", "w2"):
        params["layers"][name] = quantize_weight_int8(params["layers"][name])
    return cfg, params, _to(params, "cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _decode_step_both(gen, d_model, dtype):
    from zonos_tpu_torch.models.backbone import KVCache, transformer_decode_step

    cfg, params, params_cuda = _tiny_backbone(d_model, dtype)
    x = torch.randn((2, 1, d_model), generator=gen, device="cuda").to(dtype)
    out = []
    for p, dev in ((params, "cpu"), (params_cuda, "cuda")):
        cache = KVCache.create(cfg, 2, 8, dtype=dtype, device=dev)
        out.append(transformer_decode_step(cfg, p, x.to(dev), cache, 0)[0].float().cpu())
    return out


def _k1k2_case(gen):
    from zonos_tpu_torch.ops.attention import decode_attention

    q = torch.randn((2, 1, 8, 64), generator=gen, device="cuda").bfloat16()  # head_dim 64
    k, v = (torch.randn((2, 4, 300, 64), generator=gen, device="cuda").bfloat16() for _ in range(2))
    return decode_attention(q, k, v, 290), decode_attention_plain(q, k, v, 290)


def _k1k2_fp32_case(gen):
    from zonos_tpu_torch.ops.attention import decode_attention

    q = torch.randn((2, 1, 16, 128), generator=gen, device="cuda")  # fp32
    k, v = (torch.randn((2, 4, 300, 128), generator=gen, device="cuda") for _ in range(2))
    return decode_attention(q, k, v, 100), decode_attention_plain(q, k, v, 100)


def _k1k2_held_out_case(gen):
    from zonos_tpu_torch.ops.attention import decode_attention_held_out

    k, v, ks, vs = _quantized_cache(gen, "f8", S=300)
    q = torch.randn((2, 1, 16, 128), generator=gen, device="cuda")  # an fp32 model's q
    k_new, v_new = (torch.randn((2, 1, 4, 128), generator=gen, device="cuda") for _ in range(2))
    args = (q, k, v, k_new, v_new, 280, ks, vs)
    return decode_attention_held_out(*args), decode_attention_split_plain(*args)


def _k3_case(gen):
    from zonos_tpu_torch.ops.sampling import SamplingParams, sample_from_logits

    V = 12352  # past the kernel's 12,288
    logits = torch.randn((2, 9, V), generator=gen, device="cuda") * 3
    noise = gumbel_of_uniform(torch.rand((2, 9, V), generator=gen, device="cuda"))
    p = SamplingParams(min_p=0.1)
    ref = fused_sample_plain(logits, noise, linear=p.linear, conf=p.conf, quad=p.quad,
                             min_p=p.min_p, temperature=p.temperature)
    return sample_from_logits(logits, p, noise), ref


def _k5_case(gen):
    from zonos_tpu_torch.kernels.snake_conv import _snake_conv

    C, dil = 32, 177  # the halo of dilation 177 passes the kernel's 227 KB of shared memory
    x = torch.randn((1, 400, C), generator=gen, device="cuda")
    alpha = 0.5 + torch.rand((C,), generator=gen, device="cuda")
    w = torch.randn((C, C, 7), generator=gen, device="cuda") * 0.05
    b = torch.randn((C,), generator=gen, device="cuda")
    return _snake_conv(x, alpha, w, b, dil), snake_conv1d_plain(x, alpha, w, b, dil)


def _k6_case(gen):
    from zonos_tpu_torch.ops.ssm import ssd_chunked as ssd_op

    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(gen, 2, 70, 4, 1, 128, 16)  # headdim 128
    return ssd_op(x, dt, A, Bm, Cm, D), ssd_chunked_plain(x, dt, A, Bm, Cm, D)


def _k7_case(gen):
    from zonos_tpu_torch.ops.ssm import ssd_decode_step

    B, H, P, N = 2, 4, 16, 24  # 24 fp32 = six 16-byte slices, not a power of two
    x, Bm, Cm = (torch.randn(shape, generator=gen, device="cuda")
                 for shape in ((B, H, P), (B, 1, N), (B, 1, N)))
    dt = torch.rand((B, H), generator=gen, device="cuda")
    A, D = -torch.rand((H,), generator=gen, device="cuda"), torch.randn((H,), generator=gen,
                                                                        device="cuda")
    state = torch.randn((B, H, P, N), generator=gen, device="cuda")
    ref_state = state.clone()
    dA = torch.exp(dt * A[None, :])
    y_state, _ = fused_state_step_plain(ref_state.view(B * H, P, N),
                                        Cm.expand(B, H, N).reshape(B * H, N),
                                        Bm.expand(B, H, N).reshape(B * H, N),
                                        dA.reshape(B * H, 1), (x * dt[..., None]).reshape(B * H, P))
    bc = (Bm * Cm).sum(-1)  # [B, 1], one group for every head
    ref = dA[..., None] * y_state.view(B, H, P) + bc[..., None] * x * dt[..., None] \
        + x * D[None, :, None]
    y, _ = ssd_decode_step(x, dt, A, Bm, Cm, D, state)
    return (y, state), (ref, ref_state)


def _k8_case(gen):
    from zonos_tpu_torch.ops.quant import int4_matmul_unpacked, matmul_w

    w = quantize_weight_int4(torch.randn((256, 128), generator=gen, device="cuda") / 16, 32)
    x = torch.randn((2, 256), generator=gen, device="cuda")  # fp32 x
    return matmul_w(x, w), int4_matmul_unpacked(x, w["q4"], w["s4"])


DISPATCH = {  # kernel -> (case, tolerance as a fraction of max|ref|; 0: bit-equal)
    "K1K2 head_dim 64": (_k1k2_case, 0.0),
    "K1K2 fp32": (_k1k2_fp32_case, 0.0),
    "K1K2 fp32 q over an f8 cache": (_k1k2_held_out_case, 0.0),
    "K3 vocab 12352": (_k3_case, 0.0),
    # the decode step on the card against the same step on the CPU (both unfused);
    # d_model 72 is not a multiple of 16
    "K4 d_model 72": (lambda gen: _decode_step_both(gen, 72, torch.bfloat16), 2e-2),
    "K4 fp32": (lambda gen: _decode_step_both(gen, 64, torch.float32), 1e-5),
    "K5 dilation 177": (_k5_case, 0.0),
    "K6 headdim 128": (_k6_case, 0.0),
    "K7 d_state 24": (_k7_case, 1e-6),
    "K8 fp32 x": (_k8_case, 0.0),
}


def _pairs(got, ref):
    if isinstance(got, (tuple, list)):
        for g, r in zip(got, ref):
            yield from _pairs(g, r)
    else:
        yield got, ref


@pytest.mark.parametrize("case", list(DISPATCH))
def test_call_site_computes_what_its_kernel_does_not_take(gen, case):
    """Each call site, at a dtype or shape its kernel does not take, returns
    the reference math's result and launches no kernel."""
    fn, tol = DISPATCH[case]
    before = dict(launch_counts)
    got, ref = fn(gen)
    torch.cuda.synchronize()
    assert launch_counts == before
    for g, r in _pairs(got, ref):
        g, r = g.float().cpu(), r.float().cpu()
        assert g.shape == r.shape
        if tol == 0.0:
            assert torch.equal(g, r)
        else:
            assert (g - r).abs().max() <= tol * r.abs().max()


def test_fp32_generate_on_the_card_gives_the_cpu_codes(gen):
    """A tiny fp32 model on the card (where no kernel takes fp32 but K3,
    which greedy decoding does not run) gives the CPU path's greedy codes."""
    from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
    from zonos_tpu_torch.ops.sampling import SamplingParams

    cfg_dict = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    cfg_dict["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                                 "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    cfg = ZonosConfig.from_dict(cfg_dict)
    cpu = Zonos(cfg, seed=0, device="cpu", dtype=torch.float32)
    card = Zonos(cfg, params=_to(cpu.params, "cuda"), device="cuda")
    assert card.compute_dtype == torch.float32
    greedy = SamplingParams(temperature=0.0)
    codes = []
    for model in (cpu, card):
        prefix = model.prepare_conditioning(make_cond_dict(text="Hello world.", speaker=None))
        codes.append(model.generate(prefix, max_new_tokens=24, seed=0, sampling_params=greedy))
    assert len(codes[0]) == len(codes[1]) == 1
    assert np.array_equal(codes[0][0], codes[1][0])


# ---------------------------------------------------------------------------
# K1/K2 with the length on the card, over every band a 30 s generate reaches
# ---------------------------------------------------------------------------

# each band's edges and lengths inside it, up to ~2700 rows (30 s of audio after a prefix)
BAND_LENGTHS = [1, 2, 64, 65, 200, 256, 257, 300, 511, 512, 513, 1000, 1665, 2047, 2700]


@pytest.mark.parametrize("storage", ["bf16", "f8", "int8"])
@pytest.mark.parametrize("B", [2, 8])
def test_kernels_read_the_length_from_the_card(gen, B, storage):
    """The kernel of each band (K2 up to 256, K1 beyond), given the length as
    an int32 on the card with its band, at the band's edges and inside it:
    within 2 bf16 ulps of max|ref| of the plain version over a bf16 or int8
    cache, 4 over f8 (as above).  A length past the band (and the cache) on
    the card is clamped: no row past the cache's end is read."""
    from zonos_tpu_torch.kernels.decode_attention import Band, band_of
    from zonos_tpu_torch.ops.attention import decode_attention, decode_attention_held_out

    S = 2752
    q = torch.randn((B, 1, 16, 128), generator=gen, device="cuda").bfloat16()
    if storage == "bf16":
        k, v = (torch.randn((B, 4, S, 128), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
    else:
        k, v, ks, vs = _quantized_cache(gen, storage, B=B, S=S)
        k_new, v_new = (torch.randn((B, 1, 4, 128), generator=gen, device="cuda").bfloat16()
                        for _ in range(2))
    ulps = 4 if storage == "f8" else 2
    for length in BAND_LENGTHS + [S + 100]:
        band = band_of(min(length, S)) if length <= S else Band(513, None)
        rows = torch.full((), length - (storage != "bf16"), dtype=torch.int32, device="cuda")
        attended = min(length, S)
        if storage == "bf16":
            got = decode_attention(q, k, v, rows, band)
            ref = decode_attention_plain(q.float(), k.float(), v.float(), attended)
        else:
            got = decode_attention_held_out(q, k, v, k_new, v_new, rows, ks, vs, band=band)
            ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(),
                                               attended - 1, ks, vs)
        assert (got.float() - ref).abs().max() <= _bf16_ulps(ref, ulps), length


# ---------------------------------------------------------------------------
# the decode step: keyed noise, no sync, CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_TEXTS = ["Hello world.", "Good morning, how are you?", "The quick brown fox.",
               "Speech synthesis is wonderful."]
# the kernels' widths at a small depth: head_dim 128, K4/K8's multiples of 16 and 128
GRAPH_TRANSFORMER = {"d_model": 512, "n_layer": 2, "attn_mlp_d_intermediate": 1024,
                     "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
GRAPH_HYBRID = {"d_model": 512, "n_layer": 3, "attn_layer_idx": [1],
                "attn_mlp_d_intermediate": 1024,
                "ssm_cfg": {"layer": "Mamba2", "d_state": 128, "expand": 2, "headdim": 64,
                            "d_conv": 4, "ngroups": 1},
                "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 128,
                             "rotary_emb_dim": 64}}
GRAPH_CASES = {  # name -> (backbone, weights, KV cache storage)
    "transformer bf16": ("transformer", None, None),
    "transformer int8, int8 KV": ("transformer", "int8", "int8"),
    "transformer int4, f8 KV": ("transformer", "int4", "f8"),
    "hybrid bf16": ("hybrid", None, None),
}
GRAPH_NEW_TOKENS = 520  # past 512 cache rows after a short prefix: K2's band and both of K1's


def _graph_model(case: str):
    from zonos_tpu_torch import Zonos, ZonosConfig
    from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT

    kind, weights, kv = GRAPH_CASES[case]
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT if kind == "transformer" else HYBRID_CONFIG_DICT)
    d["backbone"].update(copy.deepcopy(GRAPH_TRANSFORMER if kind == "transformer"
                                       else GRAPH_HYBRID))
    model = Zonos(ZonosConfig.from_dict(d), seed=0)
    if weights is not None:
        getattr(model, f"quantize_{weights}")()
    return model.set_storage(kv=kv)


@pytest.mark.parametrize("sampling", ["greedy", "default"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_equals_the_eager_loop(gen, case, batch, sampling):
    """``generate`` (CUDA-graph replays) and the private eager loop give the
    same codes bit for bit, with the same seed."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.ops.sampling import SamplingParams

    model = _graph_model(case)
    prefix = model.prepare_conditioning(make_cond_dict(text=GRAPH_TEXTS[:batch], speaker=None))
    params = SamplingParams.greedy() if sampling == "greedy" else None
    seeds = [11 + i for i in range(batch)]
    graph = model.generate(prefix, max_new_tokens=96, batch_size=batch,
                           sampling_params=params, seed=seeds)
    assert model.decode_stats["graphs"] >= 1
    eager = model._generate(prefix, 96, 2.0, batch, params, seeds, None, graphs=False)
    assert model.decode_stats["graphs"] == 0
    assert len(graph) == len(eager) == batch
    for g, e in zip(graph, eager):
        assert g.shape == e.shape and np.array_equal(g, e)


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_through_every_band(gen, case):
    """One batch-1 generate past 512 cache rows (EOS banned, so that it runs
    its whole budget): one graph for each of the three bands, the kernels'
    launches counted through the replays, and the eager loop's codes."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.kernels import reset_launch_counts
    from zonos_tpu_torch.ops.sampling import SamplingParams

    model = _graph_model(case)
    prefix = model.prepare_conditioning(make_cond_dict(text=GRAPH_TEXTS[0], speaker=None))
    params = SamplingParams(ban_eos=True)
    reset_launch_counts()
    graph = model.generate(prefix, max_new_tokens=GRAPH_NEW_TOKENS, sampling_params=params,
                           seed=5)
    counts = dict(launch_counts)
    stats = dict(model.decode_stats)
    assert stats["graphs"] == 3 and stats["steps"] == GRAPH_NEW_TOKENS + 8
    suffix = {"int8": "_int8", "f8": "_f8", None: ""}[GRAPH_CASES[case][2]]
    k2, k1 = f"decode_attention_single{suffix}", f"flash_decode_attention{suffix}"
    layers = 1 if case.startswith("hybrid") else 2  # attention layers
    pos0 = prefix.shape[1] + 1
    # every step a launch of each attention layer: K2 while pos + 1 <= 256, then K1
    assert counts[k2] == layers * (256 - pos0)
    assert counts[k1] == layers * (stats["steps"] - (256 - pos0))
    assert counts["fused_sample"] == 2 * stats["steps"] + 1
    eager = model._generate(prefix, GRAPH_NEW_TOKENS, 2.0, 1, params, 5, None, graphs=False)
    assert np.array_equal(graph[0], eager[0])


def test_eager_decode_step_does_not_synchronize(gen, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` every eager decode step
    of the int8 model with the int8 KV cache (K1, K2, K3, K4) runs: none
    waits for the card."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.models import tts

    model = _graph_model("transformer int8, int8 KV")
    prefix = model.prepare_conditioning(make_cond_dict(text=GRAPH_TEXTS[:2], speaker=None))
    step = tts.Zonos._decode_step
    steps = []

    def guarded(self, run, band):
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(self, run, band)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        steps.append(band)

    monkeypatch.setattr(tts.Zonos, "_decode_step", guarded)
    model._generate(prefix, 260, 2.0, 2, None, [1, 2], None, graphs=False)
    assert {band.kernel for band in steps} == {"K1", "K2"}


def test_keyed_noise_bits_on_the_card_equal_the_cpu_bits(gen):
    from zonos_tpu_torch.ops.sampling import element_counters, keyed_bits, row_keys

    seeds = torch.tensor([0, 1, 423, 2**40 + 7, -5])
    bits = [keyed_bits(row_keys(seeds.to(dev)), torch.tensor(123, device=dev),
                       torch.arange(3, device=dev), element_counters(9 * 1152, dev)).cpu()
            for dev in ("cpu", "cuda")]
    assert torch.equal(bits[0], bits[1])


def test_streamed_row_on_the_card_equals_its_full_decode(gen):
    """``stream_generate`` on the card (graph replays, the full DAC): the
    chunks concatenate to the DAC decode of ``generate``'s codes with the same
    seed, within 1e-4 x max|full|."""
    from zonos_tpu_torch import make_cond_dict

    model = _graph_model("transformer bf16")
    prefix = model.prepare_conditioning(make_cond_dict(text=GRAPH_TEXTS[0], speaker=None))
    chunks = list(model.stream_generate(prefix, max_new_tokens=120, seed=9, chunk_frames=43))
    assert len(chunks) >= 2 and model.decode_stats["graphs"] >= 1
    codes = model.generate(prefix, max_new_tokens=120, seed=9)[0]
    full = model.autoencoder.decode(codes[None])[0, 0]
    streamed = np.concatenate(chunks)
    assert streamed.shape == full.shape
    assert np.abs(streamed - full).max() <= 1e-4 * np.abs(full).max()


# ---------------------------------------------------------------------------
# a layer's norm folded into the product that reads it (G1, K8)
# ---------------------------------------------------------------------------


def _fold_norms(gen, d):
    from zonos_tpu_torch.kernels.row_norm import Norm

    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    return [Norm(scale, bias, 1e-5, False), Norm(scale, None, 1e-5, True)]


def _n1_then(x, norm):
    """N1 alone, then the cast to bf16: the unfused route's x."""
    from zonos_tpu_torch.kernels import row_norm as n1

    if norm.rms:
        return n1.rms_norm(x, norm.scale, norm.eps, norm.bias).bfloat16()
    return n1.layer_norm(x, norm.scale, norm.bias, norm.eps).bfloat16()


def _fold_product(gen, weight, din=2048, dout=3072):
    """(product(x, norm=None)) for a bf16, int8 or int4 weight and the name
    of its folded launch count."""
    from zonos_tpu_torch.kernels.gemm import gemm

    w = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
    if weight == "int4":
        w4 = quantize_weight_int4(w, 128)
        return (lambda x, norm=None: int4_matmul(x, w4["q4"], w4["s4"], norm=norm),
                "int4_matmul_norm")
    if weight == "int8":
        w8 = quantize_weight_int8(w)
        return lambda x, norm=None: gemm(x, w8["q"], w8["s"], norm=norm), "gemm_norm"
    wb = w.bfloat16()
    return lambda x, norm=None: gemm(x, wb, norm=norm), "gemm_norm"


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weight", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("M", [1, 2, 8, 16])
def test_folded_norm_equals_n1_then_the_product(gen, M, weight, x_dtype):
    """G1 and K8 with a LayerNorm or an RMSNorm folded in give the bits of
    N1, the cast to bf16 and the unfused product, in one launch."""
    product, key = _fold_product(gen, weight)
    for norm in _fold_norms(gen, 2048):
        x = (3 + 2 * torch.randn((M, 2048), generator=gen, device="cuda")).to(x_dtype)
        before = dict(launch_counts)
        got = product(x, norm=norm)
        assert launch_counts[key] == before[key] + 1
        assert launch_counts["row_norm"] == before["row_norm"]
        assert torch.equal(got, product(_n1_then(x, norm)))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weight", ["bf16", "int8", "int4"])
def test_folded_norm_row_alone_equals_row_in_batch(gen, weight, x_dtype):
    """A request's pair of rows through a folded norm: the same bits alone
    and at rows 0 and 64 of 128 (G1, bf16 x), or 0 and 8 of 16 (fp32 x,
    and K8: the most rows they fold)."""
    product, _ = _fold_product(gen, weight)
    big = 128 if weight != "int4" and x_dtype == torch.bfloat16 else 16
    for norm in _fold_norms(gen, 2048):
        one = (3 + 2 * torch.randn((2, 2048), generator=gen, device="cuda")).to(x_dtype)
        x = (3 + 2 * torch.randn((big, 2048), generator=gen, device="cuda")).to(x_dtype)
        x[[0, big // 2]] = one
        assert torch.equal(product(x, norm=norm)[[0, big // 2]], product(one, norm=norm))


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_decode_step_launches_n1_once(gen, case):
    """One eager decode step launches N1 once (the final norm): every other
    norm runs folded into the product that reads it."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.ops.sampling import SamplingParams

    model = _graph_model(case)
    prefix = model.prepare_conditioning(make_cond_dict(text=GRAPH_TEXTS[0], speaker=None))
    params = SamplingParams(ban_eos=True)
    counts, steps = [], []
    for tokens in (16, 32):
        before = dict(launch_counts)
        model._generate(prefix, tokens, 2.0, 1, params, 5, None, graphs=False)
        counts.append({k: launch_counts[k] - before[k] for k in launch_counts})
        steps.append(model.decode_stats["steps"])
    per_step = {k: (counts[1][k] - counts[0][k]) / (steps[1] - steps[0]) for k in counts[0]}
    assert per_step["row_norm"] == 1
    folded = "int4_matmul_norm" if GRAPH_CASES[case][1] == "int4" else "gemm_norm"
    assert per_step[folded] >= 1
