"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (from its fixture) where no card is
present.  On a machine with one: ``python -m pytest -m cuda
tests/test_torch_port_cuda.py``.  ``chip_smoke.py`` runs the same checks at
the flagship shapes.
"""

from __future__ import annotations

import pytest
import torch

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
from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain
from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain
from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain
from zonos_tpu_torch.kernels.ssm_state import (
    fused_state_step,
    fused_state_step_plain,
    storage_ulp,
)
from zonos_tpu_torch.models.backbone import quantize_kv_rows
from zonos_tpu_torch.ops.quant import quantize_weight_int4, quantize_weight_int8
from zonos_tpu_torch.ops.sampling import gumbel_noise

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
    noise = gumbel_noise((4, 9, 1152), gen, "cuda")
    kw = dict(linear=0.55, conf=0.4, quad=0.0, min_p=min_p)
    assert torch.equal(fused_sample(logits, noise, **kw), fused_sample_plain(logits, noise, **kw))


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


def _ssd_inputs(gen, B, L, H, G, P, N):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (rnd(B, L, H, P), rnd(B, L, H).abs() * 0.5, -rnd(H).abs(), rnd(B, L, G, N),
            rnd(B, L, G, N), rnd(H), rnd(B, H, P, N))


@pytest.mark.parametrize("L,G,P,N", [(37, 1, 64, 128), (150, 1, 64, 128), (70, 2, 16, 16)])
def test_ssd_chunked_kernel_matches_plain(gen, L, G, P, N):
    x, dt, A, Bm, Cm, D, init = _ssd_inputs(gen, 2, L, 4, G, P, N)
    before = launch_counts["ssd_chunked"]
    for state in (init, None):
        ref_y, ref_s = ssd_chunked_plain(x, dt, A, Bm, Cm, D, state)
        y, s = ssd_chunked(x, dt, A, Bm, Cm, D, state)
        assert (y - ref_y).abs().max() <= 1e-4 * ref_y.abs().max()
        assert (s - ref_s).abs().max() <= 1e-4 * ref_s.abs().max()
    assert launch_counts["ssd_chunked"] == before + 2


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


def test_fused_state_step_kernel_rejects_fp16(gen):
    state = torch.zeros((4, 64, 128), dtype=torch.float16, device="cuda")
    C = torch.zeros((4, 128), device="cuda")
    with pytest.raises(TypeError):
        fused_state_step(state, C, C, torch.ones((4, 1), device="cuda"),
                         torch.zeros((4, 64), device="cuda"))


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


@pytest.mark.parametrize("B2", [2, 8, 13])
def test_fused_layer_tail_kernel_matches_plain(gen, B2):
    """Other fp32 summation orders, which can move the bf16 roundings of h,
    the activation and the output: 1e-2 x max|ref|, half the JAX test's
    fused-vs-unfused bound."""
    args = _tail_args(gen, B2)
    ref = fused_layer_tail_plain(*args).float()
    before = launch_counts["fused_layer_tail"]
    got = fused_layer_tail(*args).float()
    assert launch_counts["fused_layer_tail"] == before + 1
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


def test_fused_layer_tail_kernel_rejects_bf16_weights(gen):
    args = list(_tail_args(gen, 2, d=256, inter=256))
    args[2] = args[2].bfloat16()  # a bf16 wo
    with pytest.raises(TypeError):
        fused_layer_tail(*args)
