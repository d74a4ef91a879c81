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
    flash_decode_attention,
)
from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain
from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain
from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain
from zonos_tpu_torch.kernels.ssm_state import (
    fused_state_step,
    fused_state_step_plain,
    storage_ulp,
)
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
