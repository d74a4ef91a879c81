"""Plain PyTorch versions of the port's kernels against the JAX package.

K1/K2 decode attention, K3 fused sampling and K5 snake-conv: each plain
version (the CPU path of its kernel wrapper) is held against the Pallas
kernel run in interpret mode and against the XLA function it replaces, on
the same inputs made from a seed with numpy.  On CPU tensors the wrappers
and dispatchers must take the plain version and count no launch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.models.dac.codec import _res_unit as jax_res_unit
from zonos_tpu.ops.attention import decode_attention as jax_decode_attention
from zonos_tpu.ops.pallas_dac import snake_conv1d_pallas, snake_residual_unit_pallas
from zonos_tpu.ops.pallas_kernels import (
    decode_attention_pallas,
    flash_decode_attention_pallas,
    fused_sample_pallas,
)
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels.decode_attention import (
    decode_attention_plain,
    decode_attention_single,
    flash_decode_attention,
)
from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain
from zonos_tpu_torch.kernels.snake_conv import (
    snake_conv1d,
    snake_conv1d_plain,
    snake_residual_unit,
)
from zonos_tpu_torch.ops.attention import decode_attention

S_CACHE = 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("length", [1, 63, 64, 65, S_CACHE])
def test_decode_attention_plain_matches_pallas(length):
    rng = np.random.default_rng(length)
    B, H, Hkv, D = 2, 8, 2, 128
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S_CACHE, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S_CACHE, D)).astype(np.float32)
    ours = decode_attention_plain(_t(q), _t(k), _t(v), length).numpy()
    refs = {
        "xla": jax_decode_attention(q, k, v, jnp.int32(length)),
        "pallas_single": decode_attention_pallas(q, k, v, jnp.int32(length), interpret=True),
        "pallas_flash": flash_decode_attention_pallas(q, k, v, jnp.int32(length), block_s=64,
                                                      interpret=True),
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=name)

    before = dict(launch_counts)
    for fn in (flash_decode_attention, decode_attention_single, decode_attention):
        np.testing.assert_array_equal(fn(_t(q), _t(k), _t(v), length).numpy(), ours)
    assert launch_counts == before  # CPU tensors never reach a kernel


def test_decode_attention_ignores_rows_past_length():
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(1, 1, 4, 128)).astype(np.float32))
    k = _t(rng.normal(size=(1, 2, 32, 128)).astype(np.float32))
    v = _t(rng.normal(size=(1, 2, 32, 128)).astype(np.float32))
    a = decode_attention_plain(q, k, v, 10)
    k[:, :, 10:] = 1e9
    v[:, :, 10:] = -1e9
    torch.testing.assert_close(decode_attention_plain(q, k, v, 10), a, rtol=0, atol=0)


@pytest.mark.parametrize("min_p", [0.0, 0.1])
def test_fused_sample_plain_matches_pallas(min_p):
    """Same logits, same Gumbel noise (drawn by JAX from per-row keys and
    passed in as numpy): identical ids."""
    B, K, V = 4, 9, 1152
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(B, K, V)) * 3.0).astype(np.float32)
    logits[..., 1025:] = -np.inf  # vocab padding, as on the decode path
    keys = jax.random.split(jax.random.key(3), B)
    gumbel = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (K, V), jnp.float32))(keys))
    kw = dict(linear=0.55, conf=0.4, quad=0.0, min_p=min_p)
    ref = fused_sample_pallas(keys, jnp.asarray(logits), interpret=True, **kw)
    ours = fused_sample_plain(_t(logits), _t(gumbel), **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    before = dict(launch_counts)
    np.testing.assert_array_equal(fused_sample(_t(logits), _t(gumbel), **kw).numpy(),
                                  ours.numpy())
    assert launch_counts == before


def _conv_np(rng, k, cin, cout):
    return {"w": (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(cout,)) * 0.1).astype(np.float32)}


def _torch_conv(p):
    # JAX conv layout [K, C_in, C_out] -> torch [C_out, C_in, K]
    return {"w": _t(np.transpose(p["w"], (2, 1, 0))), "b": _t(p["b"])}


@pytest.mark.parametrize("k,dilation", [(7, 1), (7, 3), (7, 9), (1, 1)])
def test_snake_conv_plain_matches_pallas(k, dilation):
    rng = np.random.default_rng(k * 10 + dilation)
    B, T, C_in, C_out = 2, 40, 16, 24
    x = rng.normal(size=(B, T, C_in)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, size=(C_in,)).astype(np.float32)
    p = _conv_np(rng, k, C_in, C_out)
    ref = np.asarray(snake_conv1d_pallas(x, alpha, p["w"], p["b"], dilation=dilation,
                                         interpret=True))
    tp = _torch_conv(p)
    ours = snake_conv1d_plain(_t(x), _t(alpha), tp["w"], tp["b"], dilation).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    before = dict(launch_counts)
    np.testing.assert_array_equal(snake_conv1d(_t(x), _t(alpha), tp["w"], tp["b"], dilation).numpy(),
                                  ours)
    assert launch_counts == before


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_plain_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    B, T, C = 1, 48, 16
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    p = {"alpha1": rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32),
         "conv1": _conv_np(rng, 7, C, C),
         "alpha2": rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32),
         "conv2": _conv_np(rng, 1, C, C)}
    tp = {"alpha1": _t(p["alpha1"]), "conv1": _torch_conv(p["conv1"]),
          "alpha2": _t(p["alpha2"]), "conv2": _torch_conv(p["conv2"])}
    ours = snake_residual_unit(tp, _t(x), dilation).numpy()
    for ref in (jax_res_unit(p, x, dilation),
                snake_residual_unit_pallas(p, x, dilation, interpret=True)):
        ref = np.asarray(ref)
        assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
