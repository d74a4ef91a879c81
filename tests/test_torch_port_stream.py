"""The rest of ``generate``'s surface in the port against the JAX package, on
the CPU: an audio prefix (DAC codes of a voice to continue) and streaming.

The same random weights (JAX init, cast to fp32) go through
``zonos_tpu_torch.convert`` into the port.  Covered: greedy ``generate``
with ``audio_prefix_codes`` on the tiny transformer and the tiny hybrid, at
cfg_scale 2.0 and 1.0 (codes identical, the prefix cut off); the port's
``stream_generate`` against its own full decode (5e-3 x scale, JAX's own
tolerance in tests/test_streaming.py) and against JAX's stream, chunk for
chunk (1e-4 x scale); ``stream_generate_batch`` per row with step limits and
a padding row; and the margin check.  The codec is a small DAC with the
full one's hop of 512 samples (three downsampling ratios of 8; a receptive
half-width of 11 frames), since both streams cut windows at 512 samples a
frame.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.dac import DACAutoencoder as JaxDACAutoencoder
from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
from zonos_tpu.models.dac.codec import init_dac_params as jax_init_dac_params
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_dac_params, convert_zonos_params
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops.sampling import SamplingParams

MAX_NEW = 12
PREFIX_FRAMES = 7
STREAM_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
TINY_BACKBONES = {
    "transformer": (TRANSFORMER_CONFIG_DICT,
                    {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                     "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}),
    "hybrid": (HYBRID_CONFIG_DICT,
               {"d_model": 64, "n_layer": 3, "attn_layer_idx": [1], "attn_mlp_d_intermediate": 128,
                "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16,
                            "d_conv": 4, "ngroups": 1},
                "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                             "rotary_emb_dim": 8}}),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _config_dict(kind: str) -> dict:
    base, backbone = TINY_BACKBONES[kind]
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(backbone))
    return d


def _pair(kind: str):
    """(JAX model, port model) with the same fp32 weights."""
    jm = JaxZonos(JaxZonosConfig.from_dict(_config_dict(kind)), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_config_dict(kind)),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    return jm, tm


def _prefix(rows: int, seed: int) -> np.ndarray:
    """A conditioning prefix [2 * rows, 4, 64], small normal values."""
    return (np.random.default_rng(seed).normal(size=(2 * rows, 4, 64)) * 0.1).astype(np.float32)


def _audio_prefix(rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1024, size=(rows, 9, PREFIX_FRAMES))


@pytest.fixture(scope="module")
def transformer():
    jm, tm = _pair("transformer")
    jcfg = JaxDACConfig(**STREAM_DAC)
    jparams = jax.tree.map(np.asarray, jax_init_dac_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(1)
    for block in jparams["decoder"]["blocks"]:  # non-unit snakes: the windows see real context
        for unit in ("res1", "res2", "res3"):
            block[unit]["alpha1"] = rng.uniform(0.5, 1.5, size=block[unit]["alpha1"].shape)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    jm._autoencoder = JaxDACAutoencoder(params=jparams, cfg=jcfg)
    tm._autoencoder = DACAutoencoder(params=convert_dac_params(jparams), cfg=DACConfig(**STREAM_DAC),
                                     device="cpu")
    assert tm.autoencoder.receptive_field_frames == jm.autoencoder.receptive_field_frames == 11
    return jm, tm


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
@pytest.mark.parametrize("kind", ["transformer", "hybrid"])
def test_prefix_generate_matches_jax(kind, cfg_scale, transformer):
    jm, tm = transformer if kind == "transformer" else _pair(kind)
    prefix, codes = _prefix(2, 4), _audio_prefix(2, 5)
    kw = dict(max_new_tokens=MAX_NEW, cfg_scale=cfg_scale, batch_size=2)
    ref = jm.generate(jnp.asarray(prefix), audio_prefix_codes=codes, progress_bar=False,
                      sampling_params=JaxSamplingParams.greedy(), **kw)
    ours = tm.generate(prefix_conditioning=_t(prefix), audio_prefix_codes=codes,
                       sampling_params=SamplingParams.greedy(), **kw)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.shape[0] == 9 and 1 <= a.shape[1] <= MAX_NEW
        np.testing.assert_array_equal(a, b)
    # the prefix steers the continuation: without it the codes differ
    bare = tm.generate(_t(prefix), sampling_params=SamplingParams.greedy(), **kw)
    assert any(a.shape != b.shape or not np.array_equal(a, b) for a, b in zip(ours, bare))


def test_prefix_generate_rejects_a_misshapen_prefix(transformer):
    _, tm = transformer
    with pytest.raises(ValueError, match="audio_prefix_codes"):
        tm.generate(_t(_prefix(1, 0)), audio_prefix_codes=np.zeros((1, 8, 3), np.int64),
                    max_new_tokens=4)


def _decode_full(dac, codes: np.ndarray) -> np.ndarray:
    return dac.decode(codes[None])[0, 0]


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
def test_stream_matches_full_decode_and_jax(transformer, cfg_scale):
    """Batch 1 with an audio prefix: the port's chunks concatenate to the full
    decode of its own codes, and equal JAX's stream chunk for chunk."""
    jm, tm = transformer
    prefix, codes = _prefix(1, 8), _audio_prefix(1, 9)
    kw = dict(max_new_tokens=40, cfg_scale=cfg_scale, seed=11, chunk_frames=12,
              margin_frames=16, audio_prefix_codes=codes)
    ours = list(tm.stream_generate(_t(prefix), sampling_params=SamplingParams.greedy(), **kw))
    ref = list(jm.stream_generate(jnp.asarray(prefix), sampling_params=JaxSamplingParams.greedy(),
                                  **kw))
    assert len(ours) >= 2
    full_codes = tm.generate(_t(prefix), audio_prefix_codes=codes, max_new_tokens=40,
                             cfg_scale=cfg_scale, sampling_params=SamplingParams.greedy())[0]
    full = _decode_full(tm.autoencoder, full_codes)
    streamed = np.concatenate(ours)
    scale = max(np.abs(full).max(), 1e-6)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, rtol=0, atol=5e-3 * scale)
    assert [c.shape for c in ours] == [np.asarray(c).shape for c in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4 * scale)
    assert tm.decode_stats["steps"] >= full_codes.shape[1]


def test_stream_batch_matches_full_decode_per_row(transformer):
    """Three rows in one decode with per-row step limits, so that they end at
    different chunks, and a padding row (``active_rows`` False) that yields
    nothing: each live row's chunks concatenate to the full decode of its
    codes, and some chunk carries two rows."""
    _, tm = transformer
    B, limits, active = 4, [17, 40, 29, 40], [True, True, True, False]
    prefix = _t(_prefix(B, 5))
    kw = dict(max_new_tokens=40, seed=11, sampling_params=SamplingParams.greedy())
    per_row: dict[int, list[np.ndarray]] = {i: [] for i in range(B)}
    sizes = []
    for events in tm.stream_generate_batch(prefix, chunk_frames=12, margin_frames=16,
                                           batch_size=B, step_limits=limits,
                                           active_rows=active, **kw):
        sizes.append(len(events))
        for row, chunk in events:
            per_row[row].append(chunk)
    assert not per_row[3]
    codes = tm.generate(prefix, batch_size=B, step_limits=limits, **kw)
    for i in range(3):
        full = _decode_full(tm.autoencoder, codes[i])
        streamed = np.concatenate(per_row[i])
        assert streamed.shape == full.shape, f"row {i}"
        scale = max(np.abs(full).max(), 1e-6)
        np.testing.assert_allclose(streamed, full, rtol=0, atol=5e-3 * scale, err_msg=f"row {i}")
    assert max(sizes) > 1


def test_stream_rejects_margin_below_receptive_field_and_batch(transformer):
    _, tm = transformer
    with pytest.raises(ValueError, match="receptive"):
        next(tm.stream_generate(_t(_prefix(1, 0)), chunk_frames=8, margin_frames=10))
    with pytest.raises(ValueError, match="batch_size=1"):
        next(tm.stream_generate(_t(_prefix(2, 0))))
    with pytest.raises(ValueError, match="batch_size"):
        next(tm.stream_generate_batch(_t(_prefix(2, 0)), batch_size=3))
