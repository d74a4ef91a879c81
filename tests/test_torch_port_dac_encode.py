"""The port's DAC encoder side against the JAX package and the HF
``DacModel``, on the CPU.

Covered: ``dac_encode_latents`` and ``dac_encode`` on a tiny DAC whose JAX
weights go through ``convert_dac_params`` (latents within 1e-4 x max|ref|,
codes identical); the same on the HF ``DacModel`` with random weights
(``tests/test_dac.py``'s oracle, its state dict converted by the JAX
package's converter); ``preprocess`` equal to JAX's; and
``load_prefix_audio`` on a wav file, read twice to the same codes and equal
to JAX's.  The encoder's residual units go through K5's wrapper, its plain
version here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.models.dac import DACAutoencoder as JaxDACAutoencoder
from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
from zonos_tpu.models.dac.codec import dac_encode as jax_dac_encode
from zonos_tpu.models.dac.codec import dac_encode_latents as jax_dac_encode_latents
from zonos_tpu.models.dac.codec import init_dac_params as jax_init_dac_params
from zonos_tpu_torch import DACAutoencoder
from zonos_tpu_torch.audio import save_audio
from zonos_tpu_torch.convert import convert_dac_params
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.models.dac.codec import DACConfig, dac_encode, dac_encode_latents

TINY_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(2, 2), decoder_hidden_size=32)
HF_TINY = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
               n_codebooks=3, codebook_size=16, codebook_dim=4)


def _rescaled(params: dict, seed: int) -> dict:
    """Unit-variance convolutions and snakes of non-unit alpha, so that the
    encoder's activations are not near zero."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif isinstance(val, list):
                for item in val:
                    walk(item)
            elif key == "w":
                k, cin, _ = val.shape
                tree[key] = (rng.normal(size=val.shape) / np.sqrt(k * cin)).astype(np.float32)
            elif key.startswith("alpha"):
                tree[key] = rng.uniform(0.5, 1.5, size=val.shape).astype(np.float32)
            elif key == "codebook":
                tree[key] = rng.normal(size=val.shape).astype(np.float32)

    params = jax.tree.map(np.asarray, params)
    walk(params)
    return params


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxDACConfig(**TINY_DAC)
    jparams = _rescaled(jax_init_dac_params(jax.random.key(5), jcfg), 2)
    return jcfg, jparams, convert_dac_params(jparams), DACConfig(**TINY_DAC)


@pytest.mark.parametrize("frames", [1, 6, 23])
def test_encode_matches_jax(tiny, frames):
    jcfg, jparams, tparams, tcfg = tiny
    audio = (np.random.default_rng(frames).normal(size=(2, tcfg.hop_length * frames, 1)) * 0.3
             ).astype(np.float32)
    ref = np.asarray(jax_dac_encode_latents(jparams, jcfg, jnp.asarray(audio)))
    before = dict(launch_counts)
    ours = dac_encode_latents(tparams, tcfg, torch.from_numpy(audio)).numpy()
    assert launch_counts == before  # K5's plain version on the CPU
    assert ours.shape == ref.shape == (2, frames, tcfg.hidden_size)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
    ref_codes = np.asarray(jax_dac_encode(jparams, jcfg, jnp.asarray(audio)))
    codes = dac_encode(tparams, tcfg, torch.from_numpy(audio)).numpy()
    assert codes.shape == (2, 9, frames)
    np.testing.assert_array_equal(codes, ref_codes)
    assert len(np.unique(codes[:, 0])) > 1 or frames == 1  # not one code everywhere


@pytest.fixture(scope="module")
def hf_model():
    pytest.importorskip("transformers")
    from transformers.models.dac import DacConfig as HFDacConfig, DacModel

    from zonos_tpu.models.dac.convert import convert_dac_state_dict

    hf_cfg = HFDacConfig(**{**HF_TINY, "downsampling_ratios": list(HF_TINY["downsampling_ratios"])},
                         sampling_rate=44100)
    torch.manual_seed(0)
    model = DacModel(hf_cfg).eval()
    jparams = convert_dac_state_dict(model.state_dict(), JaxDACConfig(**HF_TINY))
    return model, convert_dac_params(jparams), DACConfig(**HF_TINY)


def test_encoder_matches_hf_dac(hf_model):
    model, params, cfg = hf_model
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(2, 1, cfg.hop_length * 6)).astype(np.float32) * 0.1
    with torch.no_grad():
        ref = model.encoder(torch.from_numpy(audio)).numpy()  # [B, H, T']
        ours = dac_encode_latents(params, cfg, torch.from_numpy(audio).transpose(1, 2)).numpy()
    np.testing.assert_allclose(ours.transpose(0, 2, 1), ref, rtol=1e-4, atol=1e-5)


def test_codes_match_hf_dac(hf_model):
    model, params, cfg = hf_model
    audio = np.random.default_rng(1).normal(size=(1, 1, cfg.hop_length * 8)).astype(np.float32)
    audio *= 0.1
    with torch.no_grad():
        ref = model.encode(torch.from_numpy(audio)).audio_codes.numpy()
    dac = DACAutoencoder(params=params, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(dac.encode(audio), ref)


@pytest.mark.parametrize("sr,samples", [(24000, 24000), (16000, 12345), (44100, 3001)])
def test_preprocess_matches_jax(tiny, sr, samples):
    _, jparams, tparams, tcfg = tiny
    wav = (np.random.default_rng(samples).normal(size=(1, samples)) * 0.2).astype(np.float32)
    ref = JaxDACAutoencoder(params=jparams, cfg=JaxDACConfig(**TINY_DAC)).preprocess(wav, sr)
    ours = DACAutoencoder(params=tparams, cfg=tcfg, device="cpu").preprocess(wav, sr)
    assert ours.shape == ref.shape and ours.shape[-1] % tcfg.hop_length == 0
    np.testing.assert_array_equal(ours, ref)


def test_load_prefix_audio_matches_jax(tiny, tmp_path):
    """A stereo 24 kHz clip written as 16-bit wav: read, averaged to mono,
    resampled, left-padded and encoded; twice the same codes, equal to JAX's,
    one frame a hop of 44.1 kHz samples."""
    jcfg, jparams, tparams, tcfg = tiny
    t = np.arange(24000 // 4) / 24000
    wav = np.stack([0.4 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    path = str(tmp_path / "prefix.wav")
    save_audio(path, wav.astype(np.float32), 24000)
    dac = DACAutoencoder(params=tparams, cfg=tcfg, device="cpu")
    codes = dac.load_prefix_audio(path)
    assert codes.shape == (1, 9, -(-11025 // tcfg.hop_length))
    np.testing.assert_array_equal(dac.load_prefix_audio(path), codes)
    ref = JaxDACAutoencoder(params=jparams, cfg=jcfg).load_prefix_audio(path)
    np.testing.assert_array_equal(codes, ref)
