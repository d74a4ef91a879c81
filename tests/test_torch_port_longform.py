"""Long-form synthesis in the port (``zonos_tpu_torch.longform``) against the
JAX package's (``zonos_tpu.longform``), on the CPU.

Sentence splitting and duration packing equal JAX's on the cases of
``tests/test_longform.py``.  The same random weights (JAX init, cast to
fp32) go through ``zonos_tpu_torch.convert``, and the same small DAC (the
full hop of 512 samples) through ``convert_dac_params``: the greedy
``synthesize_long`` at a 1-s budget and a carry of 8 frames gives each
segment's codes identical to JAX's and a waveform within 1e-4 x max|ref|.
Also: ``initial_prefix_codes`` seeds the first segment, empty text raises,
a ``step_callback`` that raises aborts the synthesis, and the codec's
``trim_silence`` / ``normalize_loudness`` methods equal JAX's.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401
from zonos_tpu import longform as jax_longform
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.dac import DACAutoencoder as JaxDACAutoencoder
from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
from zonos_tpu.models.dac.codec import init_dac_params as jax_init_dac_params
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig
from zonos_tpu_torch import longform
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_dac_params, convert_zonos_params
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops.sampling import SamplingParams

SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
TEXT = ("The first sentence runs here. Then a second one follows. "
        "Finally a third sentence ends it.")
MAX_NEW = 40
SPLIT_CASES = [
    "Hello world. How are you? Fine! Done…",
    "Dr. Smith met J. Doe. They talked.",
    "See fig. 3 for details. Then stop.",
    "no punctuation at all",
    "",
    "Mr. and Mrs. Jones live at St. James St. in town.  Really?  Yes!",
]
PACK_CASES = [
    ([f"sentence number {i} is here." for i in range(10)], 15.0, 4.0),
    (["word " * 200], 15.0, 3.0),
    (["A short one.", "Another short one.", "x" * 300], 12.0, 5.0),
]


def _tiny_dict() -> dict:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return d


@pytest.fixture(scope="module")
def models():
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict()),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    jcfg = JaxDACConfig(**SMALL_DAC)
    jparams = jax.tree.map(np.asarray, jax_init_dac_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(1)
    for block in jparams["decoder"]["blocks"]:  # non-unit snakes
        for unit in ("res1", "res2", "res3"):
            block[unit]["alpha1"] = rng.uniform(0.5, 1.5, size=block[unit]["alpha1"].shape)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    jm._autoencoder = JaxDACAutoencoder(params=jparams, cfg=jcfg)
    tm._autoencoder = DACAutoencoder(params=convert_dac_params(jparams),
                                     cfg=DACConfig(**SMALL_DAC), device="cpu")
    return jm, tm


@pytest.mark.parametrize("text", SPLIT_CASES)
def test_split_sentences_matches_jax(text):
    assert longform.split_sentences(text) == jax_longform.split_sentences(text)


@pytest.mark.parametrize("sentences,rate,budget", PACK_CASES)
def test_pack_segments_matches_jax(sentences, rate, budget):
    ours = longform.pack_segments(sentences, speaking_rate=rate, max_segment_seconds=budget)
    assert ours == jax_longform.pack_segments(sentences, speaking_rate=rate,
                                              max_segment_seconds=budget)
    counts = [len(s) // 2 for s in sentences]
    assert longform.pack_segments(sentences, rate, budget, phoneme_counts=counts) == \
        jax_longform.pack_segments(sentences, rate, budget, phoneme_counts=counts)


def test_segment_texts_matches_jax():
    assert longform.segment_texts(TEXT, max_segment_seconds=1.0) == \
        jax_longform.segment_texts(TEXT, max_segment_seconds=1.0)


def test_greedy_synthesize_long_matches_jax(models):
    jm, tm = models
    kw = dict(language="en-us", cfg_scale=2.0, seed=7, max_segment_seconds=1.0,
              carry_frames=8, max_new_tokens=MAX_NEW)
    ref_wav, ref_codes = jax_longform.synthesize_long(
        jm, TEXT, sampling_params=JaxSamplingParams.greedy(), **kw)
    wav, codes = longform.synthesize_long(tm, TEXT, sampling_params=SamplingParams.greedy(), **kw)
    assert len(codes) == len(ref_codes) >= 2
    for a, b in zip(codes, ref_codes):
        assert a.shape == b.shape and a.shape[0] == 9
        np.testing.assert_array_equal(a, b)
    assert wav.shape == ref_wav.shape == (sum(c.shape[1] for c in codes) * 512,)
    scale = float(np.abs(ref_wav).max())
    assert scale > 0
    np.testing.assert_allclose(wav, ref_wav, rtol=0, atol=1e-4 * scale)


def test_initial_prefix_codes_seed_the_first_segment(models):
    _, tm = models
    calls = []
    real = tm.generate

    def spy(prefix_cond, **kw):
        calls.append(kw.get("audio_prefix_codes"))
        return real(prefix_cond, **kw)

    tm.generate = spy
    try:
        init = np.random.default_rng(0).integers(0, 1024, size=(1, 9, 5))
        wav, codes = longform.synthesize_long(tm, "Only one short sentence.", max_new_tokens=30,
                                              seed=3, initial_prefix_codes=init)
    finally:
        del tm.generate
    assert len(calls) == len(codes) == 1
    assert calls[0].shape == (1, 9, 5)
    np.testing.assert_array_equal(calls[0][0], init[0])
    assert wav.shape[-1] == sum(c.shape[-1] for c in codes) * 512
    assert np.isfinite(wav).all()


def test_empty_text_raises(models):
    _, tm = models
    with pytest.raises(ValueError, match="no text"):
        longform.synthesize_long(tm, "   ")


def test_step_callback_that_raises_aborts(models):
    _, tm = models
    seen = []

    class Cancelled(Exception):
        pass

    def step_callback(seg, n_seg, step, total):
        seen.append((seg, n_seg, step, total))
        raise Cancelled

    with pytest.raises(Cancelled):
        longform.synthesize_long(tm, TEXT, max_segment_seconds=1.0, max_new_tokens=MAX_NEW,
                                 step_callback=step_callback)
    assert seen == [(0, len(longform.segment_texts(TEXT, max_segment_seconds=1.0)), 32,
                     MAX_NEW + 8)]


def test_step_callback_false_stops_a_segment(models):
    """A step_callback returning False ends each segment's decode at its first
    chunk boundary; every segment is still synthesized."""
    _, tm = models
    seen = []
    wav, codes = longform.synthesize_long(
        tm, TEXT, max_segment_seconds=1.0, max_new_tokens=MAX_NEW,
        step_callback=lambda *a: seen.append(a) or False)
    n = len(longform.segment_texts(TEXT, max_segment_seconds=1.0))
    assert [a[0] for a in seen] == list(range(n)) and all(a[2] == 32 for a in seen)
    assert len(codes) == n and all(c.shape[1] <= 32 - 8 for c in codes)


def test_codec_post_processing_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(5)
    wav = np.concatenate([np.zeros((1, 2048)), rng.normal(size=(1, 44100)) * 0.1,
                          np.zeros((1, 4096))], axis=1).astype(np.float32)
    np.testing.assert_array_equal(tm.autoencoder.trim_silence(wav),
                                  jm.autoencoder.trim_silence(wav))
    for target in (-19.0, -23.0):
        np.testing.assert_allclose(tm.autoencoder.normalize_loudness(wav, 44100, target),
                                   jm.autoencoder.normalize_loudness(wav, 44100, target),
                                   rtol=1e-6, atol=0)
