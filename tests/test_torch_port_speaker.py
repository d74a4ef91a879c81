"""Voice cloning in the port, held against the JAX package on the CPU: the
SimAM ResNet293 speaker tower (a [2,2,2,2] tower at in_planes 8 and the full
[10,20,64,3] layout) from reference-named state dicts with random weights and
BatchNorm statistics, the LDA head, the mel front end, ``SpeakerEmbeddingLDA``
end to end from a 24-kHz wav through the models directory, ECAPA-TDNN, the
voice DB (its XXH3-64 keys, caches written by either package) and
``make_speaker_embedding`` -> ``make_cond_dict(speaker=...)`` -> greedy codes
on the tiny transformer and hybrid.

The JAX converter reads the tower's block counts from a module constant;
these tests set it for the small tower, as tests/test_speaker_parity.py does.
"""

from __future__ import annotations

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zonos_tpu.models.speaker.convert as jax_speaker_convert
from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.speaker import SpeakerEmbeddingLDA as JaxSpeakerEmbeddingLDA
from zonos_tpu.models.speaker.ecapa import ecapa_forward as jax_ecapa_forward
from zonos_tpu.models.speaker.ecapa import init_ecapa_params as jax_init_ecapa
from zonos_tpu.models.speaker.mel import log_mel_features as jax_log_mel
from zonos_tpu.models.speaker.resnet import speaker_embed_forward as jax_speaker_forward
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu.speaker_db import SpeakerUtils as JaxSpeakerUtils
from zonos_tpu_torch import SpeakerEmbeddingLDA, SpeakerUtils, Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.audio import save_audio
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import (
    convert_ecapa_params,
    convert_speaker_params,
    convert_zonos_params,
)
from zonos_tpu_torch.models.speaker.convert import (
    convert_lda_state_dict,
    convert_speaker_state_dict,
    random_reference_state_dicts,
    tower_blocks,
)
from zonos_tpu_torch.models.speaker.ecapa import ecapa_forward, init_ecapa_params
from zonos_tpu_torch.models.speaker.mel import log_mel_features
from zonos_tpu_torch.models.speaker.resnet import speaker_embed_forward
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.speaker_db import hash_audio_file, main as db_main
from zonos_tpu_torch.utils.xxh3 import xxh3_64_hexdigest

SMALL = dict(in_planes=8, blocks=(2, 2, 2, 2))
GREEDY_FRAMES = 24


def _jax_tower(sd: dict, blocks, monkeypatch) -> dict:
    monkeypatch.setattr(jax_speaker_convert, "RESNET293_BLOCKS", tuple(blocks))
    return jax_speaker_convert.convert_speaker_state_dict(sd)


def _wav_24k(seconds: float = 1.5, seed: int = 0) -> np.ndarray:
    """A tone plus noise at 24 kHz, [1, samples]."""
    t = np.arange(int(24000 * seconds)) / 24000
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise).astype(np.float32)[None]


# ---------------------------------------------------------------------------
# The tower, the LDA and the mel front end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["small", "resnet293"])
def test_tower_matches_jax(size, monkeypatch):
    """Reference-named weights with random BatchNorm statistics through each
    package's converter and forward; the port's also from the JAX pytree."""
    if size == "small":
        kw, mel_shape, atol = dict(SMALL, acoustic_dim=16, embd_dim=32), (2, 16, 24), 2e-4
    else:  # the shapes ResNet293_SimAM_ASP_base.pt carries, at 24 frames
        kw, mel_shape, atol = dict(in_planes=64, blocks=(10, 20, 64, 3)), (1, 80, 24), 5e-4
    sd, _ = random_reference_state_dicts(torch.Generator().manual_seed(2), **kw)
    assert tower_blocks(sd) == kw["blocks"]
    mel = np.random.default_rng(3).standard_normal(mel_shape).astype(np.float32)
    jparams = _jax_tower(sd, kw["blocks"], monkeypatch)
    fwd = jax.jit(jax_speaker_forward) if size == "small" else jax_speaker_forward
    ref = np.asarray(fwd(jparams, jnp.asarray(mel)))
    with torch.inference_mode():
        got = speaker_embed_forward(convert_speaker_state_dict(sd), torch.from_numpy(mel)).numpy()
        via_jax = speaker_embed_forward(convert_speaker_params(jax.tree.map(np.asarray, jparams)),
                                        torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(via_jax, ref, rtol=1e-4, atol=atol)
    assert np.abs(ref).max() > 10 * atol  # not a comparison of near-zeros


def test_lda_matches_jax():
    _, lda = random_reference_state_dicts(torch.Generator().manual_seed(4), **SMALL)
    emb = np.random.default_rng(5).standard_normal((3, 256)).astype(np.float32)
    jp = jax_speaker_convert.convert_lda_state_dict(lda)
    ref = emb @ jp["w"] + jp["b"]
    p = convert_lda_state_dict(lda)
    got = (torch.from_numpy(emb) @ p["w"] + p["b"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_mel_matches_jax():
    wav = (np.random.default_rng(6).standard_normal((2, 21000)) * 0.3).astype(np.float32)
    ref = jax_log_mel(wav)
    got = log_mel_features(wav)
    assert got.shape == ref.shape == (2, 80, 132) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.fixture
def speaker_models_dir(tmp_path, monkeypatch):
    """A small tower's and the LDA head's reference ``.pt`` files under
    ``Zyphra/Zonos-v0.1-speaker-embedding`` in a models directory."""
    sd, lda = random_reference_state_dicts(torch.Generator().manual_seed(8), **SMALL)
    repo = tmp_path / "Zyphra" / "Zonos-v0.1-speaker-embedding"
    repo.mkdir(parents=True)
    torch.save(sd, repo / "ResNet293_SimAM_ASP_base.pt")
    torch.save(lda, repo / "ResNet293_SimAM_ASP_base_LDA-128.pt")
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(jax_speaker_convert, "RESNET293_BLOCKS", SMALL["blocks"])
    return sd, lda


def test_speaker_embedding_lda_from_the_models_dir_matches_jax(speaker_models_dir):
    """Both packages read the same reference ``.pt`` files and embed the same
    24-kHz clip (mono, resampled to 16 kHz, mel, tower, LDA)."""
    wav = np.concatenate([_wav_24k(), _wav_24k(seed=1)])  # stereo: averaged to mono
    ref_emb, ref_lda = JaxSpeakerEmbeddingLDA()(wav, 24000)
    emb, lda = SpeakerEmbeddingLDA(device="cpu")(wav, 24000)
    assert emb.shape == (1, 256) and lda.shape == (1, 128)
    assert np.abs(emb - ref_emb).max() <= 1e-4 * np.abs(ref_emb).max()
    assert np.abs(lda - ref_lda).max() <= 1e-4 * np.abs(ref_lda).max()


def test_speaker_embedding_without_files_warns_and_uses_a_seeded_init(tmp_path, monkeypatch,
                                                                      caplog):
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr("zonos_tpu_torch.models.speaker.init_speaker_params",
                        lambda gen, device: _small_init(gen, device))
    a, b = SpeakerEmbeddingLDA(device="cpu"), SpeakerEmbeddingLDA(device="cpu")
    assert "speaker checkpoint not found" in caplog.text and "LDA checkpoint" in caplog.text
    wav = _wav_24k(0.5)
    np.testing.assert_array_equal(a(wav, 24000)[1], b(wav, 24000)[1])
    jrng = np.random.default_rng(0)  # the JAX package's LDA fallback, drawn the same way
    np.testing.assert_array_equal(a.lda["w"].numpy(),
                                  (jrng.standard_normal((256, 128)) / 16).astype(np.float32))


def _small_init(gen, device):
    from zonos_tpu_torch.models.speaker.resnet import init_speaker_params

    return init_speaker_params(gen, device=device, **SMALL)


# ---------------------------------------------------------------------------
# ECAPA-TDNN
# ---------------------------------------------------------------------------


def test_ecapa_matches_jax():
    """Random weights in the JAX init's layout (its shapes by ``eval_shape``),
    non-identity BatchNorms and non-zero biases, at C 64."""
    rng = np.random.default_rng(9)

    def draw(path, leaf):
        name = str(path[-1])
        if leaf.ndim >= 2:  # conv [K, C_in, C_out] and matrix [in, out]
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                    ).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    shapes = jax.eval_shape(lambda: jax_init_ecapa(jax.random.key(0), C=64))
    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    mel = rng.standard_normal((2, 80, 50)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_ecapa_forward)(jparams, jnp.asarray(mel)))
    with torch.inference_mode():
        got = ecapa_forward(convert_ecapa_params(jparams), torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 192)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    # the port's own init has the JAX init's layout
    ours = init_ecapa_params(torch.Generator().manual_seed(0), C=64)
    want = convert_ecapa_params(jparams)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for x, y in zip(jax.tree.leaves(ours), jax.tree.leaves(want)):
        assert x.shape == y.shape


# ---------------------------------------------------------------------------
# The voice DB
# ---------------------------------------------------------------------------


def test_xxh3_matches_xxhash(tmp_path):
    xxhash = pytest.importorskip("xxhash")
    rng = np.random.default_rng(10)
    for n in [*range(0, 261), *range(1024, 1101)]:  # every branch of the algorithm
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh3_64_hexdigest(data) == xxhash.xxh3_64(data).hexdigest(), n
    path = tmp_path / "clip.bin"
    path.write_bytes(rng.integers(0, 256, 2 * 2**20 + 13, dtype=np.uint8).tobytes())
    assert hash_audio_file(str(path)) == xxhash.xxh3_64(path.read_bytes()).hexdigest()


def test_voice_cache_is_shared_with_jax(tmp_path, monkeypatch):
    pytest.importorskip("xxhash")
    from zonos_tpu.speaker_db import hash_audio_file as jax_hash

    store = tmp_path / ".voices"
    jdb, tdb = JaxSpeakerUtils(embed_store_dir=store), SpeakerUtils(embed_store_dir=store)
    rng = np.random.default_rng(11)
    embs = [rng.standard_normal((1, 1, 128)).astype(np.float32) for _ in range(4)]
    jdb.save_embedding("0123456789abcdef", embs[0], {"gender": "f", "lang": "en"})
    tdb.save_embedding("fedcba9876543210", embs[1], {"gender": "f", "lang": "de"})
    jdb.save_embedding("00000000000000aa", embs[2], {"gender": "m"})
    np.testing.assert_array_equal(tdb.load_embedding_if_exists("0123456789abcdef"), embs[0])
    np.testing.assert_array_equal(jdb.load_embedding_if_exists("fedcba9876543210"), embs[1])
    for tags in ({"gender": "f"}, {"gender": "m"}, {"lang": "de"}):
        np.testing.assert_array_equal(tdb.load_average(tags), jdb.load_average(tags))
    with pytest.raises(ValueError):
        tdb.load_average({"gender": "x"})

    class Stub:  # make_speaker_embedding without a tower
        def make_speaker_embedding(self, wav, sr):
            return embs[3]

    wav_path = tmp_path / "voice.wav"
    save_audio(str(wav_path), _wav_24k(0.3)[0], 24000)
    assert hash_audio_file(str(wav_path)) == jax_hash(str(wav_path))
    got = SpeakerUtils(Stub(), embed_store_dir=store).get_speaker_embedding(str(wav_path))
    np.testing.assert_array_equal(got, embs[3])
    np.testing.assert_array_equal(jdb.get_speaker_embedding(str(wav_path)), embs[3])  # JAX's hit
    assert SpeakerUtils.random_sentence("fr") in SpeakerUtils.SENTENCES["en"]
    assert SpeakerUtils.random_sentence("de_DE") in SpeakerUtils.SENTENCES["de"]

    monkeypatch.chdir(tmp_path)  # the CLI's store is ./.voices
    db_main(["average", json.dumps({"gender": "f"}), "--out", "avg.npy"])
    np.testing.assert_array_equal(np.load(tmp_path / "avg.npy"), jdb.load_average({"gender": "f"}))


# ---------------------------------------------------------------------------
# make_speaker_embedding -> make_cond_dict -> greedy codes
# ---------------------------------------------------------------------------


def _tiny_dict(kind: str) -> dict:
    if kind == "transformer":
        d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
        d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                              "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
        return d
    d = copy.deepcopy(HYBRID_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 3, "attn_layer_idx": [1],
                          "attn_mlp_d_intermediate": 128,
                          "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2,
                                      "headdim": 16, "d_conv": 4, "ngroups": 1},
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                                       "rotary_emb_dim": 8}})
    return d


@pytest.mark.parametrize("kind", ["transformer", "hybrid"])
def test_cloned_voice_greedy_codes_match_jax(kind, speaker_models_dir):
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict(kind)), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict(kind)),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    wav = _wav_24k(seed=12)
    jspk = jm.make_speaker_embedding(wav, 24000)  # both towers from the models dir
    tspk = tm.make_speaker_embedding(wav, 24000)
    assert tspk.shape == (1, 1, 128) and tspk.dtype == np.float32
    assert np.abs(tspk - jspk).max() <= 1e-4 * np.abs(jspk).max()
    jp = jm.prepare_conditioning(jax_make_cond_dict(text="Hello world.", speaker=jspk))
    tp = tm.prepare_conditioning(make_cond_dict(text="Hello world.", speaker=tspk))
    ref = jm.generate(jp, max_new_tokens=GREEDY_FRAMES, cfg_scale=2.0,
                      sampling_params=JaxSamplingParams.greedy(), progress_bar=False)
    ours = tm.generate(tp, max_new_tokens=GREEDY_FRAMES, cfg_scale=2.0,
                       sampling_params=SamplingParams.greedy())
    assert ours[0].shape == ref[0].shape
    np.testing.assert_array_equal(ours[0], ref[0])
