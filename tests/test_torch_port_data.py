"""The port's data pipeline, train state and training CLI
(``zonos_tpu_torch/data``, ``utils/train_state.py``, ``apps/train_cli.py``)
against the JAX package's, on the CPU.

Covered: the manifest and directory readers give JAX's examples;
``prepare_examples`` with one injected autoencoder gives JAX's phonemes,
codes and conditioning values; ``assemble_batch``, ``iter_epoch_batches`` and
``PrefetchLoader`` (with a start-step resume) give JAX's batches bit for bit;
the code cache hits with an injected autoencoder (the port's tiny DAC) and
keeps its codec tag apart from JAX's; a train state's save and restore keeps
the 3 newest; ``train_cli --device cpu --tiny`` trains, resumes, validates,
runs LoRA and exports weights that ``Zonos.from_local`` loads.  All
comparisons are exact.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import shutil

import numpy as np
import pytest
import torch

from zonos_tpu import data as jdata
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch import data as tdata
from zonos_tpu_torch.audio.io import save_audio
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.models.dac import DACAutoencoder
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.utils import train_state

TINY_DAC = DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=16,
                     n_codebooks=9, codebook_size=16, codebook_dim=4, sampling_rate=8000)
TEXTS = [
    "hello world",
    "the quick brown fox",
    "testing one two three",
    "a longer sentence to make the phoneme lengths differ quite a bit more",
    "short",
    "one more clip",
]
FRAME_RATE = TINY_DAC.sampling_rate / 8


def _tiny_dict() -> dict:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return d


class FakeDAC:
    """An autoencoder both packages' caches accept: codes from the waveform's
    64-sample block sums, 9 codebooks."""

    def preprocess(self, wav, sr):
        return np.asarray(wav, np.float32)

    def encode(self, wav):
        w = np.asarray(wav, np.float64)[0, 0]
        T = w.shape[-1] // 64
        base = (np.abs(w[:T * 64]).reshape(T, 64).sum(-1) * 1000).astype(np.int64)
        return ((base[None, :] + 37 * np.arange(9)[:, None]) % 1024)[None]


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """LJSpeech-layout dataset of short sine clips at 8 kHz."""
    root = tmp_path_factory.mktemp("ljs")
    (root / "wavs").mkdir()
    rows = []
    rng = np.random.default_rng(0)
    for i, text in enumerate(TEXTS):
        n = 8000 // 4 + i * 512
        t = np.arange(n) / 8000.0
        wav = 0.3 * np.sin(2 * np.pi * (110 + 50 * i) * t) + 0.01 * rng.normal(size=n)
        save_audio(str(root / "wavs" / f"clip{i}.wav"), wav.astype(np.float32), 8000)
        rows.append(f"clip{i}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def specs():
    jspecs = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0).specs
    return jspecs, Zonos(ZonosConfig.from_dict(_tiny_dict()), device="cpu").specs


@pytest.fixture(scope="module")
def prepared(dataset_dir, tmp_path_factory):
    """Both packages' prepared examples from one injected autoencoder."""
    out = []
    for pkg, tag in ((jdata, "fake-jax"), (tdata, "fake-torch")):
        cache = pkg.CodesCache(FakeDAC(), tmp_path_factory.mktemp(tag), codec_tag=tag)
        out.append(pkg.prepare_examples(pkg.scan_ljspeech(dataset_dir), cache,
                                        frame_rate=FRAME_RATE))
        assert cache.encode_calls == len(TEXTS)
    return out


def _same_examples(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_readers_match_jax(dataset_dir, tmp_path):
    _same_examples(tdata.scan_ljspeech(dataset_dir), jdata.scan_ljspeech(dataset_dir))
    for i in range(2):
        shutil.copy(dataset_dir / "wavs" / f"clip{i}.wav", tmp_path / f"c{i}.wav")
        (tmp_path / f"c{i}.txt").write_text(TEXTS[i])
    _same_examples(tdata.scan_dir(tmp_path), jdata.scan_dir(tmp_path))
    man = tmp_path / "data.jsonl"
    man.write_text(
        json.dumps({"audio": "c0.wav", "text": "hi", "speaking_rate": 12.5}) + "\n\n"
        + json.dumps({"audio": "c1.wav", "text": "yo", "language": "de",
                      "emotion": [1, 0, 0, 0, 0, 0, 0, 0], "speaker_wav": "c0.wav"}) + "\n")
    ours = tdata.read_manifest(man)
    _same_examples(ours, jdata.read_manifest(man))
    assert ours[0].audio == str(tmp_path / "c0.wav") and ours[1].language == "de"
    man.write_text(json.dumps({"text": "no audio"}) + "\n")
    with pytest.raises(ValueError, match="audio"):
        tdata.read_manifest(man)


def test_prepare_examples_match_jax(prepared):
    jprep, tprep = prepared
    assert len(tprep) == len(TEXTS)
    for a, b in zip(tprep, jprep):
        np.testing.assert_array_equal(a.phonemes, b.phonemes)
        assert a.phonemes.dtype == np.int32 and a.codes.dtype == np.int32
        np.testing.assert_array_equal(a.codes, b.codes)
        assert a.values.keys() == b.values.keys() and a.speaker is None
        for k in a.values:
            np.testing.assert_array_equal(a.values[k], b.values[k])
            assert a.values[k].dtype == b.values[k].dtype
    assert tdata.total_audio_seconds(tprep) == jdata.total_audio_seconds(jprep)


def test_codes_cache_hits_with_the_tiny_dac(dataset_dir, tmp_path):
    dac = DACAutoencoder(cfg=TINY_DAC, device="cpu")
    cache = tdata.CodesCache(dac, tmp_path)
    assert cache.cache_dir.name == "dac44k-torch"  # never the JAX package's "dac44k"
    path = str(dataset_dir / "wavs" / "clip0.wav")
    c1 = cache.encode_file(path)
    c2 = cache.encode_file(path)
    assert cache.encode_calls == 1  # the second served from disk
    np.testing.assert_array_equal(c1, c2)
    assert c1.shape[0] == 9 and c1.dtype == np.int32 and c1.max() < TINY_DAC.codebook_size
    other = tdata.CodesCache(dac, tmp_path, codec_tag="other")
    other.encode_file(path)
    assert other.encode_calls == 1


def _same_batch(a: dict, b: dict):
    np.testing.assert_array_equal(a["codes"], b["codes"])
    assert a["codes"].dtype == b["codes"].dtype
    assert a["cond_inputs"].keys() == b["cond_inputs"].keys()
    for k, v in a["cond_inputs"].items():
        w = b["cond_inputs"][k]
        assert (v is None) == (w is None)
        if v is not None:
            np.testing.assert_array_equal(v, w)
            assert v.dtype == w.dtype


@pytest.mark.parametrize("eos", [None, 1024])
def test_batches_match_jax(prepared, specs, eos):
    jprep, tprep = prepared
    jspecs, tspecs = specs
    bs = dict(batch_size=4, phoneme_bucket=16, code_bucket=8, pool_factor=2, eos_token_id=eos)
    _same_batch(tdata.assemble_batch(tprep[:3], tspecs, 1025, tdata.BatchSpec(**bs)),
                jdata.assemble_batch(jprep[:3], jspecs, 1025, jdata.BatchSpec(**bs)))
    for epoch in (0, 1):
        ours = list(tdata.iter_epoch_batches(tprep, tspecs, 1025, tdata.BatchSpec(**bs),
                                             seed=3, epoch=epoch))
        ref = list(jdata.iter_epoch_batches(jprep, jspecs, 1025, jdata.BatchSpec(**bs),
                                            seed=3, epoch=epoch))
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            _same_batch(a, b)


@pytest.mark.parametrize("start_step", [0, 3])
def test_prefetch_loader_matches_jax(prepared, specs, start_step):
    """The loader's stream (across epochs, from a resumed step too) is JAX's."""
    jprep, tprep = prepared
    jspecs, tspecs = specs
    bs = dict(batch_size=2, phoneme_bucket=16, code_bucket=8)
    streams = []
    for pkg, prep, sp in ((tdata, tprep, tspecs), (jdata, jprep, jspecs)):
        loader = pkg.PrefetchLoader(prep, sp, 1025, pkg.BatchSpec(**bs), seed=1,
                                    start_step=start_step)
        items = []
        for step, batch in loader:
            items.append((step, batch))
            if len(items) == 7:
                break
        loader.stop()
        streams.append(items)
    for (sa, a), (sb, b) in zip(*streams):
        assert sa == sb
        _same_batch(a, b)
    assert streams[0][0][0] == start_step


def test_train_state_round_trip(tmp_path):
    params = {"w": torch.randn(3, 4), "layers": [{"b": torch.zeros(2)}, {"b": torch.ones(2)}]}
    opt = {"count": 0, "mu": [torch.zeros(3, 4), None, torch.ones(2)]}
    assert train_state.restore_train_state(str(tmp_path), params, opt) is None
    for step in (2, 4, 6, 8):
        params["w"] = params["w"] + 1
        opt = {**opt, "count": step}
        train_state.save_train_state(str(tmp_path / "ck"), step, params, opt)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["4", "6", "8"]
    step, p, o = train_state.restore_train_state(str(tmp_path / "ck"), params, opt)
    assert step == 8 and o["count"] == 8 and o["mu"][1] is None
    assert torch.equal(p["w"], params["w"]) and torch.equal(p["layers"][1]["b"], torch.ones(2))
    train_state.save_inference_params(str(tmp_path / "inf" / "p.pt"), params)
    q = train_state.load_inference_params(str(tmp_path / "inf" / "p.pt"), params)
    assert torch.equal(q["w"], params["w"])


@pytest.fixture
def tiny_dac(monkeypatch):
    """``train_cli``'s model encodes with the tiny DAC on the CPU."""
    from zonos_tpu_torch.models import tts

    dac = DACAutoencoder(cfg=TINY_DAC, device="cpu")
    monkeypatch.setattr(tts.Zonos, "autoencoder", property(lambda self: dac))
    return dac


def test_train_cli_end_to_end(dataset_dir, tmp_path, tiny_dac, caplog):
    """Train 2 steps, resume to 4 with a validation split and export; the
    export loads through ``Zonos.from_local``; a mesh in one process is
    refused (it is launched by torchrun, ``tests/test_torch_port_parallel.py``)."""
    from zonos_tpu_torch.apps import train_cli

    common = ["--ljspeech", str(dataset_dir), "--tiny", "--device", "cpu", "--batch", "2",
              "--lr", "1e-3", "--warmup", "0", "--log_every", "2",
              "--cache_dir", str(tmp_path / "cache"), "--ckpt_dir", str(tmp_path / "ck"),
              "--ckpt_every", "2", "--phoneme_bucket", "16", "--code_bucket", "8",
              "--optimizer", "adafactor"]
    with caplog.at_level(logging.INFO, logger="zonos_tpu_torch.train"):
        train_cli.main(common + ["--steps", "2"])
        assert (tmp_path / "ck" / "2" / "state.pt").exists()
        caplog.clear()
        train_cli.main(common + ["--steps", "4", "--resume", "--val_frac", "0.2",
                                 "--eval_every", "2", "--accum", "2",
                                 "--export", str(tmp_path / "ref")])
    messages = [r.getMessage() for r in caplog.records]
    assert any("resumed from step 2" in m for m in messages)
    assert any("0 fresh encodes" in m for m in messages)  # every clip from the cache
    assert any("holding out 1 examples" in m for m in messages)
    assert any("step 4  val_loss" in m for m in messages)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "4"]
    m = Zonos.from_local(str(tmp_path / "ref" / "config.json"),
                         str(tmp_path / "ref" / "model.safetensors"), device="cpu")
    assert m.config.backbone.d_model == 64
    with pytest.raises(SystemExit, match="torchrun"):
        train_cli.main(common + ["--steps", "1", "--dp", "2"])
    if not torch.cuda.is_available():  # the default device is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(common + ["--steps", "1", "--device", "cuda"])


def test_train_cli_lora(dataset_dir, tmp_path, tiny_dac):
    """LoRA through ``train_cli``: 2 steps, a resume, a merged export that loads."""
    from zonos_tpu_torch.apps import train_cli

    common = ["--ljspeech", str(dataset_dir), "--tiny", "--device", "cpu", "--batch", "2",
              "--lr", "1e-2", "--warmup", "0", "--log_every", "2",
              "--cache_dir", str(tmp_path / "cache"), "--ckpt_dir", str(tmp_path / "ck"),
              "--ckpt_every", "2", "--phoneme_bucket", "16", "--code_bucket", "8",
              "--lora_rank", "4", "--param_dtype", "bfloat16"]
    train_cli.main(common + ["--steps", "2"])
    train_cli.main(common + ["--steps", "4", "--resume", "--export", str(tmp_path / "merged")])
    m = Zonos.from_local(str(tmp_path / "merged" / "config.json"),
                         str(tmp_path / "merged" / "model.safetensors"), device="cpu")
    base = Zonos(ZonosConfig.from_dict(_tiny_dict()), device="cpu")
    w, w0 = m.params["backbone"]["layers"]["wqkv"], base.params["backbone"]["layers"]["wqkv"]
    n, n0 = m.params["backbone"]["layers"]["norm1_scale"], base.params["backbone"]["layers"]["norm1_scale"]
    assert not torch.equal(w, w0) and torch.equal(n, n0)  # adapters merged, the rest the base
    state = torch.load(tmp_path / "ck" / "4" / "state.pt", weights_only=True)
    assert state["step"] == 4 and state["params"]["prefix_conditioner"]["_norm"]["scale"] is None
