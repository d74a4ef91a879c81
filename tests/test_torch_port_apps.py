"""The port's offline apps on the CPU, against the JAX package where the
output is deterministic: ``batch_cli`` (one tiny model's weights in both,
greedy), ``srt`` (three segments, one of them failing), ``sampler_explain``,
``DACAutoencoder.audio_quality`` and its spectral proxy, the PER, the native
resampler, and ``--verbose_sampling``'s statistics (the step writes them on
the device and ``generate`` logs them at its polls).  Mirrors
``tests/test_apps.py``, ``tests/test_native_audio.py`` and
``tests/test_g2p_fixtures.py``.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly
from torch.utils._python_dispatch import TorchDispatchMode

from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.dac import DACAutoencoder as JaxDAC
from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
from zonos_tpu.models.dac.codec import init_dac_params as jax_init_dac_params
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_dac_params, convert_zonos_params
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops import sampling as port_sampling

REPO = Path(__file__).resolve().parents[1]
# a small DAC with the full hop of 512 samples, so the apps write 44.1 kHz WAVs of the real length
SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
GREEDY = ["--temperature", "0", "--linear", "0", "--conf", "0", "--repetition_penalty", "1"]
THREE_SEGMENTS = ("1\n00:00:00,000 --> 00:00:00,600\nHello there.\n\n"
                  "2\n00:00:01,000 --> 00:00:01,500\nThis one fails.\n\n"
                  "3\n00:00:02,000 --> 00:00:02,400\nGood bye.\n")


def _tiny_dict() -> dict:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return d


@pytest.fixture(scope="module")
def pair():
    """One tiny transformer and one small DAC, in the JAX package (fp32) and
    in the port (the same weights, converted), on the CPU."""
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict()),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    jdac_params = jax.tree.map(np.asarray,
                               jax_init_dac_params(jax.random.key(3), JaxDACConfig(**SMALL_DAC)))
    jm._autoencoder = JaxDAC(params=jdac_params, cfg=JaxDACConfig(**SMALL_DAC))
    tm._autoencoder = DACAutoencoder(params=convert_dac_params(jdac_params),
                                     cfg=DACConfig(**SMALL_DAC), device="cpu")
    return jm, tm


def _wav(path) -> tuple[int, np.ndarray]:
    from zonos_tpu_torch.audio.io import load_audio

    w, sr = load_audio(str(path))
    return sr, w


# ---------------------------------------------------------------------------
# batch_cli
# ---------------------------------------------------------------------------


def test_batch_cli_matches_jax(pair, tmp_path, monkeypatch, capsys):
    """Two texts in one batch, greedy, scored: the port writes the same files
    as the JAX package's batch CLI on the same weights, with the same sample
    counts and samples (the DACs agree to 1e-4; the WAVs are int16), and
    ranks them alike."""
    import zonos_tpu.apps.batch_cli as jax_cli

    from zonos_tpu_torch.apps import batch_cli

    jm, tm = pair
    monkeypatch.setattr(jax_cli, "load_model", lambda args: jm)
    monkeypatch.setattr(batch_cli, "load_model", lambda args: tm)
    common = ["--text", "one", "two", "--max_new_tokens", "16", "--max_per_batch", "2",
              "--score", "--seed", "5"] + GREEDY
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    paths = batch_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["gen_0000_s5.wav", "gen_0001_s5.wav"]
    assert [os.path.basename(p) for p in paths] == names
    assert "texts: 2, max_per_batch: 2" in out and "texts: 2, max_per_batch: 2" in jax_out
    for name in names:
        (sr, ours), (jsr, ref) = _wav(tmp_path / "port" / name), _wav(tmp_path / "jax" / name)
        assert sr == jsr == 44100 and ours.shape == ref.shape and ours.shape[1] > 0
        np.testing.assert_allclose(ours, ref, atol=2e-3)

    def ranking(text):
        return [(float(a), os.path.basename(p))
                for a, p in re.findall(r"^\s+([\d.]+)\s+(\S+)$", text, re.M)]

    ours, ref = ranking(out), ranking(jax_out)
    assert len(ours) == 2 and [p for _, p in ours] == [p for _, p in ref]
    np.testing.assert_allclose([a for a, _ in ours], [a for a, _ in ref], atol=0.011)


def test_batch_cli_helpers_match_jax(tmp_path):
    """Text collection (flags, file, repeats) and the batch sizing off the
    card (16 GiB assumed, as JAX assumes off a TPU) are JAX's."""
    import zonos_tpu.apps.batch_cli as jax_cli

    from zonos_tpu_torch.apps import batch_cli

    (tmp_path / "t.txt").write_text("alpha\n\nbeta\n")
    argv = ["--text", "x", "--text_file", str(tmp_path / "t.txt"), "--text_repeat", "2"]
    assert batch_cli.collect_texts(batch_cli.build_parser().parse_args(argv)) == \
        jax_cli.collect_texts(jax_cli.build_parser().parse_args(argv)) == \
        ["x", "x", "alpha", "alpha", "beta", "beta"]
    for n in (16, 860, 2580):
        assert batch_cli.estimate_max_batch(n, "cpu") == jax_cli.estimate_max_batch(n)
    assert list(batch_cli.chunks(list(range(5)), 2)) == [[0, 1], [2, 3], [4]]


# ---------------------------------------------------------------------------
# srt
# ---------------------------------------------------------------------------


def test_srt_parse_and_solver_match_jax(tmp_path):
    import zonos_tpu.apps.srt as jax_srt

    from zonos_tpu_torch.apps import srt

    path = tmp_path / "three.srt"
    path.write_text(THREE_SEGMENTS)
    segs = srt.parse_srt(str(path))
    assert segs == jax_srt.parse_srt(str(path)) and len(segs) == 3
    for i in range(3):
        b = srt.segment_budget(segs, i, buffer_s=0.2)
        assert b == jax_srt.segment_budget(segs, i, buffer_s=0.2)
        assert srt.solve_speaking_rate(segs[i]["text"], "en-us", b) == \
            jax_srt.solve_speaking_rate(segs[i]["text"], "en-us", b)


def test_srt_end_to_end_with_a_bad_segment(pair, tmp_path, monkeypatch, capsys):
    """Three segments, the second failing: the job goes on, writes the other
    two (each the best of 2 candidates by the quality proxy) with JAX's
    budget, rate and text in their metadata, and the concatenation; a rerun
    skips what is up to date."""
    import zonos_tpu.apps.srt as jax_srt

    import zonos_tpu_torch.apps.srt as srt

    _, tm = pair
    path = tmp_path / "three.srt"
    path.write_text(THREE_SEGMENTS)
    out_dir = tmp_path / "srt_out"
    monkeypatch.setattr(srt, "load_model", lambda args: tm)
    real = srt._generate_segment

    def second_fails(args, model, speaker, segments, i, seg, *rest):
        if seg["index"] == 2:
            raise RuntimeError("synthetic segment failure")
        return real(args, model, speaker, segments, i, seg, *rest)

    monkeypatch.setattr(srt, "_generate_segment", second_fails)
    argv = [str(path), "--output_dir", str(out_dir), "--candidates", "2", "--device", "cpu",
            "--max_new_tokens", "64"]
    srt.main(argv + ["--concat", str(tmp_path / "all.wav")])
    out = capsys.readouterr().out
    assert "[2] FAILED" in out and "1 segment(s) failed: [2]" in out
    segs = jax_srt.parse_srt(str(path))
    for i in (0, 2):
        idx = segs[i]["index"]
        meta = json.loads((out_dir / f"seg_{idx:04d}.json").read_text())
        budget = jax_srt.segment_budget(segs, i)
        assert meta["text"] == segs[i]["text"] and meta["candidates"] == 2
        assert meta["available_s"] == budget
        assert meta["speaking_rate"] == jax_srt.solve_speaking_rate(segs[i]["text"], "en-us",
                                                                     budget)
        sr, w = _wav(out_dir / f"seg_{idx:04d}.wav")
        assert sr == 44100 and w.shape[1] > 0
        assert abs(meta["duration_s"] - w.shape[1] / sr) < 1e-3
    assert not (out_dir / "seg_0002.wav").exists()
    sr, full = _wav(tmp_path / "all.wav")
    assert sr == 44100 and full.shape[1] == int((segs[-1]["end"] + 5.0) * sr)
    monkeypatch.setattr(srt, "_generate_segment", real)
    srt.main(argv[:1] + ["--output_dir", str(out_dir), "--candidates", "2", "--device", "cpu",
                         "--max_new_tokens", "64"])
    out = capsys.readouterr().out
    assert "[1] up to date, skipping" in out and "[3] up to date, skipping" in out
    assert (out_dir / "seg_0002.wav").exists()  # the failed one is made on the rerun


# ---------------------------------------------------------------------------
# sampler_explain, quality, PER, resampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--linear", "0.5"], ["--sweep"],
                                  ["--linear", "0.7", "--conf", "0.1", "--quad", "0.05"]])
def test_sampler_explain_matches_jax(argv, capsys):
    from zonos_tpu.apps import sampler_explain as jax_explain

    from zonos_tpu_torch.apps import sampler_explain

    jax_explain.main(argv)
    ref = capsys.readouterr().out
    sampler_explain.main(argv)
    assert capsys.readouterr().out == ref and "Unified sampler" in ref
    assert sampler_explain.suggested_params(0.5) == jax_explain.suggested_params(0.5)


def _quality_wavs():
    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100
    return [rng.normal(scale=0.1, size=(1, 44100)).astype(np.float32),
            (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None],
            np.clip(rng.normal(scale=2.0, size=(1, 22050)), -1, 1).astype(np.float32),
            np.full((1, 4000), 0.2, np.float32),
            np.zeros((1, 0), np.float32)]


def test_quality_scores_match_jax(pair):
    """The spectral proxy, ``audio_quality`` (averaged and per wav, default
    and AQ-only qualities), ``best_per_chunk`` and ``quality_string`` equal
    the JAX package's (no aesthetics predictor here: the same proxy)."""
    from zonos_tpu.models.dac import _spectral_quality_proxy as jax_proxy

    from zonos_tpu_torch.models.dac import _spectral_quality_proxy

    jm, tm = pair
    wavs = _quality_wavs()
    for w in wavs:
        assert _spectral_quality_proxy(w, 44100) == jax_proxy(w, 44100)
    scored = wavs[:4]
    for kwargs in ({}, {"qualities": ["AQ"], "average_overall": False},
                   {"qualities": ["CU", "PQ", "AQ"], "average_overall": False}):
        assert tm.autoencoder.audio_quality(scored, 44100, **kwargs) == \
            jm.autoencoder.audio_quality(scored, 44100, **kwargs)
    for n in (-1, 2, 3):
        ours = tm.autoencoder.best_per_chunk(scored, 44100, n)
        ref = jm.autoencoder.best_per_chunk(scored, 44100, n)
        assert [id(w) for w in ours] == [id(w) for w in ref]
    aq = tm.autoencoder.audio_quality(scored[0], 44100)
    assert tm.autoencoder.quality_string(aq) == jm.autoencoder.quality_string(aq)


FIXTURES = json.loads((REPO / "tests" / "fixtures" / "espeak_golden.json").read_text())


def test_per_matches_jax_on_the_g2p_fixtures(monkeypatch):
    """The port's built-in G2P against the golden fixtures: every PER (and
    the corpus PER, and each word's substring PER in its sentence) equal to
    the JAX package's metric on the same strings."""
    import zonos_tpu_torch.text.g2p as g2p
    from zonos_tpu.text import metrics as jax_metrics

    from zonos_tpu_torch.text import metrics, phonemize

    monkeypatch.setattr(g2p, "_espeak_backend", lambda lang: None, raising=False)
    pairs = []
    for lang in (k for k in FIXTURES if not k.startswith("_")):
        for row in FIXTURES[lang]:
            hyp = phonemize([row["text"]], [lang])[0]
            assert metrics.normalize_ipa(hyp) == jax_metrics.normalize_ipa(hyp)
            assert metrics.phoneme_error_rate(hyp, row["ipa"]) == \
                jax_metrics.phoneme_error_rate(hyp, row["ipa"])
            word = row["ipa"].split()[0]
            assert metrics.substring_per(word, hyp) == jax_metrics.substring_per(word, hyp)
            pairs.append((hyp, row["ipa"]))
    assert len(pairs) > 50
    assert metrics.corpus_per(pairs) == jax_metrics.corpus_per(pairs) < 0.05
    assert metrics.phoneme_error_rate("", "") == 0.0 and metrics.substring_per("", "x") == 0.0


@pytest.mark.parametrize("rates", [(16000, 44100), (44100, 16000), (22050, 44100),
                                   (48000, 44100), (24000, 44100)])
def test_native_resampler_matches_jax_and_scipy(rates):
    """The port's binding of csrc/audio_engine.cpp gives the JAX package's
    binding's samples, within scipy's tolerance of resample_poly (the same
    filter design), on two channels and an odd length; ``resample`` takes
    it."""
    import time

    import zonos_tpu.audio.native as jax_native
    from zonos_tpu.audio.native import resample_native as jax_resample_native

    from zonos_tpu_torch.audio.io import resample
    from zonos_tpu_torch.audio.native import get_lib, resample_native

    if jax_native.get_lib() is None:  # another test process may be writing JAX's library
        time.sleep(5)
        jax_native._tried = False
    if get_lib() is None or jax_native.get_lib() is None:
        pytest.fail("the native audio engine did not build (g++ is part of the environment)")
    sr_from, sr_to = rates
    g = math.gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    wav = np.random.default_rng(sr_from).normal(size=(2, 5001)).astype(np.float32)
    got = resample_native(wav, up, down)
    np.testing.assert_array_equal(got, jax_resample_native(wav, up, down))
    ref = resample_poly(wav.astype(np.float64), up, down, axis=-1).astype(np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(resample(wav, sr_from, sr_to), got)
    np.testing.assert_array_equal(resample(wav[0], sr_from, sr_to), got[0])


# ---------------------------------------------------------------------------
# --verbose_sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    dict(),  # the defaults: unified (linear 0.55, conf 0.4)
    dict(min_p=0.1, temperature=0.8),
    dict(top_k=7, linear=0.0),
    dict(top_p=0.9, quad=0.05),
])
def test_trace_stats_match_jax(params, monkeypatch):
    """The statistics the port's step writes (top, entropy, support of the
    distribution it races over) equal those JAX's ``_emit_prob_stats`` gets
    on its unfused path for the same logits, window and penalty: values to
    1e-5, support counts exact; the logged line has JAX's format."""
    import zonos_tpu.ops.sampling as jax_sampling

    seen = []
    monkeypatch.setattr(jax_sampling, "_emit_prob_stats", lambda p: seen.append(np.asarray(p)))
    rng = np.random.default_rng(len(params))
    logits = (rng.normal(size=(2, 9, 96)) * 3).astype(np.float32)
    window = rng.integers(0, 96, size=(2, 9, 4)).astype(np.int32)
    jp = jax_sampling.SamplingParams(**params)
    jax_sampling.set_sampling_trace(True)
    try:
        jax.block_until_ready(jax_sampling.sample_from_logits(
            jax.random.key(0), jnp.asarray(logits), jp, generated_tokens=jnp.asarray(window),
            repetition_penalty=jnp.asarray([3.0, 1.0], jnp.float32)))
    finally:
        jax_sampling.set_sampling_trace(False)
    assert len(seen) == 1
    p = seen[0].astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.nansum(np.where(p > 0, p * np.log(p), 0.0), axis=-1)
    stats = port_sampling.prob_stats(port_sampling.sampling_probs(
        torch.from_numpy(logits), port_sampling.SamplingParams(**params),
        torch.from_numpy(window).long(), torch.tensor([3.0, 1.0]))).numpy()
    np.testing.assert_allclose(stats[..., 0], p.max(-1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(stats[..., 1], ent, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(stats[..., 2].astype(np.int64),
                                  (p > port_sampling.SUPPORT_FLOOR).sum(-1))


def _step_ops(tm, prefix, trace: bool) -> list[str]:
    """The aten ops of one decode step of a run prefilled with or without the
    trace ring."""
    from zonos_tpu_torch.kernels.decode_attention import band_of

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    with torch.inference_mode():
        run = tm._prefill(prefix, 8, 2.0, 1, None, 7, None, trace=trace)
        assert (run.trace is not None) == trace
        ops = Ops()
        with ops:
            tm._decode_step(run, band_of(run.pos0 + 1))
    return ops.names


def test_trace_costs_nothing_when_off(pair):
    """Off, the step runs exactly the ops it runs without the feature: the
    same sequence whether or not the trace was ever switched on; on, it adds
    the statistics and one write into the ring."""
    _, tm = pair
    prefix = tm.prepare_conditioning(make_cond_dict(text="Hi.", speaker=None))
    off = _step_ops(tm, prefix, trace=False)
    port_sampling.set_sampling_trace(True)
    try:
        off_after = _step_ops(tm, prefix, trace=False)
        on = _step_ops(tm, prefix, trace=True)
    finally:
        port_sampling.set_sampling_trace(False)
    assert off == off_after
    assert len(on) > len(off)
    assert on.count("aten.index_copy_.default") == off.count("aten.index_copy_.default") + 1


def test_cli_verbose_sampling_logs_one_line_a_step(tmp_path, caplog):
    """``cli --verbose_sampling --device cpu`` on a tiny local model: one
    trace line for each decode step, in JAX's format, read at the polls."""
    from zonos_tpu_torch.apps import cli
    from zonos_tpu_torch.models.tts import Zonos as PortZonos

    model_dir = tmp_path / "tiny"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(_tiny_dict()))
    made = []
    real_from_local = PortZonos.from_local

    def from_local(*a, **kw):
        m = real_from_local(*a, **kw)
        m._autoencoder = DACAutoencoder(cfg=DACConfig(**SMALL_DAC), device="cpu")
        made.append(m)
        return m

    out = tmp_path / "v.wav"
    try:
        with pytest.MonkeyPatch.context() as mp, \
                caplog.at_level(logging.DEBUG, logger="zonos_tpu_torch.sampling.trace"):
            mp.setattr(PortZonos, "from_local", staticmethod(from_local))
            cli.main(["--text", "Hello there.", "--model", str(model_dir), "--device", "cpu",
                      "--output", str(out), "--max_new_tokens", "40", "--no_progress_bar",
                      "--no_prefix_silence", "--verbose_sampling"])
    finally:
        port_sampling.set_sampling_trace(False)
    lines = [r.getMessage() for r in caplog.records if r.name == "zonos_tpu_torch.sampling.trace"]
    steps = made[0].decode_stats["steps"]
    assert steps > 32 and len(lines) == steps  # across a poll
    pattern = re.compile(r"^probs: top=\[\[.*\]\] entropy=\[\[.*\]\] support=\[\[.*\]\]$")
    assert all(pattern.match(line) for line in lines)
    assert out.exists()


@pytest.mark.parametrize("module", ["batch_cli", "srt", "sampler_explain"])
def test_entry_points_run_as_modules(module):
    res = subprocess.run([sys.executable, "-m", f"zonos_tpu_torch.apps.{module}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout
    assert ("--device" in res.stdout) == (module != "sampler_explain")
