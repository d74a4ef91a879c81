"""The port's REST server (``zonos_tpu_torch.serving.server``) end to end on
the CPU, on a bf16 random tiny model and a small DAC with the full hop of
512 samples: health and stats, a ``/v1/tts`` round trip, errors, the
streaming endpoint, latency percentiles, ``/v1/speakers``, ``long: true``
with carry (bit-identical to the offline ``zonos_tpu_torch.longform`` after
``normalize_loudness``) and without, the crossfade, the entry points'
``--help`` in a subprocess, and their refusal to fall back to the CPU.
The JAX package's server is not run here: its long-form path is held
against JAX's own offline path in ``tests/test_serving.py``, and the port's
``synthesize_long`` against JAX's in ``tests/test_torch_port_longform.py``.
"""

from __future__ import annotations

import copy
import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig
from zonos_tpu_torch import longform
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.serving import ServerState, serve
from zonos_tpu_torch.serving.batching import program_frames_bucket
from zonos_tpu_torch.serving.server import _crossfade_concat, wav_bytes

REPO = Path(__file__).resolve().parents[1]
SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
GREEDY_JSON = {"temperature": 0.0, "linear": 0.0, "conf": 0.0, "repetition_penalty": 1.0}


def _spk(seed):
    return np.random.default_rng(seed).normal(size=(1, 1, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    m = Zonos(ZonosConfig.from_dict(d), seed=0, device="cpu")
    m._autoencoder = DACAutoencoder(cfg=DACConfig(**SMALL_DAC), device="cpu")
    m.make_speaker_embedding = lambda wav, sr: _spk(99)  # the tower is tested elsewhere
    return m


@pytest.fixture(scope="module")
def server(tiny):
    state = ServerState(tiny, model_name="tiny", max_batch=4, max_wait_ms=100.0,
                        cond_pad_multiple=16)
    httpd = serve(state, host="127.0.0.1", port=0)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", state
    httpd.shutdown()
    httpd.server_close()
    state.close()


def _post_json(url, obj, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _wav_body(seconds=1.0, sr=16000) -> bytes:
    pcm = (np.sin(np.linspace(0, 440 * 2 * np.pi * seconds, int(sr * seconds))) * 20000)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _read_wav(data: bytes) -> tuple[int, np.ndarray]:
    with wave.open(io.BytesIO(data), "rb") as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_server_health_and_stats(server):
    base, _ = server
    with urllib.request.urlopen(base + "/v1/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "model": "tiny"}
    with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert {"batches", "capture_seconds", "inflight", "max_queue"} <= set(stats)


def test_speakers_then_tts_roundtrip(server):
    base, state = server
    req = urllib.request.Request(base + "/v1/speakers", data=_wav_body(),
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=60) as r:
        sid = json.loads(r.read())["speaker_id"]
    assert len(sid) == 16 and sid in state.speakers
    with urllib.request.urlopen(req, timeout=60) as r:  # content-addressed: the same id
        assert json.loads(r.read())["speaker_id"] == sid
    body = {"text": "Server test.", "max_seconds": 0.25, "sampling": GREEDY_JSON,
            "speaker_id": sid}
    with _post_json(base + "/v1/tts", body) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        sr, pcm = _read_wav(r.read())
    assert sr == 44100 and pcm.size > 0


def test_server_errors(server):
    base, _ = server
    for body, code in (({"max_seconds": 0.1}, 400), ({"text": "x", "speaker_id": "nope"}, 400),
                       ({"text": "x", "long": True, "max_segment_seconds": 40}, 400),
                       ({"text": "x", "margin_frames": 2}, 400)):
        url = base + ("/v1/tts/stream" if "margin_frames" in body else "/v1/tts")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(url, body, timeout=60)
        assert e.value.code == code, body
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_json(base + "/v1/nothing", {}, timeout=60)
    assert e.value.code == 404
    req = urllib.request.Request(base + "/v1/speakers", data=b"",
                                 headers={"Content-Type": "audio/wav"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_server_streaming_endpoint(server):
    base, _ = server
    body = {"text": "Stream me.", "max_seconds": 0.5, "sampling": GREEDY_JSON,
            "chunk_frames": 8, "margin_frames": 12}
    with _post_json(base + "/v1/tts/stream", body) as r:
        assert r.headers["X-Sample-Rate"] == "44100"
        assert r.headers["X-Sample-Format"] == "s16le"
        pcm = r.read()
    assert len(pcm) > 1000 and len(pcm) % 2 == 0


def test_stats_latency_percentiles(server):
    base, _ = server
    with _post_json(base + "/v1/tts", {"text": "Count me.", "max_seconds": 0.2,
                                       "sampling": GREEDY_JSON}):
        pass
    with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
        s = json.loads(r.read())
    assert s["completed"] >= 1 and "latency_p50_s" in s and "latency_p95_s" in s


def test_server_longform_carry_matches_offline(server):
    """``long: true`` with carry through the batcher equals the offline
    ``synthesize_long`` after ``normalize_loudness``, bit for bit, at the
    default cond padding of 32 (the offline path's)."""
    _, shared = server
    text = "The first sentence runs here. Then a second one."  # three segments
    budget, carry, seed = 1.0, 8, 55
    state = ServerState(shared.model, max_batch=4, max_wait_ms=20.0)
    try:
        server_wav = state.synthesize_long({"text": text, "long": True,
                                            "max_segment_seconds": budget,
                                            "carry_frames": carry, "seed": seed})
    finally:
        state.close()
    frames = max(9, min(86 * 30, int(min(budget * 1.2 + 1.0, 30.0) * 86)))
    offline_wav, seg_codes = longform.synthesize_long(
        shared.model, text, language="en-us", sampling_params=SamplingParams(), cfg_scale=2.0,
        seed=seed, max_segment_seconds=budget, carry_frames=carry,
        max_new_tokens=program_frames_bucket(frames))
    assert len(seg_codes) >= 2
    want = shared.model.autoencoder.normalize_loudness(offline_wav, 44100, target_lufs=-23.0)
    assert server_wav.dtype == np.float32
    np.testing.assert_array_equal(server_wav, np.asarray(want, np.float32).reshape(-1))


def test_server_longform_endpoint_and_parallel_mode(server):
    base, _ = server
    for carry in (True, False):
        body = {"text": "A first sentence. Now a second.",
                "long": True, "carry": carry, "max_segment_seconds": 1.0,
                "sampling": GREEDY_JSON}
        with _post_json(base + "/v1/tts", body) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            sr, pcm = _read_wav(r.read())
        # several segments: clearly longer than one segment's step budget
        assert sr == 44100 and pcm.size > int(0.5 * 44100), carry


def test_long_is_refused_on_the_stream_endpoint(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_json(base + "/v1/tts/stream", {"text": "x", "long": True}, timeout=60)
    assert e.value.code == 400


def test_crossfade_concat_and_wav_bytes():
    a, b = np.ones(1000, np.float32), np.full(1000, -1.0, np.float32)
    out = _crossfade_concat([a, b], sr=44100, fade_ms=10.0)
    n = int(0.010 * 44100)
    assert out.shape[0] == 2000 - n
    seam = out[1000 - n:1000]
    assert (np.diff(seam) <= 1e-6).all() and out[0] == 1.0 and out[-1] == -1.0
    assert _crossfade_concat([np.ones(1, np.float32)] * 3, sr=44100).shape[0] == 3
    with pytest.raises(RuntimeError):
        _crossfade_concat([np.zeros(0, np.float32)], sr=44100)
    sr, pcm = _read_wav(wav_bytes(np.array([[0.0, 0.5, -2.0]], np.float32)))
    assert sr == 44100 and pcm.tolist() == [0, 16383, -32767]


@pytest.mark.parametrize("module", ["zonos_tpu_torch.serving", "zonos_tpu_torch.apps.cli"])
def test_entry_point_help(module, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", module, "--help"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout
    if module.endswith("serving"):
        assert "--kv_f8" in res.stdout and "--compile_cache" not in res.stdout
    else:
        assert "--long" in res.stdout and "--verbose_sampling" in res.stdout


def test_entry_points_refuse_the_cpu_without_being_asked():
    """``--device cuda`` (the default) raises without a card instead of
    running on the CPU, with ``--verbose_sampling`` too (the trace runs on
    the CPU only when asked for: ``tests/test_torch_port_apps.py``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from zonos_tpu_torch.apps import cli
    from zonos_tpu_torch.serving import server

    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--device", "cuda", "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--text", "hello"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--text", "hello", "--verbose_sampling"])


def test_cli_writes_a_wav_on_the_cpu(tmp_path, tiny, monkeypatch):
    """The CLI's single-text path and ``--long`` on the CPU when asked for,
    with the tiny model in place of the flagship."""
    from zonos_tpu_torch.apps import cli, common

    monkeypatch.setattr(common, "load_model", lambda args: tiny)
    monkeypatch.setattr(cli, "load_model", lambda args: tiny)
    trace = tmp_path / "trace"
    for extra, name in ((["--profile", str(trace)], "one.wav"),
                        (["--long", "--max_segment_seconds", "1.0"], "long.wav")):
        out = tmp_path / name
        cli.main(["--text", "A first sentence. And a second one.", "--device", "cpu",
                  "--output", str(out), "--max_new_tokens", "24", "--no_progress_bar",
                  "--temperature", "0"] + extra)
        sr, pcm = _read_wav(out.read_bytes())
        assert sr == 44100 and pcm.size > 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)  # the generate's ops


def test_phase_timer_sums_phases():
    from zonos_tpu_torch.utils.profiling import PhaseTimer

    lines = []
    timer = PhaseTimer(printer=lines.append)
    for name in ("load", "generate", "load"):
        with timer.phase(name):
            pass
    timer.report()
    assert list(timer.durations) == ["load", "generate"]
    assert len(lines) == 3 + 3 and lines[-1].startswith("[t] total")
