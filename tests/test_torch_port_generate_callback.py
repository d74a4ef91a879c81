"""``Zonos.generate``'s ``callback`` and ``progress_bar`` in the port against
the JAX package, on the CPU.

The same random weights (JAX init, cast to fp32) go through
``zonos_tpu_torch.convert``; both models decode one greedy prefix.  The
callback runs every 32 decode steps and once at the end, as JAX's host
chunks call it: the ``(done, total)`` sequence and the frames it sees must
be JAX's, and a callback that returns False at its second call must stop
both decodes at the same point with the same trimmed codes.  The progress
bar is a plain line on stderr, with no ``tqdm``.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401
from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.ops.sampling import SamplingParams

REPO = Path(__file__).resolve().parents[1]
MAX_NEW = 80  # 88 decode steps: callbacks at 32, 64 and 88


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
    spk = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
    prefix = np.array(jm.prepare_conditioning(
        jax_make_cond_dict(text="A callback test sentence.", speaker=spk)), np.float32)
    return jm, tm, prefix


class Recorder:
    """A callback that records (frame, done, total) and returns False at its
    ``stop_at``-th call (never when None)."""

    def __init__(self, stop_at: int | None = None):
        self.calls: list[tuple[np.ndarray, int, int]] = []
        self.stop_at = stop_at

    def __call__(self, frame, done, total):
        self.calls.append((np.asarray(frame).astype(np.int64), int(done), int(total)))
        return self.stop_at is None or len(self.calls) < self.stop_at


def _both(models, stop_at):
    jm, tm, prefix = models
    jrec, trec = Recorder(stop_at), Recorder(stop_at)
    ref = jm.generate(jnp.asarray(prefix), max_new_tokens=MAX_NEW, cfg_scale=2.0,
                      sampling_params=JaxSamplingParams.greedy(), progress_bar=False,
                      callback=jrec, cache_growth=False)
    ours = tm.generate(torch.from_numpy(prefix), max_new_tokens=MAX_NEW, cfg_scale=2.0,
                       sampling_params=SamplingParams.greedy(), progress_bar=False,
                       callback=trec)
    return ref, ours, jrec, trec


@pytest.mark.parametrize("stop_at", [None, 2], ids=["runs-to-the-end", "stops-at-second-call"])
def test_callback_matches_jax(models, stop_at):
    ref, ours, jrec, trec = _both(models, stop_at)
    assert [(d, t) for _, d, t in trec.calls] == [(d, t) for _, d, t in jrec.calls]
    assert len(trec.calls) >= 2
    for (fa, _, _), (fb, _, _) in zip(trec.calls, jrec.calls):
        assert fa.shape == fb.shape
        np.testing.assert_array_equal(fa, fb)
    assert len(ours) == len(ref) == 1
    assert ours[0].shape == ref[0].shape
    np.testing.assert_array_equal(ours[0], ref[0])
    if stop_at == 2:
        # the decode stopped at the second chunk boundary: 64 steps, so at most
        # 64 - 8 frames came out of the delay pattern
        assert trec.calls[-1][1] == 64 and ours[0].shape[1] <= 64 - 8
    else:
        assert trec.calls[-1][1] == trec.calls[-1][2]


def test_callback_sees_every_chunk_boundary(models):
    """Done grows by the 32-step chunk and ends at the budget; frames are
    [B, K, 1] while the offset is inside the buffer."""
    _, _, _, trec = _both(models, None)
    dones = [d for _, d, _ in trec.calls]
    assert dones == sorted(dones) and dones[0] == 32
    assert all(t == MAX_NEW + 8 for _, _, t in trec.calls)
    assert trec.calls[0][0].shape == (1, 9, 1)


def test_progress_bar_writes_stderr_without_tqdm(tmp_path):
    code = textwrap.dedent("""
        import copy, sys
        sys.modules["tqdm"] = None  # importing tqdm now raises
        import numpy as np
        from zonos_tpu_torch import Zonos, ZonosConfig
        from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
        d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
        d["backbone"].update({"d_model": 64, "n_layer": 1, "attn_mlp_d_intermediate": 128,
                              "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
        m = Zonos(ZonosConfig.from_dict(d), device="cpu")
        prefix = m.prepare_conditioning({"espeak": (["Hi."], ["en-us"]),
                                         "speaker": np.zeros((1, 1, 128), np.float32)})
        codes = m.generate(prefix, max_new_tokens=40, seed=1)
        print("OK", codes[0].shape)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK (9, ")
    assert "Generating: 0/48 steps" in res.stderr
    assert "Generating: 48/48 steps" in res.stderr or "Generating: 32/48" in res.stderr


def test_progress_bar_off_writes_nothing(models, capfd):
    _, tm, prefix = models
    tm.generate(torch.from_numpy(prefix), max_new_tokens=8, progress_bar=False)
    assert "Generating" not in capfd.readouterr().err
    tm.generate(torch.from_numpy(prefix), max_new_tokens=8)  # JAX's default: on
    assert "Generating" in capfd.readouterr().err
