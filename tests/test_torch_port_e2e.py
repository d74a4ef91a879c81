"""End-to-end parity of the port's first slice with the JAX package, on the
CPU: text -> prepare_conditioning -> greedy generate -> tiny-DAC decode.

The same random weights (JAX init, cast to fp32) go through
``zonos_tpu_torch.convert`` into the port.  Greedy codes must be identical
(at cfg_scale 2.0 and at 1.0, where the uncond half is dropped); waveforms
agree within 1e-4.  The JAX side compiles two generate programs in all.
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

from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
from zonos_tpu.models.dac.codec import dac_decode as jax_dac_decode
from zonos_tpu.models.dac.codec import init_dac_params as jax_init_dac_params
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_dac_params, convert_zonos_params
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops.sampling import SamplingParams

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["Hello world.", "Good morning, how are you?"]
MAX_NEW = 12
TINY_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(2, 2), decoder_hidden_size=32)


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
    assert tm.compute_dtype == torch.float32
    return jm, tm


@pytest.fixture(scope="module")
def prefixes(models):
    jm, tm = models
    spk = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
    jp = jm.prepare_conditioning(jax_make_cond_dict(text=TEXTS, speaker=spk))
    tp = tm.prepare_conditioning(make_cond_dict(text=TEXTS, speaker=spk))
    return np.asarray(jp), tp


@pytest.fixture(scope="module")
def jax_codes(models, prefixes):
    """JAX greedy codes per cfg_scale, computed once (one compile each)."""
    jm, _ = models
    jp, _ = prefixes
    return {
        scale: jm.generate(jnp.asarray(jp), max_new_tokens=MAX_NEW, cfg_scale=scale, batch_size=2,
                           sampling_params=JaxSamplingParams.greedy(), progress_bar=False)
        for scale in (2.0, 1.0)
    }


def test_prepare_conditioning_matches(prefixes):
    jp, tp = prefixes
    assert tuple(tp.shape) == jp.shape and tp.dtype == torch.float32
    assert np.abs(tp.numpy() - jp).max() <= 1e-5 * np.abs(jp).max()


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
def test_greedy_generate_matches_jax(models, prefixes, jax_codes, cfg_scale):
    _, tm = models
    _, tp = prefixes
    ours = tm.generate(tp, max_new_tokens=MAX_NEW, cfg_scale=cfg_scale, batch_size=2,
                       sampling_params=SamplingParams.greedy())
    ref = jax_codes[cfg_scale]
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_step_limits_trim_like_jax(models, prefixes, jax_codes):
    """Per-row limits cap the loop and the output exactly as the JAX program
    does: a greedy row under limit n is the unlimited row's first n frames."""
    _, tm = models
    _, tp = prefixes
    limits = [5, 9]
    ours = tm.generate(tp, max_new_tokens=MAX_NEW, cfg_scale=2.0, batch_size=2,
                       sampling_params=SamplingParams.greedy(), step_limits=limits)
    for row, lim, ref in zip(ours, limits, jax_codes[2.0]):
        n = min(lim, ref.shape[1])
        assert row.shape == (9, n)
        np.testing.assert_array_equal(row, ref[:, :n])


def test_sampled_generate_is_per_row_deterministic(models, prefixes):
    """A row's stream depends on its own seed alone."""
    _, tm = models
    _, tp = prefixes
    a = tm.generate(tp, max_new_tokens=MAX_NEW, batch_size=2, seed=[5, 6])
    b = tm.generate(tp, max_new_tokens=MAX_NEW, batch_size=2, seed=[5, 6])
    c = tm.generate(tp[[0, 2]], max_new_tokens=MAX_NEW, batch_size=1, seed=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape[0] == 9 and ((a[0] >= 0) & (a[0] < 1024)).all()
    np.testing.assert_array_equal(c[0][:, :3], a[0][:, :3])


def test_tiny_dac_decode_matches_jax(jax_codes):
    jcfg = JaxDACConfig(**TINY_DAC)
    jparams = jax_init_dac_params(jax.random.key(3), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)

    def rescale(tree):  # unit-variance activations and non-unit snake alphas
        for key, val in tree.items():
            if isinstance(val, dict):
                rescale(val)
            elif isinstance(val, list):
                for item in val:
                    rescale(item)
            elif key == "w":
                k, cin, _ = val.shape
                tree[key] = (rng.normal(size=val.shape) / np.sqrt(k * cin)).astype(np.float32)
            elif key.startswith("alpha"):
                tree[key] = rng.uniform(0.5, 1.5, size=val.shape).astype(np.float32)
            elif key == "codebook":
                tree[key] = rng.normal(size=val.shape).astype(np.float32)

    rescale(jparams)
    codes = np.stack([c[:, :8] for c in jax_codes[2.0]])  # [2, 9, 8]
    ref = np.asarray(jax_dac_decode(jparams, jcfg, jnp.asarray(codes))).swapaxes(1, 2)
    dac = DACAutoencoder(params=convert_dac_params(jparams), cfg=DACConfig(**TINY_DAC),
                         device="cpu")
    ours = dac.decode(codes)
    assert ours.shape == ref.shape == (2, 1, 8 * 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert np.abs(ref).max() > 0.1  # the comparison is not of zeros


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["zonos_tpu"] = None
        import copy, numpy as np
        from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
        from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
        from zonos_tpu_torch.models.dac.codec import DACConfig
        d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
        d["backbone"].update({{"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                              "attn_cfg": {{"num_heads": 4, "num_heads_kv": 2}}}})
        m = Zonos(ZonosConfig.from_dict(d), device="cpu")
        codes = m.generate(m.prepare_conditioning(make_cond_dict(text="Hi there.")),
                           max_new_tokens=6, seed=1)
        dac = DACAutoencoder(cfg=DACConfig(**{TINY_DAC!r}), device="cpu")
        dac.save_codes([{str(tmp_path / "out.wav")!r}], codes)
        assert not any(n == "jax" or n.startswith(("jax.", "zonos_tpu."))
                       for n, mod in sys.modules.items() if mod is not None)
        print("OK", codes[0].shape)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK (9, ")
    assert (tmp_path / "out.wav").exists()


def test_package_has_no_jax_imports():
    pkg = REPO / "zonos_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), f"{path}: {s}"
            assert not (s.startswith(("import zonos_tpu", "from zonos_tpu"))
                        and not s.startswith(("import zonos_tpu_torch", "from zonos_tpu_torch"))), \
                f"{path}: {s}"


def test_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Zonos(ZonosConfig.from_dict(_tiny_dict()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DACAutoencoder(cfg=DACConfig(**TINY_DAC))
