"""The port's ops, conditioning, backbone and text frontend against the JAX
package, on the CPU, with inputs made from a seed with numpy.

Tolerances: fp32 elementwise ops 1e-6 (same arithmetic, other libm);
attention-bearing paths 1e-4 x max|ref| (other summation orders); integer
and text outputs exactly.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu import conditioning as jcond
from zonos_tpu.config import TRANSFORMER_CONFIG_DICT as JAX_TRANSFORMER_CONFIG_DICT
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models import backbone as jbackbone
from zonos_tpu.ops import delay as jdelay
from zonos_tpu.ops import eos as jeos
from zonos_tpu.ops import norms as jnorms
from zonos_tpu.ops import rope as jrope
from zonos_tpu.ops import sampling as jsampling
from zonos_tpu.text import phonemize as jax_phonemize
from zonos_tpu.text import tokenize_phonemes as jax_tokenize
from zonos_tpu_torch import conditioning as tcond
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT, ZonosConfig
from zonos_tpu_torch.convert import convert_zonos_params, to_tensor
from zonos_tpu_torch.models import backbone as tbackbone
from zonos_tpu_torch.ops import delay as tdelay
from zonos_tpu_torch.ops import eos as teos
from zonos_tpu_torch.ops import norms as tnorms
from zonos_tpu_torch.ops import rope as trope
from zonos_tpu_torch.ops import sampling as tsampling
from zonos_tpu_torch.text import phonemize, tokenize_phonemes

GOLDEN = Path(__file__).parent / "fixtures" / "espeak_golden.json"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _tiny_dict() -> dict:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return d


def _close(ours: torch.Tensor, ref, scale_tol: float):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= scale_tol * max(np.abs(ref).max(), 1e-30)


def test_config_copy_matches():
    assert TRANSFORMER_CONFIG_DICT == JAX_TRANSFORMER_CONFIG_DICT
    ours, ref = ZonosConfig.from_dict(_tiny_dict()), JaxZonosConfig.from_dict(_tiny_dict())
    assert ours.padded_vocab_size == ref.padded_vocab_size == 1152
    assert ours.backbone.head_dim == ref.backbone.head_dim


def test_rope_matches():
    cos, sin = trope.rope_table(16)
    jcos, jsin = jrope.rope_table(16)
    assert cos.shape == (16384, 8)
    np.testing.assert_allclose(cos[:512].numpy(), np.asarray(jcos)[:512], atol=1e-6)
    np.testing.assert_allclose(sin[:512].numpy(), np.asarray(jsin)[:512], atol=1e-6)
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 16)).astype(np.float32)
    c, s = np.asarray(jcos)[7:12], np.asarray(jsin)[7:12]
    _close(trope.apply_rope(_t(x), _t(c), _t(s)), jrope.apply_rope(x, c, s), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    ref = jnorms.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype),
                            jnp.asarray(bias, dtype))
    tdt = getattr(torch, dtype)
    ours = tnorms.layer_norm(_t(x).to(tdt), _t(scale).to(tdt), _t(bias).to(tdt))
    assert ours.dtype == tdt
    # bf16: at most one bf16 rounding step apart
    _close(ours, np.asarray(ref, np.float32), 1e-6 if dtype == "float32" else 2 ** -7)


def test_delay_pattern_matches():
    codes = np.random.default_rng(2).integers(0, 1024, size=(2, 9, 13))
    ref = np.asarray(jdelay.apply_delay_pattern(jnp.asarray(codes), 1025))
    ours = tdelay.apply_delay_pattern(_t(codes), 1025)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(tdelay.revert_delay_pattern(ours).numpy(), codes)
    np.testing.assert_array_equal(tdelay.revert_delay_pattern(ref), codes)


def test_eos_state_machine_matches_over_random_sequence():
    rng = np.random.default_rng(3)
    B, K, V, eos, mask = 6, 9, 16, 10, 11
    js = jeos.EosState.init(B, 40, 6)
    ts = teos.EosState.init(B, 40, 6)
    for _ in range(40):
        logits = rng.normal(size=(B, K, V)).astype(np.float32)
        token = rng.integers(0, V, size=(B, K))
        token[:, 0] = np.where(rng.random(B) < 0.3, eos, token[:, 0])
        resampled = rng.integers(0, eos, size=(B, K))
        jl, js = jeos.eos_logit_mask(js, jnp.asarray(logits), eos)
        tl, ts = teos.eos_logit_mask(ts, _t(logits), eos)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        jt, js = jeos.eos_update(js, jnp.asarray(token), jnp.asarray(resampled), eos, mask, K, 6)
        tt, ts = teos.eos_update(ts, _t(token), _t(resampled), eos, mask, K, 6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_repetition_penalty_matches():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 9, 32)).astype(np.float32)
    window = rng.integers(-1, 34, size=(3, 9, 2))  # -1 (unknown) and >V clip like JAX
    penalty = np.array([3.0, 1.0, 2.0], np.float32)
    ref = jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(window),
                                             jnp.asarray(penalty), 2)
    ours = tsampling.apply_repetition_penalty(_t(logits), _t(window), _t(penalty), 2)
    _close(ours, ref, 1e-6)


@pytest.mark.parametrize("stage", ["unified", "top_p", "top_k", "min_p"])
def test_probability_stages_match(stage):
    rng = np.random.default_rng(5)
    probs = np.asarray(jax.nn.softmax(rng.normal(size=(2, 9, 64)).astype(np.float32) * 2))
    fns = {"unified": ((0.55, 0.4, 0.1), jsampling.apply_unified, tsampling.apply_unified),
           "top_p": ((0.8,), jsampling.apply_top_p, tsampling.apply_top_p),
           "top_k": ((5,), jsampling.apply_top_k, tsampling.apply_top_k),
           "min_p": ((0.1,), jsampling.apply_min_p, tsampling.apply_min_p)}
    args, jfn, tfn = fns[stage]
    _close(tfn(_t(probs), *args), jfn(jnp.asarray(probs), *args), 1e-5)


@pytest.mark.parametrize("params", [
    dict(),
    dict(top_p=0.7),
    dict(top_k=20, min_p=0.05),
    dict(temperature=0.0),
])
def test_sample_from_logits_matches_with_shared_noise(params):
    """The JAX sampler draws its Gumbel noise from per-row keys; the port is
    handed the same noise as an operand."""
    B, K, V = 3, 9, 1152
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(B, K, V)) * 2).astype(np.float32)
    logits[..., 1025:] = -np.inf
    window = rng.integers(0, 1025, size=(B, K, 2))
    rp = np.array([3.0, 1.0, 3.0], np.float32)
    keys = jax.random.split(jax.random.key(9), B)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (K, V), jnp.float32))(keys))
    jp, tp = jsampling.SamplingParams(**params), tsampling.SamplingParams(**params)
    ref = jsampling.sample_from_logits(keys, jnp.asarray(logits), jp, jnp.asarray(window),
                                       jnp.asarray(rp))
    ours = tsampling.sample_from_logits(_t(logits), tp, _t(noise), _t(window), _t(rp))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def conditioner():
    cfg = ZonosConfig.from_dict(_tiny_dict())
    d = cfg.backbone.d_model
    jparams = jcond.init_prefix_conditioner_params(
        jax.random.key(1), JaxZonosConfig.from_dict(_tiny_dict()).prefix_conditioner, d,
        dtype=jnp.float32)
    jparams = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(7)
    # nonzero uncond vectors and norm affine, so every branch is visible
    for name, p in jparams.items():
        for key in ("uncond_vector", "scale", "bias"):
            if key in p:
                p[key] = rng.normal(size=p[key].shape).astype(np.float32)
    tparams = convert_zonos_params({"prefix_conditioner": jparams})["prefix_conditioner"]
    return cfg, jparams, tparams


@pytest.mark.parametrize("speaker", [False, True])
def test_prefix_conditioner_matches(conditioner, speaker):
    cfg, jparams, tparams = conditioner
    spk = np.random.default_rng(8).normal(size=(1, 1, 128)).astype(np.float32) if speaker else None
    kw = dict(text=["Hello world.", "A second line, 42 words."], speaker=spk, language="en-us")
    jd, td = jcond.make_cond_dict(**kw), tcond.make_cond_dict(**kw)
    assert jd.keys() == td.keys()
    specs_j = jcond.build_specs(JaxZonosConfig.from_dict(_tiny_dict()).prefix_conditioner, 64)
    specs_t = tcond.build_specs(cfg.prefix_conditioner, 64)
    ji, ti = jcond.prepare_cond_inputs(specs_j, jd), tcond.prepare_cond_inputs(specs_t, td)
    for name in ji:
        if ji[name] is None:
            assert ti[name] is None
        else:
            np.testing.assert_array_equal(ti[name], ji[name])
    ref = jcond.prefix_conditioner_forward(jparams, specs_j,
                                           JaxZonosConfig.from_dict(_tiny_dict()).prefix_conditioner,
                                           ji)
    ours = tcond.prefix_conditioner_forward(tparams, specs_t, cfg.prefix_conditioner, ti)
    assert ours.dtype == torch.float32
    _close(ours, ref, 1e-5)


@pytest.fixture(scope="module")
def backbone():
    jcfg = JaxZonosConfig.from_dict(_tiny_dict()).backbone
    jp = jbackbone.init_transformer_params(jax.random.key(2), jcfg, dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(9)
    for name in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"):
        jp["layers"][name] = (rng.normal(size=jp["layers"][name].shape) * 0.3 + (
            1.0 if "scale" in name else 0.0)).astype(np.float32)
    tcfg = ZonosConfig.from_dict(_tiny_dict()).backbone
    return jcfg, jp, tcfg, convert_zonos_params({"backbone": jp})["backbone"]


def test_transformer_prefill_and_decode_match(backbone):
    jcfg, jp, tcfg, tp = backbone
    rng = np.random.default_rng(10)
    B, S, S_max = 2, 11, 64
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, 64)).astype(np.float32)

    jcache = jbackbone.KVCache.create(jcfg, B, S_max, dtype=jnp.float32)
    jh, jcache = jax.jit(lambda p, a, c: jbackbone.transformer_prefill(jcfg, p, a, c))(
        jp, x, jcache)
    tcache = tbackbone.KVCache.create(tcfg, B, S_max, dtype=torch.float32)
    th, tcache = tbackbone.transformer_prefill(tcfg, tp, _t(x), tcache)
    _close(th, jh, 1e-4)
    _close(tcache.k[:, :, :, :S], np.asarray(jcache.k)[:, :, :, :S], 1e-4)
    _close(tcache.v[:, :, :, :S], np.asarray(jcache.v)[:, :, :, :S], 1e-4)

    jh1, jcache = jax.jit(lambda p, a, c, i: jbackbone.transformer_decode_step(jcfg, p, a, c, i))(
        jp, x1, jcache, jnp.int32(S))
    th1, tcache = tbackbone.transformer_decode_step(tcfg, tp, _t(x1), tcache, S)
    _close(th1, jh1, 1e-4)
    _close(tcache.k[:, :, :, S], np.asarray(jcache.k)[:, :, :, S], 1e-4)


def _golden_sentences() -> list[tuple[str, str]]:
    data = json.loads(GOLDEN.read_text())
    return [(lang, row["text"]) for lang, rows in data.items() if not lang.startswith("_")
            for row in rows]


def test_text_frontend_matches_jax_on_golden_sentences():
    pairs = _golden_sentences()
    assert len(pairs) > 50
    texts, langs = [t for _, t in pairs], [lang for lang, _ in pairs]
    ours, ref = phonemize(texts, langs), jax_phonemize(texts, langs)
    assert ours == ref
    ids, lens = tokenize_phonemes(ours)
    jids, jlens = jax_tokenize(ref)
    np.testing.assert_array_equal(ids, jids)
    assert list(lens) == list(jlens)


def test_convert_takes_bf16_bits_exactly():
    jp = jbackbone.init_transformer_params(
        jax.random.key(4), JaxZonosConfig.from_dict(_tiny_dict()).backbone)  # bf16
    w = np.asarray(jp["layers"]["wqkv"])
    assert w.dtype.name == "bfloat16"
    t = to_tensor(w)
    assert t.dtype == torch.bfloat16 and t.shape == w.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
    tp = convert_zonos_params({"backbone": jax.tree.map(np.asarray, jp)}, dtype=torch.float32)
    np.testing.assert_array_equal(tp["backbone"]["layers"]["w1"].numpy(),
                                  np.asarray(jp["layers"]["w1"], np.float32))
