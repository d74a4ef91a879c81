"""The port's LoRA (``zonos_tpu_torch/parallel/lora.py``) against the JAX
package's, on the CPU, on the tiny backbones of ``tests/test_train.py``.

Covered: ``init_lora``'s targets and shapes (the backbone's projections,
never the conditioner's ``w1``/``w2``), ``merge_lora`` on the same adapters,
the adapters' gradients through the merged weights, a LoRA step changing
only the adapters (every base leaf keeps its bits), and the loss falling
over LoRA steps.  Weights start from the JAX init carried across in fp32.

Tolerances: the merge within 1e-6 of max |W| (the same fp32 products and
sum); the loss within 1e-5 relative; each adapter gradient within 1e-4 of
its max (other summation orders through the layers).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.parallel import lora as jlora
from zonos_tpu_torch import ZonosConfig
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params, to_tensor
from zonos_tpu_torch.parallel import lora as tlora
from zonos_tpu_torch.parallel import train as ttrain

TINY = {
    "transformer": (TRANSFORMER_CONFIG_DICT,
                    dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                         attn_cfg={"num_heads": 4, "num_heads_kv": 2})),
    "hybrid": (HYBRID_CONFIG_DICT,
               dict(d_model=64, n_layer=4, attn_layer_idx=[1, 3], attn_mlp_d_intermediate=128,
                    ssm_cfg={"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16},
                    attn_cfg={"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                              "rotary_emb_dim": 8})),
}
KINDS = tuple(TINY)


def _dict(kind: str) -> dict:
    base, backbone = TINY[kind]
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(backbone))
    return d


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind in KINDS:
        jcfg = JaxZonosConfig.from_dict(_dict(kind))
        jm = JaxZonos(jcfg, seed=0)
        jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jm.params)
        tparams = convert_zonos_params(jax.tree.map(np.asarray, jparams))
        out[kind] = (jcfg, jparams, ZonosConfig.from_dict(_dict(kind)), tparams, jm.specs)
    return out


def _adapter_paths(tree, path=()) -> dict:
    """path -> (a shape, b shape) of every adapter in a tree (JAX or port)."""
    if isinstance(tree, dict) and set(tree) == {"a", "b"}:
        return {path: (tuple(tree["a"].shape), tuple(tree["b"].shape))}
    if isinstance(tree, dict):
        return {q: v for k, t in tree.items() for q, v in _adapter_paths(t, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {q: v for i, t in enumerate(tree)
                for q, v in _adapter_paths(t, path + (str(i),)).items()}
    return {}


def _jax_adapters_to_port(ad):
    if ad is None:
        return None
    if isinstance(ad, dict) and set(ad) == {"a", "b"}:
        return {k: to_tensor(np.asarray(v)) for k, v in ad.items()}
    if isinstance(ad, dict):
        return {k: _jax_adapters_to_port(v) for k, v in ad.items()}
    return [_jax_adapters_to_port(v) for v in ad]


def _random_b(adapters, seed: int):
    """The adapters with a nonzero ``b`` (a fresh init's is zero, whose ``a``
    then gets no gradient)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.05, jnp.float32)
                        if x.ndim >= 2 and not np.any(np.asarray(x)) else x, adapters)


def _batch(specs, B: int = 2, seed: int = 3):
    rng = np.random.default_rng(seed)
    inputs = {s.name: None for s in specs}
    inputs["espeak"] = rng.integers(4, 60, size=(B, 16)).astype(np.int32)
    inputs["speaking_rate"] = rng.uniform(5, 30, size=(B, 1, 1)).astype(np.float32)
    codes = rng.integers(0, 1024, size=(B, 9, 12)).astype(np.int32)
    return inputs, codes


@pytest.mark.parametrize("kind", KINDS)
def test_init_lora_targets_match_jax(models, kind):
    _, jparams, _, tparams, _ = models[kind]
    jad = jlora.init_lora(jax.random.key(1), jparams, rank=4)
    tad = tlora.init_lora(torch.Generator().manual_seed(1), tparams, rank=4)
    ours = _adapter_paths(tad)
    assert ours == {tuple(str(k) for k in p): v for p, v in _adapter_paths(jad).items()}
    assert ours and all(p[0] == "backbone" for p in ours)  # never the conditioner's w1/w2
    assert {p[-1] for p in ours} <= set(tlora.DEFAULT_TARGETS)
    assert tlora.count_lora_params(tad) == jlora.count_lora_params(jad)
    for leaf in ttrain.tree_leaves(tad):
        assert leaf.dtype == torch.float32
    # b is zero: the merged model is the base, bit for bit
    for a, b in zip(ttrain.tree_leaves(tparams), ttrain.tree_leaves(tlora.merge_lora(tparams, tad))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_lora_matches_jax(models, kind):
    _, jparams, _, tparams, _ = models[kind]
    jad = _random_b(jlora.init_lora(jax.random.key(2), jparams, rank=4), seed=2)
    jm = convert_zonos_params(jax.tree.map(np.asarray, jlora.merge_lora(jparams, jad, 16.0)))
    tm = tlora.merge_lora(tparams, _jax_adapters_to_port(jad), 16.0)
    changed = 0
    for a, r, base in zip(ttrain.tree_leaves(tm), ttrain.tree_leaves(jm),
                          ttrain.tree_leaves(tparams)):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * float(r.abs().max()))
        changed += not torch.equal(a, base)
    assert changed >= 4


@pytest.mark.parametrize("kind", KINDS)
def test_lora_gradients_match_jax(models, kind):
    jcfg, jparams, tcfg, tparams, specs = models[kind]
    inputs, codes = _batch(specs)
    jad = _random_b(jlora.init_lora(jax.random.key(3), jparams, rank=4), seed=3)
    jl, jg = jax.value_and_grad(lambda ad: jax.jit(jlora.make_lora_eval_fn(jcfg, specs))(
        ad, jparams, inputs, jnp.asarray(codes)))(jad)
    tl, tg = ttrain.value_and_grad(
        lambda ad: ttrain.conditioned_loss(tcfg, specs, tlora.merge_lora(tparams, ad), inputs,
                                           codes, None, 0.0), _jax_adapters_to_port(jad))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ref = ttrain.tree_leaves(_jax_adapters_to_port(jg))
    ours = ttrain.tree_leaves(tg)
    assert len(ours) == len(ref) >= 8
    for g, r in zip(ours, ref):
        scale = float(r.abs().max())
        assert scale > 0
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("kind", KINDS)
def test_lora_step_changes_only_the_adapters(models, kind):
    _, _, tcfg, tparams, specs = models[kind]
    inputs, codes = _batch(specs, B=4)
    base = ttrain.tree_flatten(tparams)[1]([t.clone() for t in ttrain.tree_flatten(tparams)[0]])
    adapters = tlora.init_lora(torch.Generator().manual_seed(4), base, rank=4)
    first = [t.clone() for t in ttrain.tree_leaves(adapters)]
    opt = ttrain.make_optimizer(lr=1e-2)
    step = tlora.make_lora_train_step(tcfg, specs, opt, uncond_p=0.0)
    state = opt.init(adapters)
    losses = []
    for i in range(6):
        adapters, state, loss = step(adapters, state, base, inputs, codes,
                                     torch.Generator().manual_seed(i))
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for a, b in zip(ttrain.tree_leaves(base), ttrain.tree_leaves(tparams)):
        assert torch.equal(a, b) and not a.requires_grad
    assert all(not torch.equal(a, b) for a, b in zip(ttrain.tree_leaves(adapters), first))
    held = tlora.make_lora_eval_fn(tcfg, specs)(adapters, base, inputs, codes)
    assert torch.isfinite(held) and held.grad_fn is None
