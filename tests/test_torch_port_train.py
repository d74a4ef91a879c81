"""The port's training (``zonos_tpu_torch/parallel/train.py``) against the JAX
package's, on the CPU, on the tiny backbones of ``tests/test_train.py``.

Inputs are made from numpy seeds; both sides start from the JAX init carried
across by ``convert.py`` in fp32.  Covered: the teacher-forced loss and every
leaf's gradient for both backbones, the conditioned loss fed JAX's own CFG
dropout masks, remat and accumulation, the teacher-forced logits against
the prefill-and-decode logits, AdamW and Adafactor (with clipping and the
warmup-cosine schedule) against optax, one AdamW train step against JAX's,
and the autograd routes of G1, N1 and K6 with their fold guard.

Tolerances: a loss within 1e-5 relative; each gradient leaf within 1e-4 of
that leaf's max |grad| (other summation orders through 2-4 layers); an
optimizer's updates within 1e-6 relative (elementwise fp32 arithmetic; the
global norm summed in another order); one train step's parameters within
1e-5 of the leaf's max |p| (AdamW normalises each gradient element, so
gradient differences of 1e-6 relative reach the update unscaled); remat
against no remat and accumulated against full-batch steps as
tests/test_train.py holds JAX's (1e-6 / 1e-4 relative, 1e-5 / 2e-5
absolute); a kernel route's gradients bit for bit the plain version's
autograd.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.parallel import train as jtrain
from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.kernels import gemm as g1
from zonos_tpu_torch.kernels import row_norm as n1
from zonos_tpu_torch.kernels import ssd as k6
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.models.tts import apply_heads, embed_codes
from zonos_tpu_torch.ops import quant
from zonos_tpu_torch.ops.delay import apply_delay_pattern
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
    """kind -> (JAX config, JAX fp32 params, port config, port fp32 params, specs)."""
    out = {}
    for kind in KINDS:
        jcfg = JaxZonosConfig.from_dict(_dict(kind))
        jm = JaxZonos(jcfg, seed=0)
        jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jm.params)
        tparams = convert_zonos_params(jax.tree.map(np.asarray, jparams))
        out[kind] = (jcfg, jparams, ZonosConfig.from_dict(_dict(kind)), tparams, jm.specs)
    return out


def _batch(d_model: int, B: int = 2, Lc: int = 3, T: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(B, Lc, d_model)).astype(np.float32)
    codes = rng.integers(0, 1024, size=(B, 9, T)).astype(np.int32)
    return cond, codes


def _cond_inputs(specs, B: int, seed: int = 1) -> dict:
    """An input for every conditioner, as the loader makes them."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in specs:
        if s.type == "Espeak":
            out[s.name] = rng.integers(4, 60, size=(B, 16)).astype(np.int32)
        elif s.type == "Integer":
            out[s.name] = rng.integers(0, 100, size=(B, 1, 1)).astype(np.int32)
        elif s.type == "Passthrough":
            out[s.name] = rng.normal(size=(B, 1, s.cond_dim)).astype(np.float32)
        else:
            lo, hi = s.min_val, s.max_val
            out[s.name] = rng.uniform(lo, hi, size=(B, 1, s.input_dim)).astype(np.float32)
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _paths(v, path + (i,))]
    return [path]


def _assert_grads(tgrads, jgrads, specs=(), rel: float = 1e-4):
    """Every leaf within ``rel`` of the leaf's max |JAX grad| (an unreached
    port leaf, None, counts as zeros).  A Fourier conditioner's leaves (its
    ``weight`` and its uncond vector) get their gradients through the
    reference's bf16 features (zonos_tpu/conditioning.py:150-151, and the
    uncond vector cast to them), so they are held to 1e-2: sums of cotangents
    each rounded to bf16 (2^-8) where either compiler rounds."""
    jtree = convert_zonos_params(jax.tree.map(np.asarray, jgrads))
    ref = ttrain.tree_flatten(jtree)[0]
    ours = ttrain.tree_flatten(tgrads)[0]
    assert len(ref) == len(ours)
    bf16_cast = {("prefix_conditioner", s.name) for s in specs if s.type == "Fourier"}
    reached = 0
    for path, g, r in zip(_paths(jtree), ours, ref):
        r = r.numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        scale = np.abs(r).max()
        tol = 1e-2 if path[:2] in bf16_cast else rel
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale if scale else 0.0,
                                   err_msg=str(path))
        reached += scale > 0
    assert reached >= 10  # the comparison is not of zeros


@pytest.mark.parametrize("kind", KINDS)
def test_multicodebook_loss_and_grads_match_jax(models, kind):
    jcfg, jparams, tcfg, tparams, _ = models[kind]
    cond, codes = _batch(tcfg.backbone.d_model)
    jl, jg = jax.value_and_grad(
        lambda p: jtrain.multicodebook_loss(jcfg, p, jnp.asarray(cond), jnp.asarray(codes)))(
        jparams)
    tl, tg = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, torch.from_numpy(cond), codes), tparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("kind", KINDS)
def test_conditioned_loss_with_jax_masks(models, kind):
    """JAX's own CFG dropout masks (drawn as ``conditioned_loss`` draws them)
    fed to the port as ``uncond_drop``: the same loss and gradients."""
    jcfg, jparams, tcfg, tparams, specs = models[kind]
    B, p = 4, 0.5
    inputs = _cond_inputs(specs, B)
    _, codes = _batch(tcfg.backbone.d_model, B=B, seed=2)
    key = jax.random.key(7)
    names = [s.name for s in specs if s.uncond and inputs.get(s.name) is not None]
    joint_key, *keys = jax.random.split(key, len(names) + 1)
    joint = jax.random.bernoulli(joint_key, p, (B,))
    masks = {n: np.asarray(joint | jax.random.bernoulli(k, p, (B,))) for n, k in zip(names, keys)}
    drawn = np.stack(list(masks.values()))
    assert drawn.any() and not drawn.all()
    jl, jg = jax.value_and_grad(lambda q: jtrain.conditioned_loss(
        jcfg, specs, q, inputs, jnp.asarray(codes), drop_key=key, uncond_p=p))(jparams)
    tl, tg = ttrain.value_and_grad(lambda q: ttrain.conditioned_loss(
        tcfg, specs, q, inputs, codes, uncond_drop={n: torch.tensor(m)
                                                    for n, m in masks.items()}), tparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads(tg, jg, specs)


def test_cfg_dropout_masks_order():
    """The joint mask first, then each conditioner's own, from the generator."""
    specs = Zonos(ZonosConfig.from_dict(_dict("transformer")), device="cpu").specs
    inputs = _cond_inputs(specs, 64)
    masks = ttrain.cfg_dropout_masks(specs, inputs, 64, 0.3, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    joint = torch.rand(64, generator=gen) < 0.3
    names = [s.name for s in specs if s.uncond]
    assert list(masks) == names
    for n in names:
        torch.testing.assert_close(masks[n], joint | (torch.rand(64, generator=gen) < 0.3),
                                   rtol=0, atol=0)
    assert ttrain.cfg_dropout_masks(specs, inputs, 64, 0.0, gen) is None


def test_remat_matches_plain(models):
    _, _, tcfg, tparams, _ = models["transformer"]
    cond, codes = _batch(tcfg.backbone.d_model, B=4)
    cond = torch.from_numpy(cond)
    l0, g0 = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, cond, codes, remat=False), tparams)
    l1, g1_ = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, cond, codes, remat=True), tparams)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(ttrain.tree_leaves(g1_), ttrain.tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_accumulation_matches_full_batch(models):
    _, _, tcfg, tparams, specs = models["transformer"]
    cond, codes = _batch(tcfg.backbone.d_model, B=4)
    opt = ttrain.make_optimizer(lr=1e-3, grad_clip=None)
    outs = [ttrain.make_train_step(tcfg, opt, accum_steps=a)(
        tparams, opt.init(tparams), torch.from_numpy(cond), codes) for a in (1, 2)]
    np.testing.assert_allclose(float(outs[0][2]), float(outs[1][2]), rtol=1e-5)
    for a, b in zip(ttrain.tree_leaves(outs[0][0]), ttrain.tree_leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)

    # the conditioned step, deterministic at uncond_p 0, with a batch-broadcast input
    inputs = _cond_inputs(specs, 4)
    inputs["speaker"] = inputs["speaker"][:1]
    opt = ttrain.make_optimizer(lr=1e-3)
    outs = [ttrain.make_conditioned_train_step(tcfg, specs, opt, uncond_p=0.0, accum_steps=a)(
        tparams, opt.init(tparams), inputs, codes) for a in (1, 2)]
    assert abs(float(outs[0][2]) - float(outs[1][2])) < 1e-4
    for a, b in zip(ttrain.tree_leaves(outs[0][0]), ttrain.tree_leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        ttrain.make_train_step(tcfg, opt, accum_steps=3)(
            tparams, opt.init(tparams), torch.from_numpy(cond), codes)


@pytest.mark.parametrize("kind", KINDS)
def test_train_matches_inference(models, kind):
    """The teacher-forced logits at each audio position equal the logits of a
    prefill over the prefix and the first delayed frame, then one decode step
    a frame: the alignment the decode loop asks of training."""
    _, _, tcfg, tparams, _ = models[kind]
    model = Zonos(tcfg, params=tparams, device="cpu")
    cond, codes = _batch(tcfg.backbone.d_model, B=2, T=6, seed=4)
    cond = torch.from_numpy(cond)
    with torch.no_grad():
        logits, _ = ttrain.teacher_forced_logits(tcfg, tparams, cond, codes)
        delayed = apply_delay_pattern(torch.from_numpy(codes).long(), tcfg.masked_token_id)
        n = logits.shape[1]
        cache = model.backbone.make_cache(tcfg.backbone, 2, 64, torch.float32, "cpu")
        x = torch.cat([cond, embed_codes(tparams, delayed[..., :1])], dim=1)
        hidden, cache = model.backbone.prefill(tcfg.backbone, tparams["backbone"], x, cache)
        steps = [apply_heads(tparams, tcfg, hidden[:, -1])]
        for j in range(1, n):
            h = embed_codes(tparams, delayed[..., j:j + 1])
            hidden, cache = model.backbone.decode_step(tcfg.backbone, tparams["backbone"], h,
                                                       cache, cond.shape[1] + j)
            steps.append(apply_heads(tparams, tcfg, hidden[:, -1]))
    ref = torch.stack(steps, dim=1)
    scale = float(ref.abs().max())
    torch.testing.assert_close(logits, ref, rtol=0, atol=1e-5 * scale)


def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (2, 256, 160), "m": (130, 129), "s": (64, 64), "v": (300,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_optax(kind):
    """Three updates on the same params and gradients, with clipping at the
    warmup-cosine schedule's first values (lr 0, half, peak): optax's within
    1e-6 relative.  The gradients' global norms straddle the clip (20, 0.5, 3)."""
    kw = dict(lr=1e-2, weight_decay=0.01, warmup_steps=2, total_steps=10, grad_clip=1.0,
              kind=kind)
    jopt, topt = jtrain.make_optimizer(**kw), ttrain.make_optimizer(**kw)
    params = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    if kind == "adafactor":  # factored: O(rows + cols) for the large matrices
        assert tuple(tstate["v_row"][0].shape) == (2, 160) and tuple(tstate["v_col"][0].shape) == (2, 256)
        assert tuple(tstate["v_row"][1].shape) == (129,) and tuple(tstate["v_col"][1].shape) == (130,)
        assert tuple(tstate["v"][2].shape) == (64, 64) and tuple(tstate["v"][0].shape) == (1,)
    for step, norm in enumerate((20.0, 0.5, 3.0)):
        g = _opt_tree(10 + step)
        total = np.sqrt(sum(float((x ** 2).sum()) for x in g.values()))
        g = {k: (v * (norm / total)).astype(np.float32) for k, v in g.items()}
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        for k in params:
            ref = np.asarray(ju[k])
            np.testing.assert_allclose(tu[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
        jp = optax.apply_updates(jp, ju)
        tp = ttrain.apply_updates(tp, tu)
    assert tstate["count"] == 3


@pytest.mark.parametrize("total,warmup", [(10, 2), (None, 3), (None, 0)])
def test_schedules_match_optax(total, warmup):
    ref = (optax.warmup_cosine_decay_schedule(0.0, 3e-4, max(warmup, 1), max(total, warmup + 1))
           if total else optax.linear_schedule(0.0, 3e-4, warmup) if warmup else None)
    ours = (ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, max(warmup, 1), max(total, warmup + 1))
            if total else ttrain.linear_schedule(0.0, 3e-4, warmup) if warmup else None)
    if ref is None:
        return
    for c in range(12):
        np.testing.assert_allclose(ours(c), float(ref(jnp.int32(c))), rtol=1e-6, atol=1e-12)


def test_one_train_step_matches_jax(models):
    """AdamW's first step moves an element by lr g / (|g| + 1e-8): where the
    JAX gradient is nonzero but below 1e-4 of its leaf's max, that ratio is
    set by the gradients' last bits, and the element is held to within 2 lr
    (the step's whole range) instead; such elements are under 5% of each
    leaf."""
    jcfg, jparams, tcfg, tparams, _ = models["transformer"]
    cond, codes = _batch(tcfg.backbone.d_model, B=2)
    kw = dict(lr=1e-3, warmup_steps=0, grad_clip=1.0)
    jopt, topt = jtrain.make_optimizer(**kw), ttrain.make_optimizer(**kw)
    jnew, _, jl = jax.jit(jtrain.make_train_step(jcfg, jopt))(
        jparams, jopt.init(jparams), jnp.asarray(cond), jnp.asarray(codes))
    jg = jax.grad(lambda p: jtrain.multicodebook_loss(jcfg, p, jnp.asarray(cond),
                                                      jnp.asarray(codes)))(jparams)
    tnew, tstate, tl = ttrain.make_train_step(tcfg, topt)(
        tparams, topt.init(tparams), torch.from_numpy(cond), codes)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ref = ttrain.tree_flatten(convert_zonos_params(jax.tree.map(np.asarray, jnew)))[0]
    grads = ttrain.tree_flatten(convert_zonos_params(jax.tree.map(np.asarray, jg)))[0]
    moved = 0
    for new, r, g, old in zip(ttrain.tree_flatten(tnew)[0], ref, grads,
                              ttrain.tree_flatten(tparams)[0]):
        r, g, new = r.numpy(), np.abs(g.numpy()), new.numpy()
        tiny = (g > 0) & (g < 1e-4 * g.max())
        tol = 1e-5 * np.abs(r).max()
        assert tiny.mean() < 0.05 or g.max() == 0
        np.testing.assert_allclose(new[~tiny], r[~tiny], rtol=0, atol=tol)
        np.testing.assert_allclose(new[tiny], r[tiny], rtol=0, atol=2 * kw["lr"] + tol)
        moved += not np.array_equal(new, old.numpy())
    assert moved > 10 and tstate["count"] == 1


# ---------------------------------------------------------------------------
# The kernels' autograd routes, on the CPU (each Function's forward is the
# plain version there; the backward is the same code on the card)
# ---------------------------------------------------------------------------


def _plain_grads(fn, inputs, dy):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_grad_route(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(24, 64, generator=gen).to(dtype)
    w = (torch.randn(64, 48, generator=gen) / 8).to(dtype)
    dy = torch.randn(24, 48, generator=gen).to(dtype)
    ref, (dx_ref, dw_ref) = _plain_grads(g1.gemm_plain, (x, w), dy)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = g1.gemm(xs, ws)
    assert type(y.grad_fn).__name__ == "_GemmGradBackward"
    dx, dw = torch.autograd.grad(y, (xs, ws), dy)
    for a, b in ((y, ref), (dx, dx_ref), (dw, dw_ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with torch.no_grad():  # no grad required: the forward alone, no Function
        assert g1.gemm(xs, ws).grad_fn is None
    q = torch.zeros(64, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="gradient"):
        g1.gemm(xs, q, torch.ones(48, dtype=torch.bfloat16))


@pytest.mark.parametrize("rms,bias", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_norm_grad_route(rms, bias, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(6, 5, 64, generator=gen) * 3 + 1).to(dtype)
    scale = (1 + torch.randn(64, generator=gen) / 4).to(torch.bfloat16)
    b = (torch.randn(64, generator=gen) / 4).to(torch.bfloat16) if bias else None
    dy = torch.randn(6, 5, 64, generator=gen).to(dtype)
    inputs = (x, scale) + ((b,) if bias else ())

    def plain(x, s, b=None):
        return n1.norm_plain(x, Norm(s, b, 1e-5, rms))

    def route(x, s, b=None):
        return n1.rms_norm(x, s, 1e-5, b) if rms else n1.layer_norm(x, s, b, 1e-5)

    ref, gref = _plain_grads(plain, inputs, dy)
    y, grads = _plain_grads(route, inputs, dy)
    assert torch.equal(y, ref) and all(torch.equal(a, r) for a, r in zip(grads, gref))
    live = [t.detach().requires_grad_() for t in inputs]
    assert type(route(*live).grad_fn).__name__ == "_NormGradBackward"


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_grad_route(with_init):
    """K6's route: the gradients of y and of the final state, and of y alone
    (the final state's gradient arriving as zeros), are the plain version's."""
    gen = torch.Generator().manual_seed(2)
    B, L, H, G, P, N = 2, 70, 4, 2, 8, 8
    x = torch.randn(B, L, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=gen))
    A = -torch.rand(H, generator=gen) - 0.1
    Bm, Cm = torch.randn(B, L, G, N, generator=gen), torch.randn(B, L, G, N, generator=gen)
    D = torch.randn(H, generator=gen)
    inputs = [x, dt, A, Bm, Cm, D] + ([torch.randn(B, H, P, N, generator=gen)] if with_init else [])
    dy, dh = torch.randn(B, L, H, P, generator=gen), torch.randn(B, H, P, N, generator=gen)
    for final_used in (True, False):
        def loss(fn, ts):
            y, h = fn(*ts)
            return (y * dy).sum() + ((h * dh).sum() if final_used else 0.0)

        a = [t.clone().requires_grad_() for t in inputs]
        b = [t.clone().requires_grad_() for t in inputs]
        ga = torch.autograd.grad(loss(k6.ssd_chunked, a), a)
        gb = torch.autograd.grad(loss(k6.ssd_chunked_plain, b), b)
        assert all(torch.equal(u, v) for u, v in zip(ga, gb))


def test_hybrid_training_forward_goes_through_the_ssd_route(models, monkeypatch):
    """The hybrid's training loss reaches K6's Function, and its gradients
    equal those with the op layer's call replaced by the plain version."""
    _, _, tcfg, tparams, _ = models["hybrid"]
    cond, codes = _batch(tcfg.backbone.d_model)
    cond = torch.from_numpy(cond)
    calls = []
    backward = k6._SsdGrad.backward

    def counted(ctx, *grads):
        calls.append(1)
        return backward(ctx, *grads)

    monkeypatch.setattr(k6._SsdGrad, "backward", staticmethod(counted))
    _, routed = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, cond, codes), tparams)
    assert len(calls) == 2  # the tiny hybrid's two Mamba2 layers
    monkeypatch.setattr(k6, "ssd_chunked", k6.ssd_chunked_plain)
    _, plain = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, cond, codes), tparams)
    for a, b in zip(ttrain.tree_flatten(routed)[0], ttrain.tree_flatten(plain)[0]):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


def test_fold_guard():
    """``norm_matmul`` folds a norm into the product's launch only when no
    gradient is required; under grad it runs N1, then G1, each with its own."""
    x = torch.randn(2, 64)
    w = torch.randn(64, 32).to(torch.bfloat16)
    norm = Norm(torch.ones(64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16),
                1e-5, False)
    assert quant.fold_allowed(x, norm, w)
    assert not quant.fold_allowed(x.clone().requires_grad_(), norm, w)
    assert not quant.fold_allowed(x, norm, w.clone().requires_grad_())
    assert not quant.fold_allowed(x, norm._replace(scale=norm.scale.clone().requires_grad_()), w)
    with torch.no_grad():
        assert quant.fold_allowed(x.clone().requires_grad_(), norm, w.clone().requires_grad_())
    with pytest.raises(ValueError, match="gradient"):
        g1.gemm(x.to(torch.bfloat16).requires_grad_(), w, norm=norm)


@pytest.mark.parametrize("kind", KINDS)
def test_training_after_a_generate(models, kind):
    """A generate (under ``torch.inference_mode``) first builds the shared RoPE
    table; a training forward in the same process must still save it for
    its backward."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.ops.rope import cached_rope_table

    _, _, tcfg, tparams, _ = models[kind]
    cached_rope_table.cache_clear()
    model = Zonos(tcfg, params=tparams, device="cpu")
    model.generate(model.prepare_conditioning(make_cond_dict(text="Hi.")), max_new_tokens=4,
                   progress_bar=False)
    cond, codes = _batch(tcfg.backbone.d_model)
    loss, grads = ttrain.value_and_grad(
        lambda p: ttrain.multicodebook_loss(tcfg, p, torch.from_numpy(cond), codes), tparams)
    assert torch.isfinite(loss) and grads["backbone"] is not None
