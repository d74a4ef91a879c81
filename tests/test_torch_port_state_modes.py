"""The port's int8 and int4 SSM-state modes against the JAX package, on the
CPU.

JAX computes these modes with XLA ops around its plain decode step
(zonos_tpu/models/hybrid.py ``_load_ssm`` / ``_store_ssm``); the port stores
them in K7 (``kernels/ssm_state.py``), whose plain version is held here.
Covered: the store and the load on the same fp32 states (int8 bytes, int4
packed bytes and scales equal; the on-grid round trip exact), the K7 plain
version against JAX's load -> ``ssd_decode_step`` -> store, the tiny hybrid's
prefill and four decode steps with JAX caches built in each mode by hand
(JAX's mixer takes the mode from the cache's keys), and the drift ceilings
of ``tests/test_hybrid.py``.

Tolerances: the decode step's y 1e-5 x max|ref|; hidden states 1e-4 x
max|ref| (other summation orders in the prefill scan); stored values and
scales equal where both sides quantize the same fp32 state, and after a step
(whose fp32 state may differ by an ulp: another libm's exp, XLA's fused
multiply-adds) scales within one fp32 ulp and values within one grid step,
at most 1 in 500 of them apart.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models import hybrid as jhybrid
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops import ssm as jssm
from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels.ssm_state import (
    dequantize_state,
    fused_state_step,
    fused_state_step_plain,
    kernel_takes,
    quantize_state,
    storage_ulp,
)
from zonos_tpu_torch.models import hybrid as thybrid

MODES = ("int8", "int4")
KEYS = {"int8": "ssm", "int4": "ssm_q4"}
TINY_HYBRID = {"d_model": 64, "n_layer": 3, "attn_layer_idx": [1], "attn_mlp_d_intermediate": 128,
               "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16,
                           "d_conv": 4, "ngroups": 1},
               "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                            "rotary_emb_dim": 8}}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _tiny_dict() -> dict:
    d = copy.deepcopy(HYBRID_CONFIG_DICT)
    d["backbone"].update(copy.deepcopy(TINY_HYBRID))
    return d


def _jax_entry(mode: str, B: int, H: int, P: int, N: int) -> dict:
    """An empty JAX cache entry in ``mode``, as create_hybrid_cache lays it out."""
    width = N // 2 if mode == "int4" else N
    return {KEYS[mode]: jnp.zeros((B, H, P, width), jnp.int8),
            "ssm_scale": jnp.ones((B, H, 1, 1), jnp.float32)}


def _assert_stored_close(q, scale, ref_q, ref_scale, mode: str, scale_rtol: float = 0.0
                         ) -> None:
    """The port's stored state (``q`` and ``scale`` tensors) against JAX's:
    scales within one fp32 ulp (or ``scale_rtol``), dequantized values within
    one grid step, at most 1 in 500 stored bytes apart."""
    ref_q, ref_scale = np.asarray(ref_q), np.asarray(ref_scale)
    got_scale = scale.numpy().reshape(ref_scale.shape)
    tol = np.maximum(np.spacing(ref_scale), scale_rtol * ref_scale)
    assert (np.abs(got_scale - ref_scale) <= tol).all()
    got = dequantize_state(q, scale.reshape(ref_scale.shape), mode).numpy()
    ref = dequantize_state(torch.from_numpy(ref_q.copy()), torch.from_numpy(ref_scale.copy()),
                           mode).numpy()
    assert (np.abs(got - ref) <= ref_scale * (1 + 1e-5)).all()
    assert (q.numpy() != ref_q).mean() <= 2e-3


def _states(seed: int, shape=(2, 3, 8, 16)) -> np.ndarray:
    """fp32 states whose heads span four orders of magnitude."""
    rng = np.random.default_rng(seed)
    spread = rng.uniform(-2, 2, size=shape[:2] + (1, 1))
    return (rng.normal(size=shape) * 10.0 ** spread).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_store_and_load_match_jax(mode, seed):
    s = _states(seed)
    ref = jax.jit(jhybrid._store_ssm)(jnp.asarray(s), _jax_entry(mode, *s.shape))
    q, scale = quantize_state(_t(s), mode)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref[KEYS[mode]]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["ssm_scale"]))
    back = dequantize_state(q, scale, mode)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jhybrid._load_ssm(ref)))


@pytest.mark.parametrize("mode", MODES)
def test_on_grid_states_round_trip_exactly(mode):
    """A state on the grid (integers up to the limit times a head's scale, the
    limit reached) stores and loads back exactly, as tests/test_hybrid.py:202
    holds for JAX; the int4 nibbles cover -7..7 at both positions of a byte."""
    lim = {"int8": 127, "int4": 7}[mode]
    rng = np.random.default_rng(7)
    B, H, P, N = 2, 3, 4, 8
    q = rng.integers(-lim, lim + 1, size=(B, H, P, N)).astype(np.float32)
    q[:, :, 0, 0] = lim
    if mode == "int4":  # every nibble value at both positions of a byte
        q[0, 0, 1], q[0, 0, 2] = np.arange(-7, 1), np.arange(0, 8)
        q[0, 0, 3] = q[0, 0, 2][::-1]
    scale = (2.0 ** rng.integers(-6, 6, size=(B, H, 1, 1))).astype(np.float32)
    s = _t(q * scale)
    stored, new_scale = quantize_state(s, mode)
    assert torch.equal(dequantize_state(stored, new_scale, mode), s)


@pytest.mark.parametrize("mode", MODES)
def test_k7_plain_matches_jax_decode_step(mode):
    """One step through the plain K7 (the state half) and ops/ssm.py's
    ``ssd_decode_step`` against JAX's load -> ssd_decode_step -> store: y
    within 1e-5 x max|ref|, the stored state as ``_assert_stored_close``."""
    from zonos_tpu_torch.ops import ssm as tssm

    rng = np.random.default_rng(11)
    B, H, P, N, G = 2, 4, 8, 32, 1
    s0 = _states(5, (B, H, P, N))
    entry = jax.jit(jhybrid._store_ssm)(jnp.asarray(s0), _jax_entry(mode, B, H, P, N))
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, G, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)

    def jax_step(entry, x, dt, A, Bm, Cm, D):
        y, new = jssm.ssd_decode_step(x, dt, A, Bm, Cm, D, jhybrid._load_ssm(entry))
        return y, jhybrid._store_ssm(new, entry)

    ref_y, ref = jax.jit(jax_step)(entry, x, dt, A, Bm, Cm, D)
    state, scale = _t(entry[KEYS[mode]]), _t(entry["ssm_scale"])
    before = dict(launch_counts)
    y, out = tssm.ssd_decode_step(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D), state, scale)
    assert launch_counts == before  # the CPU runs the plain version
    assert out is state
    ref_y = np.asarray(ref_y)
    assert np.abs(y.numpy() - ref_y).max() <= 1e-5 * np.abs(ref_y).max()
    _assert_stored_close(state, scale, ref[KEYS[mode]], ref["ssm_scale"], mode)


@pytest.mark.parametrize("mode", MODES)
def test_k7_wrapper_on_the_cpu_is_its_plain_version(mode):
    """The wrapper on CPU tensors runs the plain version (the same bytes),
    and ``kernel_takes`` accepts the flagship's int8 and int4 widths by dtype
    and shape; ``storage_ulp`` is the head's grid step."""
    rng = np.random.default_rng(3)
    BH, P, N = 6, 64, 128
    q, scale = quantize_state(_t(_states(9, (BH, 1, P, N))), mode)
    q, scale = q[:, 0].contiguous(), scale.reshape(BH).contiguous()
    C, Bv = (_t(rng.normal(size=(BH, N)).astype(np.float32)) for _ in range(2))
    dA = _t(rng.uniform(0.5, 1.0, size=(BH, 1)).astype(np.float32))
    xdt = _t(rng.normal(size=(BH, P)).astype(np.float32))
    assert kernel_takes(q, C, Bv, dA, xdt, scale)
    assert not kernel_takes(q, C, Bv, dA, xdt, None)  # a quantized state needs its scales
    ulp = storage_ulp(q, scale)
    assert ulp.shape == q.shape and torch.equal(ulp[:, 0, 0], scale)
    q2, scale2 = q.clone(), scale.clone()
    y_ref, _ = fused_state_step_plain(q, C, Bv, dA, xdt, scale)
    y, _ = fused_state_step(q2, C, Bv, dA, xdt, scale2)
    assert torch.equal(y, y_ref) and torch.equal(q2, q) and torch.equal(scale2, scale)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict()),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    return jm, tm


def _jax_cache(cfg, mode: str, B: int, S: int) -> tuple:
    """JAX's fp32 cache with its Mamba2 layers' states rebuilt in ``mode``, as
    tests/test_hybrid.py:216-226 lays them out."""
    cache = jhybrid.create_hybrid_cache(cfg, B, S, dtype=jnp.float32)
    out = []
    for st in cache:
        if "ssm" in st:
            B_, H, P, N = st["ssm"].shape
            st = {"conv": st["conv"], **_jax_entry(mode, B_, H, P, N)}
        out.append(st)
    return tuple(out)


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_prefill_and_decode_match_jax(tiny, mode):
    """hybrid_prefill and four hybrid_decode_steps with the state in ``mode``:
    the hidden states within 1e-4 x max|ref| of JAX's, and every layer's
    stored state as ``_assert_stored_close``, its scales (the absmax of an
    fp32 state that the scan sums in another order) within 1e-4 relative, as
    tests/test_torch_port_hybrid.py holds the fp32 states."""
    jm, tm = tiny
    cfg_j, cfg_t = jm.config.backbone, tm.config.backbone
    rng = np.random.default_rng(3)
    B, S, steps = 2, 10, 4
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    jc = _jax_cache(cfg_j, mode, B, 32)
    tc = thybrid.create_hybrid_cache(cfg_t, B, 32, torch.float32, ssm_state=mode)
    ref, jc = jhybrid.hybrid_prefill(cfg_j, jm.params["backbone"], jnp.asarray(x), jc)
    ours, tc = thybrid.hybrid_prefill(cfg_t, tm.params["backbone"], _t(x), tc)
    _close(ours, ref, 1e-4)
    for step in range(steps):
        xs = rng.normal(size=(B, 1, 64)).astype(np.float32)
        ref, jc = jhybrid.hybrid_decode_step(cfg_j, jm.params["backbone"], jnp.asarray(xs), jc,
                                             jnp.int32(S + step))
        ours, tc = thybrid.hybrid_decode_step(cfg_t, tm.params["backbone"], _t(xs), tc, S + step)
        _close(ours, ref, 1e-4)
    key = KEYS[mode]
    for j, t in zip(jc, tc):
        if "conv" not in j:
            continue
        assert set(t) == set(j)
        _assert_stored_close(t[key], t["ssm_scale"], j[key], j["ssm_scale"], mode, 1e-4)
        np.testing.assert_allclose(thybrid.load_ssm(t).numpy(), np.asarray(jhybrid._load_ssm(j)),
                                   rtol=0, atol=float(np.asarray(j["ssm_scale"]).max()) * 1.00001)


def _close(ours: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("mode,ceiling", [("f8", 0.45), ("int8", 0.35), ("int4", 0.80)])
def test_quantized_state_drift_within_jax_ceilings(mode, ceiling):
    """tests/test_hybrid.py:243's protocol on the port: bf16 weights, batch
    2, 32 decode steps fed back, each mode's hidden states against the fp32
    state's; mean relative error under JAX's ceilings."""
    cfg = ZonosConfig.from_dict(_tiny_dict()).backbone
    gen = torch.Generator().manual_seed(0)
    params = thybrid.init_hybrid_params(cfg, gen, dtype=torch.bfloat16)
    x = torch.randn((2, 1, cfg.d_model), generator=gen).bfloat16()

    def run(state_mode: str) -> np.ndarray:
        cache = thybrid.create_hybrid_cache(cfg, 2, 64, torch.bfloat16, ssm_state=state_mode)
        outs, h = [], x
        for t in range(32):
            h_out, cache = thybrid.hybrid_decode_step(cfg, params, h, cache, t)
            outs.append(h_out.float().numpy())
            h = h_out.bfloat16()
        return np.concatenate(outs, axis=1)

    ref = run("fp32")
    got = run(mode)
    err = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-6)
    assert np.isfinite(got).all()
    assert err < ceiling, f"{mode} ssm state diverged: rel err {err:.3f}"
    assert err > 0  # the mode really stored something coarser than fp32
