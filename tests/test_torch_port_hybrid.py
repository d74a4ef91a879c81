"""The port's Mamba2-hybrid slice against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both sides.  Covered: the
hybrid's ops (RMSNorm with and without the final norm's bias, NeoX rotary
over a partial rotary dim, the causal depthwise conv), the plain versions of
K6 (chunked SSD) and K7 (decode-state step) against the XLA functions and the
Pallas kernels run with ``interpret=True``, the SSM-state storage modes, the
backbone on the tiny hybrid of ``tests/test_fake_checkpoint_parity.py``, and
greedy ``generate`` with codes identical to JAX's.

Tolerances: elementwise fp32 ops 1e-6 x max|ref| (same arithmetic, other
libm); bf16 outputs one bf16 ulp of max|ref|; the SSD scan and the backbone
1e-4 x max|ref| (other summation orders, the JAX kernel test's tolerance);
the decode-state output y 1e-5 x max|ref|; stored states equal up to one
ulp of the storage dtype; codes exactly.
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
from zonos_tpu.models import hybrid as jhybrid
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops import norms as jnorms
from zonos_tpu.ops import rope as jrope
from zonos_tpu.ops import ssm as jssm
from zonos_tpu.ops.pallas_ssm import ssd_chunked_pallas
from zonos_tpu.ops.pallas_state import fused_state_step as jax_fused_state_step
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels.ssd import ssd_chunked_plain
from zonos_tpu_torch.kernels.ssm_state import (
    fused_state_step,
    fused_state_step_plain,
    storage_ulp,
)
from zonos_tpu_torch.models import hybrid as thybrid
from zonos_tpu_torch.ops import norms as tnorms
from zonos_tpu_torch.ops import rope as trope
from zonos_tpu_torch.ops import ssm as tssm
from zonos_tpu_torch.ops.sampling import SamplingParams

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["Hello world.", "Good morning, how are you?"]
MAX_NEW = 12
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


def _close(ours: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_rms_norm_matches_jax(dtype, with_bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32) if with_bias else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jnorms.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale), 1e-5,
                          bias=None if bias is None else jnp.asarray(bias))
    ours = tnorms.rms_norm(_t(x).to(getattr(torch, dtype)), _t(scale), 1e-5,
                           bias=None if bias is None else _t(bias))
    assert ours.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    top = np.abs(ref).max()
    tol = 1e-6 * top if dtype == "float32" else float(storage_ulp(_t(top).bfloat16()))
    assert np.abs(ours.float().numpy() - ref).max() <= tol


def test_apply_rope_neox_partial_matches_jax():
    """The hybrid rotates the first ``rot`` dims in halves at each position and
    passes the rest through."""
    rng = np.random.default_rng(2)
    hd, rot, S = 16, 8, 7
    q = rng.normal(size=(2, S, 4, hd)).astype(np.float32)
    pos = 5
    jc, js = jrope.rope_table(rot)
    ref = jnp.concatenate([jrope.apply_rope_neox(q[..., :rot], jc[pos:pos + S], js[pos:pos + S]),
                           q[..., rot:]], axis=-1)
    tc, ts = trope.rope_table(rot)
    ours = torch.cat([trope.apply_rope_neox(_t(q)[..., :rot], tc[pos:pos + S], ts[pos:pos + S]),
                      _t(q)[..., rot:]], dim=-1)
    _close(ours, ref, 1e-6)
    # not the interleaved layout
    assert not np.allclose(np.asarray(ref), np.asarray(jnp.concatenate(
        [jrope.apply_rope(q[..., :rot], jc[pos:pos + S], js[pos:pos + S]), q[..., rot:]], -1)))


@pytest.mark.parametrize("L", [1, 9])
def test_causal_conv1d_matches_jax(L):
    rng = np.random.default_rng(L)
    K, C = 4, 24
    x = rng.normal(size=(2, L, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    ref_y, ref_state = jssm.causal_conv1d_prefill(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    y, state = tssm.causal_conv1d_prefill(_t(x), _t(w), _t(b))
    _close(y, ref_y, 1e-6)
    np.testing.assert_array_equal(state.numpy(), np.asarray(ref_state))  # the padded input's tail
    xn = rng.normal(size=(2, C)).astype(np.float32)
    ref_y1, ref_s1 = jssm.causal_conv1d_step(jnp.asarray(xn), ref_state, jnp.asarray(w),
                                             jnp.asarray(b))
    y1, s1 = tssm.causal_conv1d_step(_t(xn), state, _t(w), _t(b))
    _close(y1, ref_y1, 1e-6)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(ref_s1))


# ---------------------------------------------------------------------------
# K6 / K7 plain versions
# ---------------------------------------------------------------------------


def _ssd_case(rng, B, L, H, P, N, with_init):
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, H))) * 0.5).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, L, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, 1, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    init = rng.normal(size=(B, H, P, N)).astype(np.float32) if with_init else None
    return x, dt, A, Bm, Cm, D, init


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("L", [64, 150, 37])  # aligned, padded, sub-chunk
def test_ssd_chunked_plain_matches_jax_and_pallas(L, with_init):
    rng = np.random.default_rng(L + with_init)
    args = _ssd_case(rng, 2, L, 4, 64, 128, with_init)
    y, s = ssd_chunked_plain(*[None if a is None else _t(a) for a in args])
    refs = {"xla": jssm.ssd_chunked(*args[:6], init_state=args[6]),
            "pallas": ssd_chunked_pallas(*args[:6], init_state=args[6], interpret=True)}
    for name, (ref_y, ref_s) in refs.items():
        _close(y, ref_y, 1e-4)
        _close(s, ref_s, 1e-4)
    before = dict(launch_counts)
    y2, s2 = tssm.ssd_chunked(*[None if a is None else _t(a) for a in args])
    assert torch.equal(y2, y) and torch.equal(s2, s)
    assert launch_counts == before  # CPU tensors never reach the kernel


def test_ssd_chunked_plain_takes_ngroups():
    """Two groups of two heads each: the plain version against the XLA
    function (the Pallas kernel takes one group only; K6 takes any)."""
    rng = np.random.default_rng(4)
    B, L, H, P, N, G = 1, 70, 4, 16, 16, 2
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, H))) * 0.5).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    ref_y, ref_s = jssm.ssd_chunked(x, dt, A, Bm, Cm, D)
    y, s = ssd_chunked_plain(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D))
    _close(y, ref_y, 1e-4)
    _close(s, ref_s, 1e-4)


def test_ssd_decode_step_matches_jax():
    """The port's decode step (K7's plain version for C.s and the state) against
    JAX's, continuing the same state for three steps."""
    rng = np.random.default_rng(7)
    B, H, P, N, G = 2, 4, 16, 32, 1
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    ref_state, state = jnp.asarray(s0), _t(s0)
    for _ in range(3):
        x = rng.normal(size=(B, H, P)).astype(np.float32)
        dt = np.abs(rng.normal(size=(B, H))).astype(np.float32)
        Bm = rng.normal(size=(B, G, N)).astype(np.float32)
        Cm = rng.normal(size=(B, G, N)).astype(np.float32)
        ref_y, ref_state = jssm.ssd_decode_step(x, dt, A, Bm, Cm, D, ref_state)
        y, out = tssm.ssd_decode_step(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D), state)
        assert out is state  # updated in place
        _close(y, ref_y, 1e-5)
        _close(state, ref_state, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_fused_state_step_plain_matches_pallas(dtype):
    rng = np.random.default_rng(11)
    BH, P, N = 12, 8, 16
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    state = jnp.asarray(rng.normal(size=(BH, P, N)) * 4, jnp.float32).astype(jdt)
    Ch = rng.normal(size=(BH, N)).astype(np.float32)
    Bh = rng.normal(size=(BH, N)).astype(np.float32)
    dA = rng.uniform(0.5, 1.0, size=(BH, 1)).astype(np.float32)
    xdt = rng.normal(size=(BH, P)).astype(np.float32)
    xdt[0, 0] = 1e4  # row 0 of head 0 leaves the f8 range: it must store +-448, not NaN
    ref_y, ref_new = jax_fused_state_step(state, Ch, Bh, dA, xdt, interpret=True)
    ts = _t(np.asarray(state.astype(jnp.float32))).to(tdt)
    y, out = fused_state_step_plain(ts, _t(Ch), _t(Bh), _t(dA), _t(xdt))
    assert out is ts and ts.dtype == tdt
    _close(y, ref_y, 1e-5)
    got = ts.float().numpy()
    ref = np.asarray(ref_new.astype(jnp.float32))
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    # XLA may fuse a product into an FMA: allow one fp32 ulp of the larger
    # product, then one storage ulp where the two sums round apart
    s32 = np.asarray(state.astype(jnp.float32))
    products = np.maximum(np.abs(s32 * dA[:, :, None]), np.abs(xdt[:, :, None] * Bh[:, None, :]))
    tol = storage_ulp(_t(ref).to(tdt)) + storage_ulp(_t(products))
    assert (np.abs(got - ref) <= tol.numpy()).all()
    if dtype == "float8_e4m3fn":
        assert np.abs(got[0, 0]).max() == 448.0 and np.abs(ref[0, 0]).max() == 448.0
    before = dict(launch_counts)
    ts2 = _t(np.asarray(state.astype(jnp.float32))).to(tdt)
    y2, _ = fused_state_step(ts2, _t(Ch), _t(Bh), _t(dA), _t(xdt))
    assert torch.equal(y2, y) and torch.equal(ts2.float(), ts.float())
    assert launch_counts == before


def test_ssm_state_mode_default_and_storage():
    assert thybrid.ssm_state_mode(2) == "fp32"
    assert thybrid.ssm_state_mode(15) == "fp32"
    assert thybrid.ssm_state_mode(16) == "f8"  # batch 8 with CFG
    assert thybrid.ssm_state_mode(16, "bf16") == "bf16"
    with pytest.raises(ValueError):
        thybrid.ssm_state_mode(2, "f16")
    cfg = ZonosConfig.from_dict(_tiny_dict()).backbone
    # the int8 and int4 states, keyed as the JAX package keys them: int8 values or int4 pairs
    # packed in int8 bytes, and one fp32 scale a row and head
    H, P, N = 8, 16, 16
    for mode, key, width in (("int8", "ssm", N), ("int4", "ssm_q4", N // 2)):
        assert thybrid.ssm_state_mode(2, mode) == mode
        st = thybrid.create_hybrid_cache(cfg, 2, 64, torch.bfloat16, ssm_state=mode)[0]
        assert set(st) == {"conv", key, "ssm_scale"}
        assert st[key].shape == (2, H, P, width) and st[key].dtype == torch.int8
        assert st["ssm_scale"].shape == (2, H, 1, 1) and st["ssm_scale"].dtype == torch.float32
    for rows, dtype, want in ((2, torch.bfloat16, torch.float32),
                              (16, torch.bfloat16, torch.float8_e4m3fn),
                              (16, torch.float32, torch.float32)):
        cache = thybrid.create_hybrid_cache(cfg, rows, 64, dtype)
        assert cache[0]["ssm"].dtype == want and cache[0]["conv"].dtype == dtype
        assert cache[1]["k"].shape == (rows, 2, 64, 16) and cache[1]["k"].dtype == dtype
    jax_cache = jhybrid.create_hybrid_cache(ZonosConfig.from_dict(_tiny_dict()).backbone, 16, 64)
    assert jax_cache[0]["ssm"].dtype == jnp.float8_e4m3fn  # the same default on the JAX side


# ---------------------------------------------------------------------------
# backbone and generate on the tiny hybrid
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict()),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    assert tm.compute_dtype == torch.float32
    return jm, tm


def test_hybrid_prefill_and_decode_match_jax(models):
    jm, tm = models
    cfg_j, cfg_t = jm.config.backbone, tm.config.backbone
    rng = np.random.default_rng(3)
    B, S, steps = 2, 10, 4
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    jc = jhybrid.create_hybrid_cache(cfg_j, B, 32, dtype=jnp.float32)
    tc = thybrid.create_hybrid_cache(cfg_t, B, 32, torch.float32)
    ref, jc = jhybrid.hybrid_prefill(cfg_j, jm.params["backbone"], jnp.asarray(x), jc)
    ours, tc = thybrid.hybrid_prefill(cfg_t, tm.params["backbone"], _t(x), tc)
    _close(ours, ref, 1e-4)
    for step in range(steps):
        xs = rng.normal(size=(B, 1, 64)).astype(np.float32)
        ref, jc = jhybrid.hybrid_decode_step(cfg_j, jm.params["backbone"], jnp.asarray(xs), jc,
                                             jnp.int32(S + step))
        ours, tc = thybrid.hybrid_decode_step(cfg_t, tm.params["backbone"], _t(xs), tc, S + step)
        _close(ours, ref, 1e-4)
    for j, t in zip(jc, tc):  # every layer's state after the last step
        for key in j:
            _close(t[key], j[key], 1e-4)


@pytest.fixture(scope="module")
def prefixes(models):
    jm, tm = models
    spk = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
    jp = jm.prepare_conditioning(jax_make_cond_dict(text=TEXTS, speaker=spk))
    tp = tm.prepare_conditioning(make_cond_dict(text=TEXTS, speaker=spk))
    _close(tp, jp, 1e-5)
    return np.asarray(jp), tp


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
def test_greedy_generate_matches_jax(models, prefixes, cfg_scale):
    jm, tm = models
    jp, tp = prefixes
    ref = jm.generate(jnp.asarray(jp), max_new_tokens=MAX_NEW, cfg_scale=cfg_scale, batch_size=2,
                      sampling_params=JaxSamplingParams.greedy(), progress_bar=False)
    ours = tm.generate(tp, max_new_tokens=MAX_NEW, cfg_scale=cfg_scale, batch_size=2,
                       sampling_params=SamplingParams.greedy())
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_sampled_generate_is_per_row_deterministic(models, prefixes):
    _, tm = models
    _, tp = prefixes
    a = tm.generate(tp, max_new_tokens=MAX_NEW, batch_size=2, seed=[5, 6])
    b = tm.generate(tp, max_new_tokens=MAX_NEW, batch_size=2, seed=[5, 6])
    c = tm.generate(tp[[0, 2]], max_new_tokens=MAX_NEW, batch_size=1, seed=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape[0] == 9 and ((a[0] >= 0) & (a[0] < 1024)).all()
    np.testing.assert_array_equal(c[0][:, :3], a[0][:, :3])


def test_convert_keeps_ssm_parameters_fp32():
    """A bf16 conversion recasts the matmul weights but keeps A_log, D and
    dt_bias in fp32, as the JAX init does and the mixer adds them."""
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=1)
    params = convert_zonos_params(jax.tree.map(np.asarray, jm.params), dtype=torch.bfloat16)
    mamba = params["backbone"]["layers_list"][0]
    assert isinstance(params["backbone"]["layers_list"], list)
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name].dtype == torch.float32, name
    assert mamba["in_proj"].dtype == torch.bfloat16
    assert params["backbone"]["layers_list"][1]["wqkv"].dtype == torch.bfloat16


def test_init_params_keeps_ssm_parameters_fp32():
    d = _tiny_dict()
    d["backbone"].update({"d_model": 2048, "n_layer": 2, "attn_layer_idx": [1],
                          "ssm_cfg": {"layer": "Mamba2"},
                          "attn_cfg": {"num_heads": 16, "num_heads_kv": 4, "head_dim": 128}})
    m = Zonos(ZonosConfig.from_dict(d), device="cpu")  # flagship widths, depth cut to 2
    mamba, attn = m.params["backbone"]["layers_list"]
    assert mamba["in_proj"].shape == (2048, 2 * 4096 + 2 * 128 + 64)
    assert mamba["conv_w"].shape == (4, 4096 + 256)
    assert all(mamba[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    assert attn["wqkv"].shape == (2048, (16 + 8) * 128) and attn["wqkv"].dtype == torch.bfloat16


def test_flagship_hybrid_refuses_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Zonos(ZonosConfig.from_dict(HYBRID_CONFIG_DICT))


def test_hybrid_runs_without_jax_or_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["zonos_tpu"] = None
        import copy
        from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
        from zonos_tpu_torch.config import HYBRID_CONFIG_DICT
        d = copy.deepcopy(HYBRID_CONFIG_DICT)
        d["backbone"].update({TINY_HYBRID!r})
        m = Zonos(ZonosConfig.from_dict(d), device="cpu")
        codes = m.generate(m.prepare_conditioning(make_cond_dict(text="Hi there.")),
                           max_new_tokens=6, seed=1)
        assert not any(n == "jax" or n.startswith(("jax.", "zonos_tpu."))
                       for n, mod in sys.modules.items() if mod is not None)
        print("OK", codes[0].shape)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK (9, ")
