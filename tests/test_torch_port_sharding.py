"""The port's sharding rules (``zonos_tpu_torch/parallel/sharding.py``), in
one process: the spec tree against the JAX package's ``zonos_param_specs``
leaf for leaf, the section-wise cut and its inverse, the KV cache's and the
batch's shares, and every kernel's ``kernel_takes`` (and plan) at the local
shapes a model axis of 2 and 4 gives the flagship transformer.  The
multi-process runs are ``tests/test_torch_port_parallel.py``."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from zonos_tpu.config import HYBRID_CONFIG_DICT as J_HYBRID
from zonos_tpu.config import TRANSFORMER_CONFIG_DICT as J_TRANSFORMER
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.parallel.sharding import zonos_param_specs as jax_specs
from zonos_tpu_torch import ZonosConfig
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.kernels import decode_attention as k12
from zonos_tpu_torch.kernels import gemm as g1
from zonos_tpu_torch.kernels import int4_matmul as k8
from zonos_tpu_torch.kernels import row_norm as n1
from zonos_tpu_torch.kernels import sampling as k3
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.parallel import sharding
from zonos_tpu_torch.parallel.sharding import Shard, join_parts, local_part

SMS = 132  # an H100 SXM

TINY = {
    "transformer": (J_TRANSFORMER, {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                                    "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}),
    "hybrid": (J_HYBRID, {"d_model": 64, "n_layer": 3, "attn_layer_idx": [1],
                          "attn_mlp_d_intermediate": 128, "d_intermediate": 128,
                          "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2,
                                      "headdim": 16},
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                                       "rotary_emb_dim": 8}}),
}
MODES = ("bf16", "int8", "int4")


def _dict(kind: str) -> dict:
    base, backbone = TINY[kind]
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(backbone))
    return d


@pytest.fixture(scope="module")
def trees():
    """(kind, mode) -> (JAX params, port params after convert.py, port config)."""
    out = {}
    for kind in TINY:
        for mode in MODES:
            jm = JaxZonos(JaxZonosConfig.from_dict(_dict(kind)), seed=0)
            if mode == "int8":
                jm.quantize_int8()
            elif mode == "int4":
                jm.quantize_int4(group_size=32)
            out[kind, mode] = (jm.params, convert_zonos_params(jax.tree.map(np.asarray, jm.params)),
                               ZonosConfig.from_dict(_dict(kind)))
    return out


def _jax_axes(spec):
    if isinstance(spec, P):
        return spec.index("model") if "model" in spec else None
    if isinstance(spec, dict):
        return {k: _jax_axes(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [_jax_axes(v) for v in spec]
    raise TypeError(type(spec))


def _port_axes(spec):
    if isinstance(spec, dict):
        return {k: _port_axes(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_port_axes(v) for v in spec]
    return None if spec is None else spec.axis


def _leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k], path + (k,))
    elif isinstance(tree, list):
        for i, (v, s) in enumerate(zip(tree, specs)):
            yield from _leaves(v, s, path + (i,))
    else:
        yield path, tree, specs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", tuple(TINY))
def test_spec_tree_matches_jax(trees, kind, mode):
    """The sharded axis of every leaf is JAX's: column-parallel wqkv/w1 (an
    int8 scale with them), row-parallel wo/w2 (an int8 scale and an int4
    weight replicated), vocab-parallel heads, replicated Mamba2 mixers,
    embeddings, norms and conditioner."""
    jparams, tparams, cfg = trees[kind, mode]
    ours = sharding.zonos_param_specs(tparams, cfg)
    assert _port_axes(ours) == _jax_axes(jax_specs(jparams))
    sharded = [p for p, _, s in _leaves(tparams, ours) if s is not None]
    assert len(sharded) >= 5  # the comparison is not of an all-replicated tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", tuple(TINY))
def test_parts_join_back_bit_for_bit(trees, kind, mode, tp):
    """Each sharded leaf cut into tp parts section by section, then joined,
    is the leaf bit for bit; every part has 1/tp of the axis."""
    _, tparams, cfg = trees[kind, mode]
    specs = sharding.zonos_param_specs(tparams, cfg)
    cut = 0
    for path, t, spec in _leaves(tparams, specs):
        if spec is None:
            continue
        parts = [local_part(t, spec, r, tp) for r in range(tp)]
        assert all(p.shape[spec.axis] * tp == t.shape[spec.axis] for p in parts), path
        whole = join_parts(parts, spec)
        assert whole.dtype == t.dtype and torch.equal(whole, t), path
        cut += 1
    assert cut >= 5


def test_wqkv_and_w1_are_cut_section_by_section():
    """Rank r keeps q heads [r H/tp, (r+1) H/tp) and the matching k and v
    heads of ``[q | k | v]``, and its part of each half of ``[up | gate]``."""
    H, Hkv, hd, tp = 4, 2, 16, 2
    cols = torch.arange((H + 2 * Hkv) * hd)[None, :].repeat(3, 1)
    spec = Shard(1, (H, Hkv, Hkv))
    q, k, v = H * hd, Hkv * hd, Hkv * hd
    for r in range(tp):
        got = local_part(cols, spec, r, tp)[0].tolist()
        want = (list(range(r * q // tp, (r + 1) * q // tp))
                + list(range(q + r * k // tp, q + (r + 1) * k // tp))
                + list(range(q + k + r * v // tp, q + k + (r + 1) * v // tp)))
        assert got == want
    w1 = torch.arange(8)[None, :]
    assert local_part(w1, Shard(1, (1, 1)), 1, 2)[0].tolist() == [2, 3, 6, 7]


class _Mesh:
    """A stand-in with the two calls the sharding rules make of a mesh."""

    def __init__(self, n_data: int, n_model: int, data: int = 0, model: int = 0):
        self.shape, self.coords = (n_data, n_model), {"data": data, "model": model}

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


def test_shard_params_raises_on_heads_the_axis_does_not_divide(trees):
    _, tparams, cfg = trees["transformer", "bf16"]
    with pytest.raises(ValueError, match="num_heads_kv 2"):
        sharding.shard_params(_Mesh(1, 4), tparams, cfg)
    shard = sharding.shard_params(_Mesh(1, 2, model=1), tparams, cfg)
    assert shard["backbone"]["layers"]["wqkv"].shape[-1] == 64  # (4 + 2 * 2) * 16 / 2
    assert shard["backbone"]["layers"]["wo"].shape[-2] == 32
    assert shard["embeddings"] is tparams["embeddings"]


def test_cache_and_batch_shares():
    cfg = ZonosConfig.from_dict(copy.deepcopy(TRANSFORMER_CONFIG_DICT))
    shape, rows = sharding.kv_cache_sharding(_Mesh(2, 2, data=1, model=1), cfg, 8, 1024)
    assert shape == (26, 4, 2, 1024, 128) and rows == slice(4, 8)
    assert sharding.batch_sharding(_Mesh(4, 1, data=3), 8) == slice(6, 8)
    with pytest.raises(ValueError, match="batch 6"):
        sharding.batch_sharding(_Mesh(4, 1), 6)


# ---------------------------------------------------------------------------
# The kernels at the local shapes of the flagship transformer
# ---------------------------------------------------------------------------

D, H, HKV, HD, INTER, HEADS = 2048, 16, 4, 128, 8192, 9 * 1152


def _products(tp: int) -> dict[str, tuple[int, int]]:
    """Each product's local (K, N) on a model axis of ``tp``."""
    return {"wqkv": (D, (H + 2 * HKV) * HD // tp), "wo": (H * HD // tp, D),
            "w1": (D, 2 * INTER // tp), "w2": (INTER // tp, D), "heads": (D, HEADS // tp)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rows", [1, 2, 16, 64, 142])
def test_gemm_takes_the_local_products(tp, rows):
    """G1 (bf16 and int8) takes every product at its local shape where it
    takes the whole one, with a plan; the folds of wqkv and w1 likewise."""
    bf16, i8 = torch.bfloat16, torch.int8
    norm = Norm(torch.ones(D, dtype=bf16), torch.zeros(D, dtype=bf16), 1e-5, rms=False)
    for name, (K, N) in _products(tp).items():
        whole = _products(1)[name]
        for dtypes in ((bf16, bf16, None), (bf16, i8, bf16)):
            assert g1.kernel_takes(rows, *whole, *dtypes)
            assert g1.kernel_takes(rows, K, N, *dtypes), (name, K, N)
        plan = g1.gemm_plan(rows, K, N, SMS)
        assert plan.bm > 0
        if name in ("wqkv", "w1"):
            assert g1.fold_takes(rows, K, N, bf16, bf16, None, norm) == \
                g1.fold_takes(rows, *whole, bf16, bf16, None, norm)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rows", [1, 2, 16, 64])
def test_int4_takes_the_local_products(tp, rows):
    """K8 takes the column-parallel products (wqkv, w1, heads) at their
    local widths; wo and w2 stay whole (replicated int4) and are taken as
    they are."""
    bf16 = torch.bfloat16
    norm = Norm(torch.ones(D, dtype=bf16), torch.zeros(D, dtype=bf16), 1e-5, rms=False)
    local = _products(tp)
    for name in ("wqkv", "w1", "heads", "wo", "w2"):
        K, N = local[name] if name in ("wqkv", "w1", "heads") else _products(1)[name]
        assert k8.kernel_takes(rows, *_products(1)[name], 128)
        assert k8.kernel_takes(rows, K, N, 128), (name, K, N)
        k8.int4_plan(rows, K, N, SMS)
        if name in ("wqkv", "w1"):
            assert k8.fold_takes(rows, K, N, 128, bf16, torch.int8, bf16, norm) == \
                k8.fold_takes(rows, *_products(1)[name], 128, bf16, torch.int8, bf16, norm)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B", [1, 2, 64])
def test_attention_takes_the_local_heads(tp, B):
    """K1/K2 take a rank's H/tp query heads over H_kv/tp kv heads (group
    4), over bf16, f8 and int8 caches, with a plan at every band; K3 and N1
    take the whole rows they always see."""
    S, rows = 1024, 2 * B
    q = _meta(rows, 1, H // tp, HD)
    cache = _meta(rows, HKV // tp, S, HD)
    assert k12.kernel_takes(_meta(rows, 1, H, HD), _meta(rows, HKV, S, HD), _meta(rows, HKV, S, HD))
    assert k12.kernel_takes(q, cache, cache)
    new = _meta(rows, 1, HKV // tp, HD)
    f8 = _meta(rows, HKV // tp, S, HD, dtype=torch.float8_e4m3fn)
    assert k12.kernel_takes(q, f8, f8, new, new)
    i8 = _meta(rows, HKV // tp, S, HD, dtype=torch.int8)
    scale = _meta(rows, HKV // tp, S, dtype=torch.float32)
    assert k12.kernel_takes(q, i8, i8, new, new, scale, scale)
    for lo, hi in k12.BANDS:
        band = k12.Band(lo, hi)
        for held_out in (False, True):
            k12.band_plan(band.kernel, band, rows * HKV // tp, S, held_out, SMS)
    logits = _meta(B, 9, 1152, dtype=torch.float32)
    assert k3.kernel_takes(logits, logits)
    assert n1.kernel_takes(_meta(rows, 1, D), _meta(D), _meta(D))
