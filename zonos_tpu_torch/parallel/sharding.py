"""Sharding rules for the model's parameters (zonos_tpu/parallel/sharding.py).

The Megatron layout of the JAX package, leaf for leaf:

- attention: ``wqkv`` column-parallel over heads, ``wo`` row-parallel;
- MLP: ``w1`` column-parallel, ``w2`` row-parallel;
- heads: vocab-parallel (the last axis of the fused ``[d, K*V_pad]``);
- int8 ``{"q", "s"}``: the scale shards with the out-features and is
  replicated for a row-parallel weight; a row-parallel int4 weight is
  replicated (its packed halves and groups cannot be cut by rows);
- the Mamba mixers, the embeddings, the norms and the prefix conditioner
  are replicated;
- KV cache: batch on ``"data"``, kv heads on ``"model"``.

A spec is :class:`Shard` (the sharded axis and its sections) or None
(replicated).  A packed weight is cut section by section: ``wqkv`` is
``[q | k | v]`` and rank r keeps q heads ``[r H/tp, (r+1) H/tp)`` and the
matching k and v heads; ``w1`` is ``[up | gate]`` and rank r keeps its part
of each half.  A contiguous cut, which is what the GSPMD spec reads
literally, would put every q column on rank 0 (XLA reshards to repair that;
the port has no compiler to do it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.ops.tp import all_gather_last, axis_group, axis_rank, axis_size

_COL_PARALLEL = ("wqkv", "w1")
_ROW_PARALLEL = ("wo", "w2")


@dataclass(frozen=True)
class Shard:
    """A leaf cut along ``axis``: each of the sections (relative sizes
    ``parts`` along the axis) is cut into the model size's equal parts, and
    rank r keeps part r of every section."""

    axis: int
    parts: tuple[int, ...] = (1,)

    def sections(self, length: int) -> list[int]:
        total = sum(self.parts)
        if length % total:
            raise ValueError(f"axis of {length} does not split into sections {self.parts}")
        return [length * p // total for p in self.parts]


def replicated(mesh=None) -> None:
    """The spec of a replicated leaf."""
    return None


def _dense_spec(w, axis: int, parts: tuple[int, ...]):
    """Spec of one dense weight: plain ``[.., in, out]``, int8 ``{"q","s"}`` or
    int4 ``{"q4","s4"}``; ``axis`` -1 column-parallel, -2 row-parallel."""
    if isinstance(w, dict) and "q" in w:
        if axis == -1:
            return {"q": Shard(w["q"].dim() - 1, parts), "s": Shard(w["s"].dim() - 1, parts)}
        return {"q": Shard(w["q"].dim() - 2, parts), "s": None}
    if isinstance(w, dict) and "q4" in w:
        if axis == -1:
            return {"q4": Shard(w["q4"].dim() - 1, parts), "s4": Shard(w["s4"].dim() - 1, parts)}
        return {k: None for k in w}
    return Shard(w.dim() + axis, parts)


def _replicated_tree(t):
    if isinstance(t, dict):
        return {k: _replicated_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_replicated_tree(v) for v in t]
    return None


def _layer_specs(lp: dict, qkv_parts: tuple[int, ...]) -> dict:
    """A layer's specs; ``qkv_parts``: ``wqkv``'s sections (``w1``'s are its
    two equal halves)."""
    spec = {}
    for name, w in lp.items():
        if name in _COL_PARALLEL:
            spec[name] = _dense_spec(w, -1, qkv_parts if name == "wqkv" else (1, 1))
        elif name in _ROW_PARALLEL:
            spec[name] = _dense_spec(w, -2, (1,))
        else:
            spec[name] = _replicated_tree(w)
    return spec


def zonos_param_specs(params: dict, config: ZonosConfig) -> dict:
    """The spec tree of a ``Zonos`` parameter tree (plain or quantized
    weights, transformer or hybrid backbone, whole or one rank's shard)."""
    bb = config.backbone
    qkv_parts = (bb.num_heads, bb.num_heads_kv, bb.num_heads_kv)
    specs: dict = {}
    for k, v in params.items():
        if k == "backbone":
            specs[k] = {name: ([_layer_specs(lp, qkv_parts) for lp in t] if name == "layers_list"
                               else _layer_specs(t, qkv_parts) if name == "layers"
                               else _replicated_tree(t)) for name, t in v.items()}
        elif k == "heads":
            specs[k] = _dense_spec(v, -1, (1,))
        else:
            specs[k] = _replicated_tree(v)
    return specs


def param_shardings(mesh, params: dict, config: ZonosConfig) -> dict:
    """The spec of every leaf on ``mesh``: :func:`zonos_param_specs`, and None
    everywhere where the model axis has one rank."""
    specs = zonos_param_specs(params, config)
    return specs if axis_size(mesh, "model") > 1 else _replicated_tree(specs)


def _check(config: ZonosConfig, tp: int) -> None:
    bb = config.backbone
    for name, n in (("num_heads", bb.num_heads), ("num_heads_kv", bb.num_heads_kv)):
        if n % tp:
            raise ValueError(f"{name} {n} does not split over a model axis of {tp}")


def local_part(t: torch.Tensor, spec: Shard | None, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s part of the whole leaf ``t`` (of ``n``), section by
    section; the whole leaf where it is replicated or ``n`` is 1."""
    if spec is None or n == 1:
        return t
    pieces, start = [], 0
    for size in spec.sections(t.shape[spec.axis]):
        if size % n:
            raise ValueError(f"a section of {size} does not split over a model axis of {n}")
        step = size // n
        pieces.append(t.narrow(spec.axis, start + rank * step, step))
        start += size
    return torch.cat(pieces, dim=spec.axis) if len(pieces) > 1 else pieces[0].contiguous()


def join_parts(parts: list[torch.Tensor], spec: Shard | None) -> torch.Tensor:
    """The whole leaf from the ranks' parts in rank order: the inverse of
    :func:`local_part`, section by section."""
    if spec is None:
        return parts[0]
    n, local = len(parts), parts[0].shape[spec.axis]
    pieces, start = [], 0
    for size in spec.sections(local * n):
        pieces += [p.narrow(spec.axis, start // n, size // n) for p in parts]
        start += size
    return torch.cat(pieces, dim=spec.axis)


def gather_part(t: torch.Tensor, spec: Shard | None, group) -> torch.Tensor:
    """The whole leaf from every rank's part (a collective over ``group``);
    ``t`` itself where it is replicated, not a tensor, or there is no group."""
    if spec is None or group is None or not isinstance(t, torch.Tensor):
        return t
    n = dist.get_world_size(group)
    whole = all_gather_last(t.movedim(spec.axis, -1), group)  # [..., n * local], rank by rank
    parts = [p.movedim(-1, spec.axis) for p in whole.chunk(n, dim=-1)]
    return join_parts(parts, spec).contiguous()


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(mesh, params: dict, config: ZonosConfig) -> dict:
    """This rank's shard of a whole parameter tree: each sharded leaf's part
    on the model axis, section by section (:func:`local_part`), as a tensor
    of its own, so the whole leaf can be freed; replicated leaves as they
    are.  Raises on a head count the model axis does not divide."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if n == 1:
        return params
    _check(config, n)
    return map_specs(lambda t, s: t if s is None else local_part(t, s, r, n).clone(),
                     params, zonos_param_specs(params, config))


def unshard_params(mesh, params: dict, config: ZonosConfig) -> dict:
    """The whole parameter tree from every rank's shard (a collective over
    the model axis: every rank of it calls this)."""
    group = axis_group(mesh, "model")
    if group is None:
        return params
    return map_specs(lambda t, s: gather_part(t, s, group), params,
                     zonos_param_specs(params, config))


def batch_sharding(mesh, batch: int) -> slice:
    """This data rank's rows of a batch of ``batch`` rows."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    if batch % n:
        raise ValueError(f"batch {batch} does not split over a data axis of {n}")
    rows = batch // n
    return slice(r * rows, (r + 1) * rows)


def kv_cache_sharding(mesh, config: ZonosConfig, batch: int, max_seqlen: int
                      ) -> tuple[tuple[int, ...], slice]:
    """This rank's KV cache shape ``[L, B/n_data, H_kv/n_model, S, hd]`` and
    its rows of the batch (JAX: ``P(None, "data", "model", None, None)``)."""
    bb = config.backbone
    tp = axis_size(mesh, "model")
    _check(config, tp)
    rows = batch_sharding(mesh, batch)
    return (bb.n_layer, rows.stop - rows.start, bb.num_heads_kv // tp, max_seqlen,
            bb.head_dim), rows
