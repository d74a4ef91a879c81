"""LoRA adaptation: rank-r factors trained over a frozen base
(zonos_tpu/parallel/lora.py).

Adapters ``W + (alpha / r) A @ B`` on the backbone's projections only (never
the conditioner's ``w1`` / ``w2``), ``A`` Gaussian and ``B`` zero so the
merged model starts equal to the base.  The transformer's stacked
``[L, in, out]`` weights get stacked adapters (``[L, in, r]``, ``[L, r, out]``),
merged by one batched product a weight family.  The merge runs inside the
differentiated function: the merged bf16 weight goes through G1 on the card
and its gradient reaches ``a`` and ``b``; the frozen base gets none.

On a mesh the adapters are whole and replicated (made from the whole base);
a sharded base leaf adds this rank's part of ``a @ b``, and ``a`` and ``b``
pass copy-to-model first, so their gradient is summed over the model axis.
"""

from __future__ import annotations

import math

import torch

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.ops.tp import axis_group, axis_rank, axis_size, copy_to_model, model_axis
from zonos_tpu_torch.parallel.train import (
    Optimizer,
    _apply,
    _data_sum,
    _filled,
    conditioned_loss,
    rank_loss,
    tree_leaves,
    value_and_grad,
)

# the backbone leaves that get adapters (the last key): the transformer's
# stacked layers and the hybrid's per-layer Mamba2 and attention projections
DEFAULT_TARGETS = ("wqkv", "wo", "w1", "w2", "in_proj", "out_proj")


def init_lora(generator: torch.Generator, params: dict, rank: int = 8,
              targets: tuple[str, ...] = DEFAULT_TARGETS) -> dict:
    """An adapter tree mirroring ``params``: a target leaf of the backbone
    (two or more dimensions) becomes ``{"a": [..., in, r], "b": [..., r, out]}``
    fp32 on the leaf's device, every other leaf None.  ``a`` is drawn from
    ``generator`` (on its device) scaled by ``1 / sqrt(in)``, ``b`` is zero."""

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        if path[:1] == ("backbone",) and path[-1] in targets and t.dim() >= 2:
            *batch, fan_in, fan_out = t.shape
            a = torch.randn((*batch, fan_in, rank), generator=generator, dtype=torch.float32,
                            device=generator.device)
            return {"a": (a / math.sqrt(fan_in)).to(t.device),
                    "b": torch.zeros((*batch, rank, fan_out), dtype=torch.float32,
                                     device=t.device)}
        return None

    return walk(params, ())


def merge_lora(params: dict, adapters: dict, alpha: float = 16.0, specs=None,
               mesh=None) -> dict:
    """Base plus ``(alpha / r) a @ b`` on every adapted leaf, added in fp32
    and cast to the leaf's dtype; the other leaves pass through.  ``specs``
    (the base's spec tree) and ``mesh``: a sharded base leaf takes this
    rank's part of the product."""
    from zonos_tpu_torch.parallel.sharding import local_part

    tp, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def walk(p, ad, sp):
        if isinstance(p, dict):
            return {k: walk(v, ad[k], None if sp is None else sp[k]) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, a, None if sp is None else s)
                    for v, a, s in zip(p, ad, sp or [None] * len(p))]
        if ad is None:
            return p
        a, b = ad["a"], ad["b"]
        if sp is not None and tp > 1:
            a, b = copy_to_model(a), copy_to_model(b)
        delta = local_part((alpha / a.shape[-1]) * (a @ b), sp, rank, tp)
        return (p.float() + delta).to(p.dtype)

    return walk(params, adapters, specs)


def count_lora_params(adapters: dict) -> int:
    return sum(t.numel() for t in tree_leaves(adapters))


def make_lora_train_step(cfg: ZonosConfig, specs, optimizer: Optimizer, alpha: float = 16.0,
                         uncond_p: float = 0.1, remat: bool = False, mesh=None):
    """One LoRA step: ``(adapters, opt_state, base_params, cond_inputs, codes,
    generator) -> (adapters, opt_state, loss)``; the base is an argument and
    is never written.  With ``mesh``: every rank passes the whole batch, its
    shard of the base and the whole adapters (``parallel/train.py``)."""
    from zonos_tpu_torch.parallel.sharding import zonos_param_specs

    def loss_fn(adapters, base_params, cond_inputs, codes, generator):
        param_specs = None if mesh is None else zonos_param_specs(base_params, cfg)
        merged = merge_lora(base_params, adapters, alpha, param_specs, mesh)
        return rank_loss(cfg, specs, merged, cond_inputs, codes, generator, uncond_p, remat,
                         mesh)

    def train_step(adapters, opt_state, base_params, cond_inputs, codes, generator=None):
        with model_axis(axis_group(mesh, "model")):
            loss, grads = value_and_grad(loss_fn, adapters, base_params, cond_inputs, codes,
                                         generator)
            loss, grads = _data_sum(mesh, loss, _filled(grads, adapters))
            return _apply(optimizer, adapters, opt_state, grads) + (loss,)

    return train_step


def make_lora_eval_fn(cfg: ZonosConfig, specs, alpha: float = 16.0, remat: bool = False,
                      mesh=None):
    """``(adapters, base_params, cond_inputs, codes) -> scalar`` held-out loss,
    under ``no_grad``, without CFG dropout (with ``mesh``: every rank the
    whole batch over its shard of the base)."""
    from zonos_tpu_torch.parallel.sharding import zonos_param_specs

    @torch.no_grad()
    def eval_fn(adapters, base_params, cond_inputs, codes):
        param_specs = None if mesh is None else zonos_param_specs(base_params, cfg)
        with model_axis(axis_group(mesh, "model")):
            return conditioned_loss(cfg, specs, merge_lora(base_params, adapters, alpha,
                                                           param_specs, mesh),
                                    cond_inputs, codes, None, 0.0, remat)

    return eval_fn
