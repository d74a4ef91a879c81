"""Backbone registry (counterpart of zonos_tpu/models/registry.py:13-65): the
seam through which ``Zonos`` initialises, caches, prefills and steps a
backbone without naming one.

- ``init(cfg, generator, dtype, device) -> params``
- ``make_cache(cfg, rows, max_seqlen, dtype, device, kv=None, ssm=None) -> cache``:
  ``kv`` is the transformer's KV-cache storage (None, "f8", "int8"), ``ssm``
  the hybrid's SSM-state storage; each backbone reads the one it has (the
  hybrid's attention layers keep their cache in the compute dtype, as in
  zonos_tpu/models/hybrid.py:209)
- ``prefill(cfg, params, x, cache) -> (hidden, cache)``
- ``decode_step(cfg, params, x, cache, pos) -> (hidden, cache)``
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from zonos_tpu_torch.config import BackboneConfig


@dataclass(frozen=True)
class BackboneOps:
    init: Callable
    make_cache: Callable
    prefill: Callable
    decode_step: Callable


def _transformer_ops() -> BackboneOps:
    from zonos_tpu_torch.models.backbone import (
        KVCache,
        init_transformer_params,
        transformer_decode_step,
        transformer_prefill,
    )

    def make_cache(cfg, rows, max_seqlen, dtype, device, kv=None, ssm=None):
        return KVCache.create(cfg, rows, max_seqlen, dtype, device, kv=kv)

    return BackboneOps(init=init_transformer_params, make_cache=make_cache,
                       prefill=transformer_prefill, decode_step=transformer_decode_step)


def _hybrid_ops() -> BackboneOps:
    from zonos_tpu_torch.models.hybrid import (
        create_hybrid_cache,
        hybrid_decode_step,
        hybrid_prefill,
        init_hybrid_params,
    )

    def make_cache(cfg, rows, max_seqlen, dtype, device, kv=None, ssm=None):
        return create_hybrid_cache(cfg, rows, max_seqlen, dtype, device, ssm_state=ssm)

    return BackboneOps(init=init_hybrid_params, make_cache=make_cache,
                       prefill=hybrid_prefill, decode_step=hybrid_decode_step)


BACKBONES: dict[str, Callable[[], BackboneOps]] = {
    "transformer": _transformer_ops,
    "hybrid": _hybrid_ops,
}


def backbone_ops(cfg: BackboneConfig) -> BackboneOps:
    """The ops of the architecture ``cfg`` describes (an empty ``ssm_cfg`` is
    the transformer, anything else the Mamba2 hybrid)."""
    return BACKBONES["transformer" if cfg.is_transformer else "hybrid"]()
