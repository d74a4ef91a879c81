"""Transformer decoder backbone (GQA + RoPE + SwiGLU, pre-LN), the math of
zonos_tpu/models/backbone.py: pre-LayerNorm attention and MLP residual
blocks, fused QKV projection, interleaved rotary embeddings on q/k, grouped-
query attention against a KV cache, SwiGLU MLP, final LayerNorm.

Parameters keep the JAX package's layout: layers stacked on a leading axis,
matmul weights ``[in, out]`` applied as ``x @ w``, ``w1`` holding the up and
gate halves in that order.

The KV cache ``[L, B, H_kv, S, hd]`` is allocated once for the whole
generation and written in place: prefill writes rows [0, S), each decode
step writes its row at ``pos`` and then attends with ``length = pos + 1``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.ops.attention import decode_attention, fresh_prefill_attention
from zonos_tpu_torch.ops.norms import layer_norm
from zonos_tpu_torch.ops.rope import apply_rope, cached_rope_table


@dataclass
class KVCache:
    """Stacked per-layer caches: k/v ``[L, B, H_kv, S_max, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: BackboneConfig, batch: int, max_seqlen: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.n_layer, batch, cfg.num_heads_kv, max_seqlen, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_transformer_params(cfg: BackboneConfig, generator: torch.Generator,
                            dtype=torch.bfloat16, device="cpu") -> dict:
    """Random-init parameters (N(0, 1/fan_in) matmuls, unit norms), layers
    stacked on axis 0.  ``generator`` lives on ``device``."""
    d, L = cfg.d_model, cfg.n_layer
    H, Hkv, hd = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    inter = cfg.mlp_hidden

    def dense(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w / shape[-2] ** 0.5).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "layers": {
            "norm1_scale": const((L, d), 1.0),
            "norm1_bias": const((L, d), 0.0),
            "wqkv": dense((L, d, (H + 2 * Hkv) * hd)),
            "wo": dense((L, H * hd, d)),
            "norm2_scale": const((L, d), 1.0),
            "norm2_bias": const((L, d), 0.0),
            "w1": dense((L, d, 2 * inter)),
            "w2": dense((L, inter, d)),
        },
        "normf_scale": const((d,), 1.0),
        "normf_bias": const((d,), 0.0),
    }


def _layer(cfg: BackboneConfig, params: dict, li: int, x: torch.Tensor, cos, sin,
           cache: KVCache, pos: int, prefill: bool) -> torch.Tensor:
    lp = {name: w[li] for name, w in params["layers"].items()}
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    h = layer_norm(x, lp["norm1_scale"], lp["norm1_bias"], cfg.norm_epsilon)
    q, k, v = torch.split(h @ lp["wqkv"], [H * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, Hkv, hd), cos, sin)
    v = v.reshape(B, S, Hkv, hd)
    # rows [pos, pos+S) of this layer's cache
    cache.k[li, :, :, pos:pos + S] = k.transpose(1, 2).to(cache.k.dtype)
    cache.v[li, :, :, pos:pos + S] = v.transpose(1, 2).to(cache.v.dtype)
    if prefill:
        y = fresh_prefill_attention(q, k, v)
    else:
        y = decode_attention(q, cache.k[li], cache.v[li], length=pos + 1)
    x = x + y.reshape(B, S, H * hd) @ lp["wo"]
    h = layer_norm(x, lp["norm2_scale"], lp["norm2_bias"], cfg.norm_epsilon)
    u, gate = torch.chunk(h @ lp["w1"], 2, dim=-1)
    return x + (u * F.silu(gate)) @ lp["w2"]


def _run_layers(cfg: BackboneConfig, params: dict, x: torch.Tensor, cache: KVCache,
                pos: int, prefill: bool) -> torch.Tensor:
    cos_t, sin_t = cached_rope_table(cfg.head_dim, cfg.rope_base, x.device)
    S = x.shape[1]
    cos, sin = cos_t[pos:pos + S], sin_t[pos:pos + S]
    for li in range(cfg.n_layer):
        x = _layer(cfg, params, li, x, cos, sin, cache, pos, prefill)
    return layer_norm(x, params["normf_scale"], params["normf_bias"], cfg.norm_epsilon)


def transformer_prefill(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                        cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt ``x [B, S, d]`` from position 0, filling cache rows
    [0, S).  Returns the final-norm hidden states ``[B, S, d]`` and the cache."""
    return _run_layers(cfg, params, x, cache, 0, prefill=True), cache


def transformer_decode_step(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                            cache: KVCache, pos: int) -> tuple[torch.Tensor, KVCache]:
    """One decode step: ``x [B, 1, d]`` at position ``pos`` (a host int)."""
    return _run_layers(cfg, params, x, cache, pos, prefill=False), cache
