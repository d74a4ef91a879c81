"""Transformer decoder backbone (GQA + RoPE + SwiGLU, pre-LN), the math of
zonos_tpu/models/backbone.py: pre-LayerNorm attention and MLP residual
blocks, fused QKV projection, interleaved rotary embeddings on q/k, grouped-
query attention against a KV cache, SwiGLU MLP, final LayerNorm.

Parameters keep the JAX package's layout: layers stacked on a leading axis,
matmul weights ``[in, out]`` applied as ``x @ w``, ``w1`` holding the up and
gate halves in that order.  A matmul weight may also be int8-quantized
(``{"q", "s"}``) or int4-quantized (``{"q4", "s4"}``), applied through
``ops.quant.matmul_w``.

The KV cache ``[L, B, H_kv, S, hd]`` is allocated once for the whole
generation and written in place.  A bf16 (or fp32) cache: prefill writes rows
[0, S), each decode step writes its row at ``pos`` and then attends with
``length = pos + 1``.  An f8 or int8 cache: each step attends over rows
[0, pos) with its own k/v held out in the compute dtype, then writes its row
(int8: quantized per row and kv head, with an fp32 scale).  A decode step's
``pos`` is a :class:`~zonos_tpu_torch.ops.attention.StepPosition` on the
device: the row write, the RoPE gather and the attention length read it
there, so the step never waits for the host (prefill keeps a host int).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail
from zonos_tpu_torch.kernels.layer_tail import kernel_takes as layer_tail_takes
from zonos_tpu_torch.ops.attention import (
    StepPosition,
    decode_attention,
    decode_attention_held_out,
    fresh_prefill_attention,
)
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.ops.norms import layer_norm
from zonos_tpu_torch.ops.quant import store_cast
from zonos_tpu_torch.ops.rope import apply_rope, cached_rope_table
from zonos_tpu_torch.ops.tp import (
    column_parallel,
    local_heads,
    model_size,
    row_parallel,
)

KV_STORAGE = {"f8": torch.float8_e4m3fn, "int8": torch.int8}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def quantize_kv_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., S, D] -> (int8 rows, fp32 per-row scales [..., S])."""
    rf = rows.float()
    scale = rf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(rf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


@dataclass
class KVCache:
    """Stacked per-layer caches: k/v ``[L, B, H_kv, S_max, head_dim]`` in the
    compute dtype, in float8 e4m3 (no scales) or in int8 with fp32 row scales
    ``k_scale``/``v_scale`` ``[L, B, H_kv, S_max]``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: BackboneConfig, batch: int, max_seqlen: int,
               dtype=torch.bfloat16, device="cpu", kv: str | None = None) -> "KVCache":
        """``kv``: None (the compute dtype), ``"f8"`` or ``"int8"``.  Under a
        model axis (``ops/tp.py``) a rank holds ``H_kv / model_size()`` heads."""
        shape = (cfg.n_layer, batch, cfg.num_heads_kv // model_size(), max_seqlen,
                 cfg.head_dim)
        if kv is not None and kv not in KV_STORAGE:
            raise ValueError(f"KV cache storage {kv!r}: want None|f8|int8")
        store = KV_STORAGE.get(kv, dtype)
        scales = ()
        if kv == "int8":
            scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                           for _ in range(2))
        return cls(torch.zeros(shape, dtype=store, device=device),
                   torch.zeros(shape, dtype=store, device=device), *scales)

    @property
    def held_out(self) -> bool:
        """f8 and int8 caches are attended with the current row held out."""
        return self.k.dtype in KV_STORAGE.values()

    def write(self, li: int, pos: int | StepPosition, k: torch.Tensor, v: torch.Tensor) -> None:
        """Store rows ``k, v [B, S, H_kv, hd]`` at [pos, pos + S) of layer ``li``:
        cast (f8 clipped to ±448 first, where JAX's cast gives NaN past ~464),
        or quantized per row for int8.  A :class:`StepPosition` (one row) is
        written by an indexed copy at its row on the device."""
        for rows, store, scales in ((k, self.k, self.k_scale), (v, self.v, self.v_scale)):
            rows = rows.transpose(1, 2)
            if store.dtype == torch.int8:
                rows, row_scales = quantize_kv_rows(rows)
                write_rows(scales[li], pos, row_scales)
            write_rows(store[li], pos, rows)


def write_rows(store: torch.Tensor, pos: int | StepPosition, rows: torch.Tensor) -> None:
    """``store[:, :, pos:pos + S] = rows`` in the store's dtype (``store_cast``:
    f8 clipped first) for ``store`` ``[B, H_kv, S_max, ...]`` and ``rows``
    ``[B, H_kv, S, ...]``; at a :class:`StepPosition` one row by
    ``index_copy_`` at the device's row, bit for bit the same store (an f8
    store's bytes are copied as uint8, which ``index_copy_`` takes)."""
    if not isinstance(pos, StepPosition):
        store_cast(store[:, :, pos:pos + rows.shape[2]], rows)
        return
    cast = rows
    if rows.dtype != store.dtype:
        cast = torch.empty(rows.shape, dtype=store.dtype, device=rows.device)
        store_cast(cast, rows)
    if store.dtype == torch.float8_e4m3fn:
        store, cast = store.view(torch.uint8), cast.view(torch.uint8)
    store.index_copy_(2, pos.row, cast)


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


def _layer_params(params: dict, li: int) -> dict:
    """Layer ``li`` of the stacked parameters (a quantized weight's parts too)."""
    return {name: ({k: t[li] for k, t in w.items()} if isinstance(w, dict) else w[li])
            for name, w in params["layers"].items()}


def _fused_tail_args(lp: dict, y: torch.Tensor, x: torch.Tensor, prefill: bool) -> tuple | None:
    """K4's operands on a CUDA int8 decode step whose dtypes and shapes it
    takes (``kernel_takes``; zonos_tpu/models/backbone.py:235-250 dispatches
    by shape too, behind a TPU opt-in), else None: the unfused tail, as JAX
    runs it off the TPU, on the CPU and for an fp32 model.  None on a model
    axis of more than one rank too: K4's LayerNorm needs the row after
    ``wo``'s all-reduce."""
    if prefill or not x.is_cuda or x.shape[1] != 1 or model_size() > 1 or not all(
            isinstance(lp[n], dict) and "q" in lp[n] for n in ("wo", "w1", "w2")):
        return None
    args = (y.reshape(x.shape[0], -1), x[:, 0].contiguous(), lp["wo"]["q"], lp["wo"]["s"],
            lp["norm2_scale"], lp["norm2_bias"], lp["w1"]["q"], lp["w1"]["s"],
            lp["w2"]["q"], lp["w2"]["s"])
    return args if layer_tail_takes(*args) else None


def _layer(cfg: BackboneConfig, lp: dict, li: int, x: torch.Tensor, cos, sin,
           cache: KVCache | None, pos: int | StepPosition, prefill: bool) -> torch.Tensor:
    """Layer ``li`` with its parameters ``lp``; a prefill without a cache
    (``transformer_forward``) writes no rows.  On a model axis ``lp`` is this
    rank's shard: its heads are counted from the width of its ``wqkv``, and
    ``wo`` and ``w2`` are summed over the axis (``ops/tp.py``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, Hkv = local_heads(cfg.num_heads, cfg.num_heads_kv, hd, lp["wqkv"])
    # each pre-norm feeds one product: norm_matmul folds it into that product's kernel
    norm1 = Norm(lp["norm1_scale"], lp["norm1_bias"], cfg.norm_epsilon, rms=False)
    q, k, v = torch.split(column_parallel(x, norm1, lp["wqkv"]), [H * hd, Hkv * hd, Hkv * hd],
                          dim=-1)
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, Hkv, hd), cos, sin)
    v = v.reshape(B, S, Hkv, hd)
    if prefill:
        y = fresh_prefill_attention(q, k, v)
        if cache is not None:
            cache.write(li, pos, k, v)
    elif cache.held_out:
        scales = (None, None) if cache.k_scale is None else (cache.k_scale[li], cache.v_scale[li])
        y = decode_attention_held_out(q, cache.k[li], cache.v[li], k, v, pos.pos, *scales,
                                      band=pos.band)
        cache.write(li, pos, k, v)  # after attention: the row was attended in the compute dtype
    else:
        cache.write(li, pos, k, v)
        y = decode_attention(q, cache.k[li], cache.v[li], pos.length, pos.band)
    tail = _fused_tail_args(lp, y, x, prefill)
    if tail is not None:
        return fused_layer_tail(*tail, eps=cfg.norm_epsilon)[:, None]
    x = x + row_parallel(y.reshape(B, S, H * hd), lp["wo"])
    norm2 = Norm(lp["norm2_scale"], lp["norm2_bias"], cfg.norm_epsilon, rms=False)
    u, gate = torch.chunk(column_parallel(x, norm2, lp["w1"]), 2, dim=-1)
    return x + row_parallel(u * F.silu(gate), lp["w2"])


def rope_at(cos_t: torch.Tensor, sin_t: torch.Tensor, pos: int | StepPosition,
            S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The table rows [pos, pos + S): a slice at a host int, a gather at a
    :class:`StepPosition`'s row (S = 1)."""
    if isinstance(pos, StepPosition):
        return cos_t.index_select(0, pos.row), sin_t.index_select(0, pos.row)
    return cos_t[pos:pos + S], sin_t[pos:pos + S]


def _run_layers(cfg: BackboneConfig, params: dict, x: torch.Tensor, cache: KVCache,
                pos: int | StepPosition, prefill: bool) -> torch.Tensor:
    cos_t, sin_t = cached_rope_table(cfg.head_dim, cfg.rope_base, x.device)
    cos, sin = rope_at(cos_t, sin_t, pos, x.shape[1])
    for li in range(cfg.n_layer):
        x = _layer(cfg, _layer_params(params, li), li, x, cos, sin, cache, pos, prefill)
    return layer_norm(x, params["normf_scale"], params["normf_bias"], cfg.norm_epsilon)


def transformer_forward(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                        remat: bool = False) -> torch.Tensor:
    """The cache-free full-sequence forward of ``x [B, S, d]`` from position 0
    (training and scoring; zonos_tpu/models/backbone.py:359-391): the
    prefill's layers, writing no cache.  ``remat`` recomputes each layer in
    the backward pass (``torch.utils.checkpoint``, non-reentrant) instead of
    keeping its activations.  Each stacked leaf is unbound once, so its
    gradient is stacked once rather than summed layer by layer."""
    cos_t, sin_t = cached_rope_table(cfg.head_dim, cfg.rope_base, x.device)
    cos, sin = rope_at(cos_t, sin_t, 0, x.shape[1])
    layers = {name: ({k: t.unbind(0) for k, t in w.items()} if isinstance(w, dict) else w.unbind(0))
              for name, w in params["layers"].items()}
    for li in range(cfg.n_layer):
        lp = {name: ({k: t[li] for k, t in w.items()} if isinstance(w, dict) else w[li])
              for name, w in layers.items()}
        args = (cfg, lp, li, x, cos, sin, None, 0, True)
        x = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
    return layer_norm(x, params["normf_scale"], params["normf_bias"], cfg.norm_epsilon)


def transformer_prefill(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                        cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt ``x [B, S, d]`` from position 0, filling cache rows
    [0, S).  Returns the final-norm hidden states ``[B, S, d]`` and the cache."""
    return _run_layers(cfg, params, x, cache, 0, prefill=True), cache


def transformer_decode_step(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                            cache: KVCache, pos: int | StepPosition
                            ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: ``x [B, 1, d]`` at position ``pos``, a
    :class:`StepPosition` on the device (or a host int, for a caller outside
    the decode loop)."""
    if not isinstance(pos, StepPosition):
        pos = StepPosition.at(pos, x.device)
    return _run_layers(cfg, params, x, cache, pos, prefill=False), cache
