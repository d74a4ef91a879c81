"""Mamba2-hybrid backbone (counterpart of zonos_tpu/models/hybrid.py:38-365):
pre-norm residual blocks where layer ``i`` has a GQA attention mixer if
``i in attn_layer_idx`` and a Mamba2 (SSD) mixer otherwise, an optional
SwiGLU MLP after either, RMSNorm, and under ``residual_in_fp32`` a residual
stream kept in fp32 while every matmul runs in the compute dtype.

Parameters keep the JAX package's layout: ``layers_list`` holds one dict per
layer, matmul weights ``[in, out]`` applied as ``x @ w`` (or int8/int4
dicts, through ``matmul_w``); ``A_log``, ``D`` and
``dt_bias`` are fp32 whatever the compute dtype in a random init, and in the
compute dtype after a checkpoint load (as the JAX loader casts them).

The cache is a list with one dict per layer, updated in place:

- attention layer: ``{"k", "v"}`` ``[B, H_kv, S_max, head_dim]``, allocated
  once at the generation's length; prefill writes rows [0, S), a decode step
  writes row ``pos`` and attends over ``pos + 1`` rows (K1/K2 on the card),
  ``pos`` a :class:`~zonos_tpu_torch.ops.attention.StepPosition` on the
  device, as in the transformer;
- Mamba2 layer: ``{"conv"}`` ``[B, K-1, conv_dim]`` in the compute dtype and
  the SSM state in the storage of the SSM-state mode, as the JAX package
  keys it: ``{"ssm"}`` ``[B, H, P, N]`` in fp32, bf16 or float8 e4m3; in
  int8 mode ``{"ssm"}`` int8 and ``{"ssm_scale"}`` ``[B, H, 1, 1]`` fp32 (one
  scale a row and head, absmax / 127 of each new state); in int4 mode
  ``{"ssm_q4"}`` ``[B, H, P, N/2]`` int8, two values a byte (the +-7 grid,
  element 2i in the low nibble), and ``{"ssm_scale"}`` (absmax / 7); prefill
  replaces them (K6 on the card, the quantization in plain torch), a decode
  step rewrites them (K7 writes the SSM state and its scales in place).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.models.backbone import rope_at, write_rows
from zonos_tpu_torch.ops.attention import StepPosition, decode_attention, fresh_prefill_attention
from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.ops.norms import apply_norm
from zonos_tpu_torch.ops.quant import norm_matmul, store_cast
from zonos_tpu_torch.ops.rope import apply_rope_neox, cached_rope_table
from zonos_tpu_torch.ops.tp import column_parallel, local_heads, model_size, row_parallel
from zonos_tpu_torch.kernels.ssm_state import dequantize_state, quantize_state
from zonos_tpu_torch.ops.ssm import (
    causal_conv1d_prefill,
    causal_conv1d_step,
    ssd_chunked,
    ssd_decode_step,
)

SSM_STATE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "f8": torch.float8_e4m3fn,
                    "int8": torch.int8, "int4": torch.int8}
F8_STATE_FROM_ROWS = 16  # the batch-aware default: f8 from 16 CFG-doubled rows up


def _dims(cfg: BackboneConfig):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H = d_inner // cfg.ssm_headdim
    G, N, K = cfg.ssm_ngroups, cfg.ssm_d_state, cfg.ssm_d_conv
    return d, d_inner, H, G, N, K, d_inner + 2 * G * N


def _attn_dims(cfg: BackboneConfig):
    H, Hkv = cfg.num_heads, cfg.num_heads_kv
    hd = int(cfg.attn_cfg.get("head_dim", cfg.d_model // H))
    rot = int(cfg.attn_cfg.get("rotary_emb_dim", hd // 2))
    return H, Hkv, hd, rot


def is_attn_layer(cfg: BackboneConfig, i: int) -> bool:
    return i in set(cfg.attn_layer_idx)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_hybrid_params(cfg: BackboneConfig, generator: torch.Generator,
                       dtype=torch.bfloat16, device="cpu") -> dict:
    """Random-init parameters as the JAX init draws them (N(0, 1/fan_in)
    matmuls, N(0, 0.2^2) conv taps, A_log 0, D 1, dt_bias 0 in fp32, unit
    norms).  ``generator`` lives on ``device``."""
    d, d_inner, H, G, N, K, conv_dim = _dims(cfg)
    aH, aHkv, ahd, _ = _attn_dims(cfg)

    def randn(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def dense(shape):
        return (randn(shape) / shape[-2] ** 0.5).to(dtype)

    def const(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    layers = []
    for i in range(cfg.n_layer):
        lp = {"norm_scale": const((d,), 1.0)}
        if not cfg.rms_norm:
            lp["norm_bias"] = const((d,), 0.0)
        if is_attn_layer(cfg, i):
            lp["wqkv"] = dense((d, (aH + 2 * aHkv) * ahd))
            lp["wo"] = dense((aH * ahd, d))
            mlp_dim = cfg.attn_mlp_d_intermediate
        else:
            lp["in_proj"] = dense((d, 2 * d_inner + 2 * G * N + H))
            lp["conv_w"] = (randn((K, conv_dim)) * 0.2).to(dtype)
            lp["conv_b"] = const((conv_dim,), 0.0)
            lp["A_log"] = const((H,), 0.0, torch.float32)
            lp["D"] = const((H,), 1.0, torch.float32)
            lp["dt_bias"] = const((H,), 0.0, torch.float32)
            lp["mixer_norm"] = const((d_inner,), 1.0)
            lp["out_proj"] = dense((d_inner, d))
            mlp_dim = cfg.d_intermediate
        if mlp_dim:
            lp["norm2_scale"] = const((d,), 1.0)
            if not cfg.rms_norm:
                lp["norm2_bias"] = const((d,), 0.0)
            lp["w1"] = dense((d, 2 * mlp_dim))
            lp["w2"] = dense((mlp_dim, d))
        layers.append(lp)
    p = {"layers_list": layers, "normf_scale": const((d,), 1.0)}
    if not cfg.rms_norm:
        p["normf_bias"] = const((d,), 0.0)
    return p


# ---------------------------------------------------------------------------
# Cache and SSM-state storage
# ---------------------------------------------------------------------------


def ssm_state_mode(rows: int | None = None, mode: str | None = None) -> str:
    """The SSM decode-state storage mode: ``mode`` when given, else the JAX
    package's batch-aware default, f8 from 16 cache rows (CFG-doubled) up and
    fp32 below (zonos_tpu/models/hybrid.py:108-143, without its environment
    variables).  int8 and int4 store a quarter and an eighth of the fp32
    state's bytes, plus one fp32 scale a row and head."""
    if mode is None:
        mode = "f8" if rows is not None and rows >= F8_STATE_FROM_ROWS else "fp32"
    if mode not in SSM_STATE_DTYPES:
        raise ValueError(f"SSM state mode {mode!r}: want fp32|bf16|f8|int8|int4")
    return mode


def create_hybrid_cache(cfg: BackboneConfig, batch: int, max_seqlen: int,
                        dtype=torch.bfloat16, device="cpu", ssm_state: str | None = None
                        ) -> list[dict]:
    """Zeroed per-layer states for ``batch`` rows (2B with CFG).  A bf16
    compute dtype stores the SSM state by ``ssm_state_mode(batch, ssm_state)``;
    any other compute dtype stores it in fp32 unless ``ssm_state`` says
    otherwise, as the JAX package does.  Under a model axis (``ops/tp.py``)
    an attention layer holds ``H_kv / model_size()`` heads a rank (the Mamba2
    states are replicated)."""
    _, _, H, _, N, K, conv_dim = _dims(cfg)
    _, aHkv, ahd, _ = _attn_dims(cfg)
    aHkv //= model_size()
    if ssm_state is None and dtype != torch.bfloat16:
        ssm_state = "fp32"
    mode = ssm_state_mode(batch, ssm_state)
    P = cfg.ssm_headdim
    cache = []
    for i in range(cfg.n_layer):
        if is_attn_layer(cfg, i):
            shape = (batch, aHkv, max_seqlen, ahd)
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)})
            continue
        st = {"conv": torch.zeros((batch, K - 1, conv_dim), dtype=dtype, device=device)}
        if mode == "int4":
            st["ssm_q4"] = torch.zeros((batch, H, P, N // 2), dtype=torch.int8, device=device)
        else:
            st["ssm"] = torch.zeros((batch, H, P, N), dtype=SSM_STATE_DTYPES[mode], device=device)
        if mode in ("int8", "int4"):
            st["ssm_scale"] = torch.ones((batch, H, 1, 1), dtype=torch.float32, device=device)
        cache.append(st)
    return cache


def _state_mode(st: dict) -> str | None:
    """A Mamba2 layer's quantized storage, ``"int8"`` or ``"int4"``, or None."""
    if "ssm_q4" in st:
        return "int4"
    return "int8" if "ssm_scale" in st else None


def load_ssm(st: dict) -> torch.Tensor:
    """A Mamba2 layer's stored SSM state as fp32 ``[B, H, P, N]``
    (zonos_tpu/models/hybrid.py:155-166)."""
    mode = _state_mode(st)
    if mode is None:
        return st["ssm"].float()
    return dequantize_state(st["ssm_q4" if mode == "int4" else "ssm"], st["ssm_scale"], mode)


def store_ssm(st: dict, s: torch.Tensor) -> None:
    """Store the fp32 state ``s`` in the layer's storage, in place: a cast
    (f8 saturated to +-448), or int8/int4 values and new scales
    (zonos_tpu/models/hybrid.py:169-191)."""
    mode = _state_mode(st)
    if mode is None:
        store_cast(st["ssm"], s)
        return
    q, scale = quantize_state(s.float(), mode)
    st["ssm_q4" if mode == "int4" else "ssm"].copy_(q)
    st["ssm_scale"].copy_(scale)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _norm_of(cfg: BackboneConfig, scale, bias) -> Norm:
    """The block's norm (RMSNorm or LayerNorm by the config) as an operand."""
    return Norm(scale, bias, cfg.norm_epsilon, rms=cfg.rms_norm)


def _mamba_mixer(cfg: BackboneConfig, lp: dict, x: torch.Tensor, norm: Norm,
                 dtype: torch.dtype, st: dict, prefill: bool) -> torch.Tensor:
    """The residual x [B, S, d] -> [B, S, d] in the compute dtype ``dtype``,
    through ``norm`` (folded into in_proj); rewrites ``st`` (a prefill with
    no ``st`` keeps no state)."""
    _, d_inner, H, G, N, _, conv_dim = _dims(cfg)
    P = cfg.ssm_headdim
    B, S, _ = x.shape
    z, xBC, dt_raw = torch.split(norm_matmul(x, norm, lp["in_proj"], dtype),
                                 [d_inner, conv_dim, H], dim=-1)
    w, b = lp["conv_w"].to(xBC.dtype), lp["conv_b"].to(xBC.dtype)
    if prefill:
        xBC, conv_state = causal_conv1d_prefill(xBC, w, b)
    else:
        y1, conv_state = causal_conv1d_step(xBC[:, 0], st["conv"].to(xBC.dtype), w, b)
        xBC = y1[:, None, :]
    if st is not None:
        st["conv"].copy_(conv_state)
    xBC = F.silu(xBC)

    xs = xBC[..., :d_inner].reshape(B, S, H, P).float().contiguous()
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N).float().contiguous()
    Cm = xBC[..., d_inner + G * N:].reshape(B, S, G, N).float().contiguous()
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])  # [B, S, H]
    # a checkpoint load casts A_log and D to the compute dtype, as the JAX
    # loader does: A is then rounded there and widened exactly, as JAX
    # promotes it against dt
    A = -torch.exp(lp["A_log"]).float()
    D = lp["D"].float()
    if prefill:
        # prefill starts from the zero state, as the conv above does: the JAX
        # package passes its fresh cache's zeros, which K6 reads as no state
        y, final = ssd_chunked(xs, dt.contiguous(), A, Bm, Cm, D)
        if st is not None:
            store_ssm(st, final)
    else:
        state = st["ssm_q4"] if "ssm_q4" in st else st["ssm"]
        y, _ = ssd_decode_step(xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, state,
                               st.get("ssm_scale"))
        y = y[:, None]

    # y is cast to the compute dtype before the gate; the mixer norm follows it
    gated = y.reshape(B, S, d_inner).to(dtype) * F.silu(z)
    mixer_norm = Norm(lp["mixer_norm"], None, cfg.norm_epsilon, rms=True)
    return norm_matmul(gated, mixer_norm, lp["out_proj"])


def _attn_mixer(cfg: BackboneConfig, lp: dict, x: torch.Tensor, norm: Norm,
                dtype: torch.dtype, st: dict, pos: int | StepPosition,
                prefill: bool) -> torch.Tensor:
    """The residual x through ``norm`` (folded into wqkv) -> [B, S, d] in
    the compute dtype ``dtype``; on a model axis over this rank's heads,
    ``wo`` summed over the axis."""
    H, Hkv, hd, rot = _attn_dims(cfg)
    H, Hkv = local_heads(H, Hkv, hd, lp["wqkv"])
    B, S, _ = x.shape
    q, k, v = torch.split(column_parallel(x, norm, lp["wqkv"], dtype),
                          [H * hd, Hkv * hd, Hkv * hd], dim=-1)
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, S, Hkv, hd), v.reshape(B, S, Hkv, hd)
    if rot > 0:  # rotate-halves over the first `rot` dims; the rest pass through
        cos_t, sin_t = cached_rope_table(rot, cfg.rope_base, x.device)
        cos, sin = rope_at(cos_t, sin_t, pos, S)
        q = torch.cat([apply_rope_neox(q[..., :rot], cos, sin), q[..., rot:]], dim=-1)
        k = torch.cat([apply_rope_neox(k[..., :rot], cos, sin), k[..., rot:]], dim=-1)
    if st is not None:
        write_rows(st["k"], pos, k.transpose(1, 2))
        write_rows(st["v"], pos, v.transpose(1, 2))
    if prefill:
        y = fresh_prefill_attention(q, k, v)
    else:
        y = decode_attention(q, st["k"], st["v"], pos.length, pos.band)
    return row_parallel(y.reshape(B, S, H * hd), lp["wo"])


def _block(cfg: BackboneConfig, i: int, lp: dict, x: torch.Tensor, st: dict,
           pos: int | StepPosition, prefill: bool, compute_dtype: torch.dtype) -> torch.Tensor:
    # the block's norms each feed one product: the mixer's first, then w1
    norm = _norm_of(cfg, lp["norm_scale"], lp.get("norm_bias"))
    if is_attn_layer(cfg, i):
        y = _attn_mixer(cfg, lp, x, norm, compute_dtype, st, pos, prefill)
    else:
        y = _mamba_mixer(cfg, lp, x, norm, compute_dtype, st, prefill)
    x = x + y.to(x.dtype)
    if "w1" in lp:
        norm2 = _norm_of(cfg, lp["norm2_scale"], lp.get("norm2_bias"))
        u, gate = torch.chunk(column_parallel(x, norm2, lp["w1"], compute_dtype), 2, dim=-1)
        x = x + row_parallel(u * F.silu(gate), lp["w2"]).to(x.dtype)
    return x


def _run(cfg: BackboneConfig, params: dict, x: torch.Tensor, cache: list[dict] | None,
         pos: int | StepPosition, prefill: bool) -> torch.Tensor:
    compute_dtype = x.dtype
    if cfg.residual_in_fp32:
        x = x.float()
    layers = params["layers_list"]
    for i, (lp, st) in enumerate(zip(layers, cache or [None] * len(layers))):
        x = _block(cfg, i, lp, x, st, pos, prefill, compute_dtype)
    normf = _norm_of(cfg, params["normf_scale"], params.get("normf_bias"))
    return apply_norm(x, normf).to(compute_dtype)


def hybrid_forward(cfg: BackboneConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The state-free full-sequence forward of ``x [B, S, d]`` (training and
    scoring): the prefill's blocks with no cache, so nothing is written in
    place under autograd (JAX prefills into a throwaway cache,
    zonos_tpu/parallel/train.py:26-32)."""
    return _run(cfg, params, x, None, 0, prefill=True)


def hybrid_prefill(cfg: BackboneConfig, params: dict, x: torch.Tensor,
                   cache: list[dict]) -> tuple[torch.Tensor, list[dict]]:
    """Run the prompt ``x [B, S, d]`` from position 0 and zero conv and SSM
    states; returns the final-norm hidden states ``[B, S, d]`` and the cache,
    filled in place (its earlier contents are not read)."""
    return _run(cfg, params, x, cache, 0, prefill=True), cache


def hybrid_decode_step(cfg: BackboneConfig, params: dict, x: torch.Tensor, cache: list[dict],
                       pos: int | StepPosition) -> tuple[torch.Tensor, list[dict]]:
    """One decode step: ``x [B, 1, d]`` at position ``pos``, a
    :class:`StepPosition` on the device (or a host int, for a caller outside
    the decode loop)."""
    if not isinstance(pos, StepPosition):
        pos = StepPosition.at(pos, x.device)
    return _run(cfg, params, x, cache, pos, prefill=False), cache


# ---------------------------------------------------------------------------
# Checkpoint conversion (mamba_ssm state-dict naming)
# ---------------------------------------------------------------------------


def convert_hybrid_backbone(sd: dict, zcfg, put) -> dict:
    """The reference hybrid's ``backbone.*`` tensors -> ``layers_list``
    (zonos_tpu/models/hybrid.py:373-407); ``put`` moves a tensor to the
    device and casts it (``utils/checkpoint.py``).  An attention layer's
    fused projection is ``mixer.Wqkv.weight`` or ``mixer.in_proj.weight``."""
    cfg: BackboneConfig = zcfg.backbone
    layers = []
    for i in range(cfg.n_layer):
        pre = f"backbone.layers.{i}."
        lp: dict = {"norm_scale": put(sd[pre + "norm.weight"])}
        if pre + "norm.bias" in sd:
            lp["norm_bias"] = put(sd[pre + "norm.bias"])
        if is_attn_layer(cfg, i):
            name = "mixer.Wqkv.weight" if pre + "mixer.Wqkv.weight" in sd else "mixer.in_proj.weight"
            lp["wqkv"] = put(sd[pre + name], True)
            lp["wo"] = put(sd[pre + "mixer.out_proj.weight"], True)
        else:
            lp["in_proj"] = put(sd[pre + "mixer.in_proj.weight"], True)
            lp["conv_w"] = put(sd[pre + "mixer.conv1d.weight"][:, 0, :], True)  # [C,1,K] -> [K,C]
            lp["conv_b"] = put(sd[pre + "mixer.conv1d.bias"])
            lp["A_log"] = put(sd[pre + "mixer.A_log"])
            lp["D"] = put(sd[pre + "mixer.D"])
            lp["dt_bias"] = put(sd[pre + "mixer.dt_bias"])
            lp["mixer_norm"] = put(sd[pre + "mixer.norm.weight"])
            lp["out_proj"] = put(sd[pre + "mixer.out_proj.weight"], True)
        if pre + "mlp.fc1.weight" in sd:
            lp["norm2_scale"] = put(sd[pre + "norm2.weight"])
            if pre + "norm2.bias" in sd:
                lp["norm2_bias"] = put(sd[pre + "norm2.bias"])
            lp["w1"] = put(sd[pre + "mlp.fc1.weight"], True)
            lp["w2"] = put(sd[pre + "mlp.fc2.weight"], True)
        layers.append(lp)
    out = {"layers_list": layers, "normf_scale": put(sd["backbone.norm_f.weight"])}
    if "backbone.norm_f.bias" in sd:
        out["normf_bias"] = put(sd["backbone.norm_f.bias"])
    return out
