"""Reference-format checkpoints: safetensors files with the reference's key
names (zonos/model.py's module tree), read into the port's parameters and
written back (counterpart of zonos_tpu/utils/checkpoint.py).

The safetensors reader and writer are the port's own: a little-endian u64
header length, a JSON header ``{name: {dtype, shape, data_offsets}}`` with an
optional ``__metadata__`` of strings, then the tensors' raw bytes.  The
reader maps the file and wraps each tensor's bytes with ``torch.frombuffer``,
so nothing is copied on the host before it moves to the device.

Conversion is done on the device: each reference tensor moves there as
stored (a bf16 file stays bf16 on the way), torch ``nn.Linear`` weights
``[out, in]`` are transposed into the port's ``[in, out]`` as they are
copied into a stack preallocated on axis 0, and the embeddings and heads are
zero-padded to ``config.padded_vocab_size``.  Every floating leaf is cast to
one ``dtype``, as the JAX loader casts every leaf (the hybrid's ``A_log``,
``D`` and ``dt_bias`` and the Fourier conditioners' features included).
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from pathlib import Path

import torch

from zonos_tpu_torch.conditioning import build_specs
from zonos_tpu_torch.config import ZonosConfig

_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def _read_header(path: str) -> tuple[dict, int]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def safetensors_metadata(path: str) -> dict[str, str]:
    """The file's ``__metadata__`` ({} when it has none)."""
    return _read_header(path)[0].get("__metadata__", {})


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor over the mapped file (copy-on-write: writing to a
    tensor never reaches the file)."""
    header, start = _read_header(path)
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = _DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        numel = math.prod(shape)
        if end - begin != numel * dtype.itemsize or start + end > len(buf):
            raise ValueError(f"{path}: {name}'s offsets {begin}-{end} do not hold {info}")
        if numel == 0:  # torch.frombuffer takes no empty range
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=start + begin).reshape(shape)
    return out


def save_safetensors(path: str, tensors: dict[str, torch.Tensor],
                     metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (on any device; each is copied to the host as it is
    written) in the safetensors format, wider types first so every tensor is
    aligned to its item size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name]
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)


# ---------------------------------------------------------------------------
# Reference state dict -> port parameters
# ---------------------------------------------------------------------------


class _Put:
    """Moves reference tensors to ``device`` and casts them to ``dtype``
    there."""

    def __init__(self, device, dtype):
        self.device, self.dtype = torch.device(device), dtype

    def __call__(self, t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        t = t.to(self.device)
        return (t.T if transpose else t).to(self.dtype).contiguous()

    def stacked(self, sd: dict, pattern: str, n_layer: int, transpose: bool) -> torch.Tensor:
        first = sd[pattern.format(0)]
        shape = tuple(reversed(first.shape)) if transpose else tuple(first.shape)
        out = torch.empty((n_layer, *shape), dtype=self.dtype, device=self.device)
        for i in range(n_layer):
            t = sd[pattern.format(i)].to(self.device)
            out[i].copy_(t.T if transpose else t)
        return out


def convert_transformer_backbone(sd: dict, cfg: ZonosConfig, put: _Put) -> dict:
    L = cfg.backbone.n_layer
    pre = "backbone.layers.{}."
    return {
        "layers": {
            "norm1_scale": put.stacked(sd, pre + "norm.weight", L, False),
            "norm1_bias": put.stacked(sd, pre + "norm.bias", L, False),
            "wqkv": put.stacked(sd, pre + "mixer.in_proj.weight", L, True),
            "wo": put.stacked(sd, pre + "mixer.out_proj.weight", L, True),
            "norm2_scale": put.stacked(sd, pre + "norm2.weight", L, False),
            "norm2_bias": put.stacked(sd, pre + "norm2.bias", L, False),
            "w1": put.stacked(sd, pre + "mlp.fc1.weight", L, True),
            "w2": put.stacked(sd, pre + "mlp.fc2.weight", L, True),
        },
        "normf_scale": put(sd["backbone.norm_f.weight"]),
        "normf_bias": put(sd["backbone.norm_f.bias"]),
    }


def convert_embeddings_heads(sd: dict, cfg: ZonosConfig, put: _Put) -> dict:
    """Embeddings ``[K, Vp, d]`` and the fused heads ``[d, K*Vp]``, the rows
    past the reference's zero (``_pad_rows`` of the JAX loader)."""
    K, Vp, d = cfg.num_codebooks, cfg.padded_vocab_size, cfg.backbone.d_model
    emb = torch.zeros((K, Vp, d), dtype=put.dtype, device=put.device)
    heads = torch.zeros((d, K * Vp), dtype=put.dtype, device=put.device)
    for k in range(K):
        e = sd[f"embeddings.{k}.weight"][:Vp]
        emb[k, :e.shape[0]].copy_(e.to(put.device))
        w = sd[f"heads.{k}.weight"].to(put.device)  # [V_out, d]
        heads[:, k * Vp:k * Vp + w.shape[0]].copy_(w.T)
    return {"embeddings": emb, "heads": heads}


def convert_prefix_conditioner(sd: dict, cfg: ZonosConfig, put: _Put) -> dict:
    specs = build_specs(cfg.prefix_conditioner, cfg.backbone.d_model)
    params: dict = {
        "_norm": {"scale": put(sd["prefix_conditioner.norm.weight"]),
                  "bias": put(sd["prefix_conditioner.norm.bias"])},
        "_project": {},
    }
    if "prefix_conditioner.project.weight" in sd:
        params["_project"] = {"w": put(sd["prefix_conditioner.project.weight"], True),
                              "b": put(sd["prefix_conditioner.project.bias"])}
    for j, spec in enumerate(specs):
        pre = f"prefix_conditioner.conditioners.{j}."
        p: dict = {"project": {}}
        if pre + "project.weight" in sd:
            p["project"] = {"w": put(sd[pre + "project.weight"], True),
                            "b": put(sd[pre + "project.bias"])}
        elif pre + "project.0.weight" in sd:  # mlp projection
            p["project"] = {"w1": put(sd[pre + "project.0.weight"], True),
                            "b1": put(sd[pre + "project.0.bias"]),
                            "w2": put(sd[pre + "project.2.weight"], True),
                            "b2": put(sd[pre + "project.2.bias"])}
        if pre + "uncond_vector" in sd:
            p["uncond_vector"] = put(sd[pre + "uncond_vector"])
        if spec.type == "Espeak":
            p["embed"] = put(sd[pre + "phoneme_embedder.weight"])
        elif spec.type == "Fourier":
            p["weight"] = put(sd[pre + "weight"])
        elif spec.type == "Integer":
            p["embed"] = put(sd[pre + "int_embedder.weight"])
        params[spec.name] = p
    return params


def load_zonos_checkpoint(cfg: ZonosConfig, path: str, device,
                          dtype: torch.dtype = torch.bfloat16, mesh=None) -> dict:
    """A reference-format ``model.safetensors`` -> the port's ``Zonos``
    parameters on ``device``, every leaf in ``dtype``.  With a ``mesh``
    whose model axis has more than one rank, this rank's shard
    (``parallel/sharding.py`` ``shard_params``): the conversion runs on the
    host and each sharded weight is cut to the rank's part, section by
    section, before it moves to the device, which never holds a whole
    replica of it (zonos_tpu/utils/checkpoint.py:116-161)."""
    from zonos_tpu_torch.ops.tp import axis_size

    if mesh is not None and axis_size(mesh, "model") > 1:
        from zonos_tpu_torch.parallel.sharding import map_specs, shard_params, zonos_param_specs

        host = shard_params(mesh, load_zonos_checkpoint(cfg, path, "cpu", dtype), cfg)
        return map_specs(lambda t, _: t.to(device), host, zonos_param_specs(host, cfg))
    sd = load_safetensors(path)
    put = _Put(device, dtype)
    if cfg.backbone.is_transformer:
        backbone = convert_transformer_backbone(sd, cfg, put)
    else:
        from zonos_tpu_torch.models.hybrid import convert_hybrid_backbone

        backbone = convert_hybrid_backbone(sd, cfg, put)
    params = {"backbone": backbone, "prefix_conditioner": convert_prefix_conditioner(sd, cfg, put)}
    params.update(convert_embeddings_heads(sd, cfg, put))
    return params


# ---------------------------------------------------------------------------
# Port parameters -> reference state dict
# ---------------------------------------------------------------------------


def _check_float(params: dict) -> None:
    def walk(x):
        if isinstance(x, dict):
            if "q" in x or "q4" in x:
                raise ValueError("quantized parameters cannot be exported; export the float model")
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(params)


def export_state_dict(cfg: ZonosConfig, params: dict) -> dict[str, torch.Tensor]:
    """The port's parameters -> a flat dict with the reference's names and
    layouts (views of the parameters where the layout allows): layer stacks
    unstacked, matmul weights back to ``[out, in]``, the vocabulary cut to
    the reference's 1026 embedding and 1025 head rows.  The inverse of
    :func:`load_zonos_checkpoint`."""
    _check_float(params)
    sd: dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    if cfg.backbone.is_transformer:
        lay = bb["layers"]
        for i in range(cfg.backbone.n_layer):
            pre = f"backbone.layers.{i}."
            sd[pre + "norm.weight"] = lay["norm1_scale"][i]
            sd[pre + "norm.bias"] = lay["norm1_bias"][i]
            sd[pre + "mixer.in_proj.weight"] = lay["wqkv"][i].T
            sd[pre + "mixer.out_proj.weight"] = lay["wo"][i].T
            sd[pre + "norm2.weight"] = lay["norm2_scale"][i]
            sd[pre + "norm2.bias"] = lay["norm2_bias"][i]
            sd[pre + "mlp.fc1.weight"] = lay["w1"][i].T
            sd[pre + "mlp.fc2.weight"] = lay["w2"][i].T
    else:
        for i, lp in enumerate(bb["layers_list"]):
            pre = f"backbone.layers.{i}."
            sd[pre + "norm.weight"] = lp["norm_scale"]
            if "norm_bias" in lp:
                sd[pre + "norm.bias"] = lp["norm_bias"]
            if "wqkv" in lp:  # attention layer
                sd[pre + "mixer.in_proj.weight"] = lp["wqkv"].T
                sd[pre + "mixer.out_proj.weight"] = lp["wo"].T
            else:  # Mamba2 layer
                sd[pre + "mixer.in_proj.weight"] = lp["in_proj"].T
                sd[pre + "mixer.conv1d.weight"] = lp["conv_w"].T[:, None, :]  # [K,C] -> [C,1,K]
                sd[pre + "mixer.conv1d.bias"] = lp["conv_b"]
                sd[pre + "mixer.A_log"] = lp["A_log"]
                sd[pre + "mixer.D"] = lp["D"]
                sd[pre + "mixer.dt_bias"] = lp["dt_bias"]
                sd[pre + "mixer.norm.weight"] = lp["mixer_norm"]
                sd[pre + "mixer.out_proj.weight"] = lp["out_proj"].T
            if "w1" in lp:
                sd[pre + "norm2.weight"] = lp["norm2_scale"]
                if "norm2_bias" in lp:
                    sd[pre + "norm2.bias"] = lp["norm2_bias"]
                sd[pre + "mlp.fc1.weight"] = lp["w1"].T
                sd[pre + "mlp.fc2.weight"] = lp["w2"].T
    sd["backbone.norm_f.weight"] = bb["normf_scale"]
    if "normf_bias" in bb:
        sd["backbone.norm_f.bias"] = bb["normf_bias"]

    K, Vp = cfg.num_codebooks, cfg.padded_vocab_size
    Vi, Vo = cfg.input_vocab_size, cfg.output_vocab_size
    for k in range(K):
        sd[f"embeddings.{k}.weight"] = params["embeddings"][k, :Vi]
        sd[f"heads.{k}.weight"] = params["heads"][:, k * Vp:k * Vp + Vo].T

    pc = params["prefix_conditioner"]
    sd["prefix_conditioner.norm.weight"] = pc["_norm"]["scale"]
    sd["prefix_conditioner.norm.bias"] = pc["_norm"]["bias"]
    if pc.get("_project"):
        sd["prefix_conditioner.project.weight"] = pc["_project"]["w"].T
        sd["prefix_conditioner.project.bias"] = pc["_project"]["b"]
    for j, spec in enumerate(build_specs(cfg.prefix_conditioner, cfg.backbone.d_model)):
        pre = f"prefix_conditioner.conditioners.{j}."
        p = pc[spec.name]
        proj = p.get("project") or {}
        if "w" in proj:
            sd[pre + "project.weight"] = proj["w"].T
            sd[pre + "project.bias"] = proj["b"]
        elif "w1" in proj:
            sd[pre + "project.0.weight"] = proj["w1"].T
            sd[pre + "project.0.bias"] = proj["b1"]
            sd[pre + "project.2.weight"] = proj["w2"].T
            sd[pre + "project.2.bias"] = proj["b2"]
        if "uncond_vector" in p:
            sd[pre + "uncond_vector"] = p["uncond_vector"]
        if spec.type == "Espeak":
            sd[pre + "phoneme_embedder.weight"] = p["embed"]
        elif spec.type == "Fourier":
            sd[pre + "weight"] = p["weight"]
        elif spec.type == "Integer":
            sd[pre + "int_embedder.weight"] = p["embed"]
    return sd


def config_to_reference_dict(cfg: ZonosConfig) -> dict:
    """ZonosConfig -> the reference's config.json schema (zonos/config.py:28-62)."""
    bb = cfg.backbone
    return {
        "backbone": {
            "d_model": bb.d_model,
            "d_intermediate": bb.d_intermediate,
            "attn_mlp_d_intermediate": bb.attn_mlp_d_intermediate,
            "n_layer": bb.n_layer,
            "ssm_cfg": dict(bb.ssm_cfg),
            "attn_layer_idx": list(bb.attn_layer_idx),
            "attn_cfg": dict(bb.attn_cfg),
            "rms_norm": bb.rms_norm,
            "residual_in_fp32": bb.residual_in_fp32,
            "norm_epsilon": bb.norm_epsilon,
        },
        "prefix_conditioner": {
            "conditioners": [dict(c) for c in cfg.prefix_conditioner.conditioners],
            "projection": cfg.prefix_conditioner.projection,
        },
        "eos_token_id": cfg.eos_token_id,
        "masked_token_id": cfg.masked_token_id,
    }


def export_zonos_checkpoint(cfg: ZonosConfig, params: dict, out_dir: str,
                            dtype: str = "bfloat16") -> str:
    """Write ``config.json`` and ``model.safetensors`` in the reference's
    format under ``out_dir`` (they load back through ``Zonos.from_local`` in
    either package).  Returns the safetensors path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    sd = {k: v.to(torch_dtype) for k, v in export_state_dict(cfg, params).items()}
    path = out / "model.safetensors"
    save_safetensors(str(path), sd)
    (out / "config.json").write_text(json.dumps(config_to_reference_dict(cfg), indent=2))
    return str(path)
