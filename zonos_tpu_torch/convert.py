"""Carry weights across from the JAX package.

Each function takes the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's parameters as
tensors on ``device``.  float32 arrays and ``ml_dtypes`` bfloat16 and
float8_e4m3fn arrays are accepted; their bytes are reinterpreted through
``uint16``/``uint8`` because ``torch.from_numpy`` rejects those dtypes.

Layouts:
- Zonos: the port keeps the JAX layout, so the tree maps one to one:
  layers stacked on axis 0, matmul weights ``[in, out]`` applied as
  ``x @ w``, ``w1`` with the up half before the gate half, embeddings
  ``[9, 1152, d]`` with zero pad rows, heads ``[d, 9*1152]``.
- DAC (encoder, quantizers, decoder): conv ``[K, C_in, C_out]`` -> torch ``[C_out, C_in, K]``;
  transposed conv ``[K, C_in, C_out]`` -> torch ``[C_in, C_out, K]`` (torch's
  transposed conv has the kernel flip the JAX version applies at call time).
- Speaker tower (ResNet293) and ECAPA-TDNN: conv2d HWIO -> OIHW, conv1d NLC
  -> NCL; matrices and folded BatchNorms as they are.

Reference-format checkpoints (safetensors and ``.pt`` files with the
reference's key names) load through ``utils/checkpoint.py``,
``models/dac/convert.py`` and ``models/speaker/convert.py`` instead.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy()).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(x, fn, path=()):
    if isinstance(x, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn, path + (i,)) for i, v in enumerate(x)]
    return fn(x, path)


_FP32_SSM_LEAVES = ("A_log", "D", "dt_bias")  # added in fp32 by the Mamba2 mixer
_QUANT_SCALES = ("s", "s4")  # bf16 scales of int8/int4 weights (models/backbone.py)


def convert_zonos_params(params: dict, device="cpu", dtype: torch.dtype | None = None) -> dict:
    """JAX ``Zonos.params`` (numpy leaves) -> the port's ``Zonos`` params, for
    the transformer and the hybrid (whose ``layers_list`` of per-layer dicts
    is carried across as a list).  ``dtype`` recasts the floating leaves,
    except those the JAX init keeps fp32: the Fourier conditioners' random
    features and the hybrid's ``A_log``, ``D`` and ``dt_bias``.  Quantized
    weights keep their types: ``q``/``q4`` int8, the scales ``s``/``s4`` bf16."""

    def leaf(a, path):
        t = to_tensor(a, device)
        fourier = path[0] == "prefix_conditioner" and path[-1] == "weight"
        ssm = path[0] == "backbone" and path[-1] in _FP32_SSM_LEAVES
        scale = path[-1] in _QUANT_SCALES
        keep = fourier or ssm or scale or not t.is_floating_point()
        return t.to(dtype) if dtype is not None and not keep else t

    return _tree(params, leaf)


def _conv(p: dict, device, transposed: bool = False) -> dict:
    w = np.asarray(p["w"], np.float32)
    w = np.transpose(w, (1, 2, 0) if transposed else (2, 1, 0))
    return {"w": to_tensor(w, device), "b": to_tensor(np.asarray(p["b"], np.float32), device)}


def _res_unit(p: dict, device) -> dict:
    return {
        "alpha1": to_tensor(np.asarray(p["alpha1"], np.float32), device),
        "conv1": _conv(p["conv1"], device),
        "alpha2": to_tensor(np.asarray(p["alpha2"], np.float32), device),
        "conv2": _conv(p["conv2"], device),
    }


def convert_dac_params(params: dict, device="cpu") -> dict:
    """JAX DAC params (numpy leaves) -> the port's DAC params: the encoder,
    each quantizer's ``in_proj``, ``out_proj`` and codebook, and the decoder."""
    dec, enc = params["decoder"], params["encoder"]
    f32 = lambda a: to_tensor(np.asarray(a, np.float32), device)  # noqa: E731
    return {
        "encoder": {
            "conv1": _conv(enc["conv1"], device),
            "blocks": [
                {
                    "res1": _res_unit(b["res1"], device),
                    "res2": _res_unit(b["res2"], device),
                    "res3": _res_unit(b["res3"], device),
                    "alpha": f32(b["alpha"]),
                    "down": _conv(b["down"], device),
                }
                for b in enc["blocks"]
            ],
            "alpha": f32(enc["alpha"]),
            "conv2": _conv(enc["conv2"], device),
        },
        "decoder": {
            "conv1": _conv(dec["conv1"], device),
            "blocks": [
                {
                    "alpha": f32(b["alpha"]),
                    "up": _conv(b["up"], device, transposed=True),
                    "res1": _res_unit(b["res1"], device),
                    "res2": _res_unit(b["res2"], device),
                    "res3": _res_unit(b["res3"], device),
                }
                for b in dec["blocks"]
            ],
            "alpha": f32(dec["alpha"]),
            "conv2": _conv(dec["conv2"], device),
        },
        "quantizers": [
            {"in_proj": _conv(q["in_proj"], device), "out_proj": _conv(q["out_proj"], device),
             "codebook": f32(q["codebook"])}
            for q in params["quantizers"]
        ],
    }


def _f32(a, device) -> torch.Tensor:
    return to_tensor(np.asarray(a, np.float32), device)


def _bn(p: dict, device) -> dict:
    return {"scale": _f32(p["scale"], device), "shift": _f32(p["shift"], device)}


def convert_speaker_params(params: dict, device="cpu") -> dict:
    """JAX speaker-tower params (numpy leaves, zonos_tpu/models/speaker/resnet.py)
    -> the port's: conv ``[kh, kw, C_in, C_out]`` (HWIO) -> torch ``[C_out,
    C_in, kh, kw]``; BatchNorm scales and shifts, the pooling's and the
    bottleneck's ``[in, out]`` matrices as they are."""

    def c2(w):
        return _f32(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)), device)

    def block(b):
        out = {"conv1": c2(b["conv1"]), "bn1": _bn(b["bn1"], device),
               "conv2": c2(b["conv2"]), "bn2": _bn(b["bn2"], device)}
        if "down_conv" in b:
            out["down_conv"] = c2(b["down_conv"])
            out["down_bn"] = _bn(b["down_bn"], device)
        return out

    r, asp = params["resnet"], params["asp"]
    return {
        "resnet": {"stem_conv": c2(r["stem_conv"]), "stem_bn": _bn(r["stem_bn"], device),
                   "stages": [[block(b) for b in stage] for stage in r["stages"]]},
        "asp": {"att1_w": _f32(asp["att1_w"], device), "att1_b": _f32(asp["att1_b"], device),
                "att_bn": _bn(asp["att_bn"], device), "att2_w": _f32(asp["att2_w"], device),
                "att2_b": _f32(asp["att2_b"], device)},
        "bottleneck_w": _f32(params["bottleneck_w"], device),
        "bottleneck_b": _f32(params["bottleneck_b"], device),
    }


def convert_ecapa_params(params: dict, device="cpu") -> dict:
    """JAX ECAPA-TDNN params (numpy leaves, zonos_tpu/models/speaker/ecapa.py)
    -> the port's: conv ``[K, C_in, C_out]`` (NLC) -> torch ``[C_out, C_in,
    K]`` (NCL), the squeeze-excitation's ``[1, C_in, C_out]`` likewise."""

    def c1(w):
        return _f32(np.transpose(np.asarray(w, np.float32), (2, 1, 0)), device)

    def conv(p):
        return {"w": c1(p["w"]), "b": _f32(p["b"], device)}

    def block(p):
        se = p["se"]
        return {
            "conv1": conv(p["conv1"]), "bn1": _bn(p["bn1"], device),
            "convs": [conv(c) for c in p["convs"]], "bns": [_bn(b, device) for b in p["bns"]],
            "conv3": conv(p["conv3"]), "bn3": _bn(p["bn3"], device),
            "se": {"w1": c1(se["w1"]), "b1": _f32(se["b1"], device),
                   "w2": c1(se["w2"]), "b2": _f32(se["b2"], device)},
        }

    out = {k: conv(params[k]) for k in ("conv1", "layer4", "att1", "att2")}
    out.update({k: block(params[k]) for k in ("layer1", "layer2", "layer3")})
    out.update({k: _bn(params[k], device) for k in ("bn1", "att_bn", "bn5", "bn6")})
    out["fc6_w"] = _f32(params["fc6_w"], device)
    out["fc6_b"] = _f32(params["fc6_b"], device)
    return out
