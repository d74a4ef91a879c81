"""Conditioning: prefix conditioners and the user-facing cond dict
(zonos_tpu/conditioning.py:46-304).

Four conditioner types (Espeak phoneme embedding, Fourier feature, Integer
embedding, Passthrough), each with an optional linear/MLP projection and a
learned unconditional vector; the prefix conditioner concatenates their
outputs on the sequence axis and applies a shared projection + LayerNorm.
Strings become arrays on the host in :func:`prepare_cond_inputs`;
:func:`prefix_conditioner_forward` takes only arrays.  Parameters are a dict
keyed by conditioner name, in the JAX package's layout.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from zonos_tpu_torch.config import PrefixConditionerConfig
from zonos_tpu_torch.ops.norms import layer_norm
from zonos_tpu_torch.text import phonemize, tokenize_phonemes
from zonos_tpu_torch.text.symbols import PAD_ID, SYMBOL_VOCAB_SIZE


@dataclass(frozen=True)
class ConditionerSpec:
    type: str  # Espeak | Fourier | Integer | Passthrough
    name: str
    cond_dim: int
    projection: str  # none | linear | mlp
    uncond: bool
    input_dim: int = 1
    min_val: float = 0.0
    max_val: float = 1.0
    int_min: int = 0
    int_max: int = 512
    fourier_std: float = 1.0


def build_specs(config: PrefixConditionerConfig, output_dim: int) -> tuple[ConditionerSpec, ...]:
    specs = []
    for raw in config.conditioners:
        c = dict(raw)
        ctype = c.pop("type").replace("Conditioner", "").replace("EspeakPhoneme", "Espeak")
        name = c.pop("name")
        specs.append(
            ConditionerSpec(
                type=ctype,
                name=name,
                cond_dim=int(c.get("cond_dim", output_dim)),
                projection=c.get("projection", "none"),
                uncond=c.get("uncond_type", "none") == "learned",
                input_dim=int(c.get("input_dim", 1)),
                min_val=float(c.get("min_val", 0.0)),
                max_val=float(c.get("max_val", 1.0)),
                int_min=int(c.get("min_val", 0)),
                int_max=int(c.get("max_val", 512)),
                fourier_std=float(c.get("std", 1.0)),
            )
        )
    return tuple(specs)


def required_keys(specs: tuple[ConditionerSpec, ...]) -> set[str]:
    """Conditioners without a learned uncond vector must always be supplied."""
    return {s.name for s in specs if not s.uncond}


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _randn(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def _init_projection(gen, spec: ConditionerSpec, out_dim: int, dtype, device) -> dict:
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    if spec.projection == "linear":
        return {
            "w": (_randn((spec.cond_dim, out_dim), gen, device) / math.sqrt(spec.cond_dim)).to(dtype),
            "b": zeros((out_dim,)),
        }
    if spec.projection == "mlp":
        return {
            "w1": (_randn((spec.cond_dim, out_dim), gen, device) / math.sqrt(spec.cond_dim)).to(dtype),
            "b1": zeros((out_dim,)),
            "w2": (_randn((out_dim, out_dim), gen, device) / math.sqrt(out_dim)).to(dtype),
            "b2": zeros((out_dim,)),
        }
    return {}


def init_conditioner_params(gen: torch.Generator, spec: ConditionerSpec, out_dim: int,
                            dtype=torch.bfloat16, device="cpu") -> dict:
    p: dict = {"project": _init_projection(gen, spec, out_dim, dtype, device)}
    if spec.uncond:
        p["uncond_vector"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    if spec.type == "Espeak":
        p["embed"] = (_randn((SYMBOL_VOCAB_SIZE, out_dim), gen, device) * 0.02).to(dtype)
    elif spec.type == "Fourier":
        # random-feature matrix [out_dim/2, input_dim], kept in fp32
        p["weight"] = _randn((out_dim // 2, spec.input_dim), gen, device) * spec.fourier_std
    elif spec.type == "Integer":
        n = spec.int_max - spec.int_min + 1
        p["embed"] = (_randn((n, out_dim), gen, device) * 0.02).to(dtype)
    return p


def init_prefix_conditioner_params(gen: torch.Generator, config: PrefixConditionerConfig,
                                   out_dim: int, dtype=torch.bfloat16, device="cpu") -> dict:
    specs = build_specs(config, out_dim)
    params = {s.name: init_conditioner_params(gen, s, out_dim, dtype, device) for s in specs}
    params["_norm"] = {"scale": torch.ones((out_dim,), dtype=dtype, device=device),
                       "bias": torch.zeros((out_dim,), dtype=dtype, device=device)}
    top = ConditionerSpec("Passthrough", "prefix", out_dim, config.projection, False)
    params["_project"] = _init_projection(gen, top, out_dim, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype (JAX promotes mixed fp32/bf16 operands)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _project(p: dict, projection: str, x: torch.Tensor) -> torch.Tensor:
    if projection == "linear":
        return _mm(x, p["w"]) + p["b"]
    if projection == "mlp":
        h = F.silu(_mm(x, p["w1"]) + p["b1"])
        return _mm(h, p["w2"]) + p["b2"]
    return x


def _device_of(params: dict) -> torch.device:
    """The device of a conditioner's first tensor, nested dicts included (a
    Passthrough conditioner without an uncond vector holds only its
    projection's)."""
    for t in params.values():
        if isinstance(t, torch.Tensor):
            return t.device
    return next(_device_of(t) for t in params.values() if isinstance(t, dict) and t)


def conditioner_forward(params: dict, spec: ConditionerSpec, value) -> torch.Tensor:
    """One conditioner: raw input array (numpy or tensor) -> [b, seq, out_dim]."""
    if value is None:
        return params["uncond_vector"][None, None, :]
    device = _device_of(params)
    value = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value,
                            device=device)
    if spec.type == "Espeak":
        cond = params["embed"][value.long()]  # [b, T, d]
    elif spec.type == "Fourier":
        x = (value.float() - spec.min_val) / (spec.max_val - spec.min_val)
        f = 2 * math.pi * _mm(x, params["weight"].T)  # [b, s, out/2]; bf16 after a load
        # the reference emits bf16 here even in fp32 runs
        cond = torch.cat([torch.cos(f), torch.sin(f)], dim=-1).to(torch.bfloat16)
    elif spec.type == "Integer":
        cond = params["embed"][value.squeeze(-1).long() - spec.int_min]
    elif spec.type == "Passthrough":
        cond = value
    else:
        raise ValueError(f"unknown conditioner type {spec.type}")
    return _project(params["project"], spec.projection, cond)


def prefix_conditioner_forward(params: dict, specs: tuple[ConditionerSpec, ...],
                               config: PrefixConditionerConfig, inputs: dict,
                               eps: float = 1e-5, uncond_drop: dict | None = None) -> torch.Tensor:
    """Concatenate all conditioner outputs on the sequence axis ->
    [B, cond_len, d].  ``inputs[name]`` is an array or None (=> the learned
    uncond vector).

    ``uncond_drop[name]`` (training only) is a per-row bool mask ``[B]``: rows
    where it is True take the conditioner's learned uncond vector in place of
    its output, classifier-free-guidance dropout
    (zonos_tpu/conditioning.py:161-195).  Only conditioners with an uncond
    vector may be dropped (they emit one sequence position)."""
    conds = []
    for s in specs:
        c = conditioner_forward(params[s.name], s, inputs.get(s.name))
        if uncond_drop is not None and s.name in uncond_drop:
            if not s.uncond:
                raise ValueError(f"conditioner {s.name!r} has no uncond vector to drop to")
            u = params[s.name]["uncond_vector"][None, None, :].to(c.dtype)
            mask = torch.as_tensor(uncond_drop[s.name], device=c.device).reshape(-1, 1, 1)
            c = torch.where(mask, u, c)
        conds.append(c)
    max_b = max(c.shape[0] for c in conds)
    dtype = functools.reduce(torch.promote_types, [c.dtype for c in conds])
    conds = [c.expand(max_b, *c.shape[1:]).to(dtype) for c in conds]
    x = _project(params["_project"], config.projection, torch.cat(conds, dim=-2))
    return layer_norm(x, params["_norm"]["scale"], params["_norm"]["bias"], eps)


# ---------------------------------------------------------------------------
# User-facing cond dict (host side)
# ---------------------------------------------------------------------------

supported_language_codes = [
    'af', 'am', 'an', 'ar', 'as', 'az', 'ba', 'bg', 'bn', 'bpy', 'bs', 'ca', 'cmn',
    'cs', 'cy', 'da', 'de', 'el', 'en-029', 'en-gb', 'en-gb-scotland', 'en-gb-x-gbclan',
    'en-gb-x-gbcwmd', 'en-gb-x-rp', 'en-us', 'eo', 'es', 'es-419', 'et', 'eu', 'fa',
    'fa-latn', 'fi', 'fr-be', 'fr-ch', 'fr-fr', 'ga', 'gd', 'gn', 'grc', 'gu', 'hak',
    'hi', 'hr', 'ht', 'hu', 'hy', 'hyw', 'ia', 'id', 'is', 'it', 'ja', 'jbo', 'ka',
    'kk', 'kl', 'kn', 'ko', 'kok', 'ku', 'ky', 'la', 'lfn', 'lt', 'lv', 'mi', 'mk',
    'ml', 'mr', 'ms', 'mt', 'my', 'nb', 'nci', 'ne', 'nl', 'om', 'or', 'pa', 'pap',
    'pl', 'pt', 'pt-br', 'py', 'quc', 'ro', 'ru', 'ru-lv', 'sd', 'shn', 'si', 'sk',
    'sl', 'sq', 'sr', 'sv', 'sw', 'ta', 'te', 'tn', 'tr', 'tt', 'ur', 'uz', 'vi',
    'vi-vn-x-central', 'vi-vn-x-south', 'yue',
]

LANGUAGE_TO_ID = {lang: i for i, lang in enumerate(supported_language_codes)}


def make_cond_dict(
    text: str | list[str] = "Zonos uses eSpeak for text to phoneme conversion!",
    language: str = "en-us",
    speaker: np.ndarray | None = None,
    emotion: list[float] = (1.0, 0.05, 0.05, 0.05, 0.05, 0.05, 0.1, 0.2),
    fmax: float = 22050.0,
    pitch_std: float = 20.0,
    speaking_rate: float = 15.0,
    vqscore_8: list[float] = (0.78,) * 8,
    ctc_loss: float = 0.0,
    dnsmos_ovrl: float = 4.0,
    speaker_noised: bool = False,
    unconditional_keys=frozenset({"emotion", "vqscore_8", "dnsmos_ovrl"}),
) -> dict:
    """Build the conditioning dict.  Values become numpy arrays of shape
    ``[1, 1, dim]``; the emotion vector is renormalized to sum to 1; keys in
    ``unconditional_keys`` are dropped so their conditioner uses its learned
    uncond vector."""
    if isinstance(text, str):
        text = [text]
    language = language.lower().replace("_", "-")
    if language not in supported_language_codes:
        raise ValueError(f"Language code {language} not supported; pick one of {supported_language_codes}")

    cond: dict = {
        "espeak": (text, [language] * len(text)),
        "speaker": speaker,
        "emotion": list(emotion),
        "fmax": fmax,
        "pitch_std": pitch_std,
        "speaking_rate": speaking_rate,
        "language_id": LANGUAGE_TO_ID[language],
        "vqscore_8": list(vqscore_8),
        "ctc_loss": ctc_loss,
        "dnsmos_ovrl": dnsmos_ovrl,
        "speaker_noised": int(speaker_noised),
    }
    for k in unconditional_keys:
        cond.pop(k, None)

    for k, v in list(cond.items()):
        if isinstance(v, (int, float, list)):
            v = np.asarray(v, dtype=np.float32)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            cond[k] = np.asarray(v, dtype=np.float32).reshape(1, 1, -1)
        if k == "emotion":
            cond[k] = cond[k] / cond[k].sum(axis=-1, keepdims=True)
    return cond


def prepare_cond_inputs(specs: tuple[ConditionerSpec, ...], cond_dict: dict,
                        pad_to_multiple: int = 1) -> dict:
    """Host stage: strings -> arrays.  Returns name -> array-or-None.
    ``pad_to_multiple`` left-pads the phoneme ids with PAD."""
    missing = required_keys(specs) - set(cond_dict)
    if missing:
        raise ValueError(f"Missing required conditioning keys: {missing}")
    inputs: dict = {}
    for spec in specs:
        v = cond_dict.get(spec.name)
        if v is None:
            inputs[spec.name] = None
        elif spec.type == "Espeak":
            texts, languages = v
            ids, _ = tokenize_phonemes(phonemize(list(texts), list(languages)))
            if pad_to_multiple > 1 and ids.shape[1] % pad_to_multiple:
                L = -(-ids.shape[1] // pad_to_multiple) * pad_to_multiple
                padded = np.full((ids.shape[0], L), PAD_ID, ids.dtype)
                padded[:, L - ids.shape[1]:] = ids
                ids = padded
            inputs[spec.name] = ids
        elif spec.type == "Integer":
            inputs[spec.name] = np.asarray(v, dtype=np.int32).reshape(1, 1, -1)
        else:
            inputs[spec.name] = np.asarray(v, dtype=np.float32)
    return inputs
