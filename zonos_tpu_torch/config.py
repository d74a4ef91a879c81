"""Model configuration.

Mirrors the configuration surface of the reference (`zonos/config.py:28-62`):
the same `config.json` files parse into the same logical fields, so real
Zonos-v0.1 checkpoints configure this framework unchanged.  TPU-specific
fields (vocab lane padding, sharding axis names) extend the schema with
defaults that leave reference configs valid.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def find_multiple(n: int, k: int) -> int:
    """Round ``n`` up to the next multiple of ``k`` (ref: zonos/utils.py:7-9)."""
    if k == 0 or n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class BackboneConfig:
    """Decoder backbone hyperparameters (ref: zonos/config.py:28-39).

    ``ssm_cfg`` empty => pure transformer; non-empty => Mamba2 hybrid with
    attention interleaved at ``attn_layer_idx``.
    """

    d_model: int = 1024
    d_intermediate: int = 0
    attn_mlp_d_intermediate: int = 0
    n_layer: int = 16
    ssm_cfg: dict = field(default_factory=dict)
    attn_layer_idx: list = field(default_factory=list)
    attn_cfg: dict = field(default_factory=dict)
    rms_norm: bool = False
    residual_in_fp32: bool = False
    norm_epsilon: float = 1e-5

    # --- derived helpers -------------------------------------------------
    @property
    def is_transformer(self) -> bool:
        return not bool(self.ssm_cfg)

    @property
    def num_heads(self) -> int:
        return int(self.attn_cfg.get("num_heads", 16))

    @property
    def num_heads_kv(self) -> int:
        return int(self.attn_cfg.get("num_heads_kv", self.num_heads))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def rope_base(self) -> float:
        return float(self.attn_cfg.get("rotary_emb_base", 10000.0))

    @property
    def mlp_hidden(self) -> int:
        return self.attn_mlp_d_intermediate or 4 * self.d_model

    # Mamba2 / hybrid hyperparameters (ssm_cfg follows mamba_ssm's schema).
    @property
    def ssm_d_state(self) -> int:
        return int(self.ssm_cfg.get("d_state", 128))

    @property
    def ssm_d_conv(self) -> int:
        return int(self.ssm_cfg.get("d_conv", 4))

    @property
    def ssm_expand(self) -> int:
        return int(self.ssm_cfg.get("expand", 2))

    @property
    def ssm_headdim(self) -> int:
        return int(self.ssm_cfg.get("headdim", 64))

    @property
    def ssm_ngroups(self) -> int:
        return int(self.ssm_cfg.get("ngroups", 1))


@dataclass(frozen=True)
class PrefixConditionerConfig:
    """Conditioning-prefix schema (ref: zonos/config.py:42-45)."""

    conditioners: tuple
    projection: str  # "none" | "linear" | "mlp"

    def __post_init__(self):
        # Accept lists from JSON but store hashable tuples of frozen dicts.
        if isinstance(self.conditioners, list):
            object.__setattr__(self, "conditioners", tuple(self.conditioners))


@dataclass(frozen=True)
class ZonosConfig:
    """Top-level model config (ref: zonos/config.py:48-62).

    ``pad_vocab_to_multiple_of`` keeps checkpoint compatibility with the
    reference (which pads embedding/head vocab to a multiple of 8 after
    load); ``tpu_vocab_pad`` additionally pads the *compute* vocab to a TPU
    lane multiple (128) so head matmuls tile cleanly onto the MXU.
    """

    backbone: BackboneConfig
    prefix_conditioner: PrefixConditionerConfig
    eos_token_id: int = 1024
    masked_token_id: int = 1025
    pad_vocab_to_multiple_of: int = 8
    tpu_vocab_pad: int = 128

    # Token-space constants shared by the whole stack.
    num_codebooks: int = 9
    codebook_size: int = 1024  # raw DAC vocab; +EOS +MASK = 1026 input ids

    @property
    def input_vocab_size(self) -> int:
        # 1024 codes + EOS + MASK (ref embeds 1026 ids, zonos/model.py:36)
        return self.codebook_size + 2

    @property
    def output_vocab_size(self) -> int:
        # heads predict 1024 codes + EOS (ref: zonos/model.py:37)
        return self.codebook_size + 1

    @property
    def padded_vocab_size(self) -> int:
        """Compute-padded vocab for embeddings/heads (MXU-friendly)."""
        pad = max(self.pad_vocab_to_multiple_of, self.tpu_vocab_pad)
        return find_multiple(self.input_vocab_size, pad)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ZonosConfig":
        d = dict(d)
        backbone = BackboneConfig(**d.pop("backbone"))
        cond_raw = d.pop("prefix_conditioner")
        prefix = PrefixConditionerConfig(
            conditioners=tuple(cond_raw["conditioners"]),
            projection=cond_raw["projection"],
        )
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(backbone, prefix, **d)

    @classmethod
    def from_json(cls, path: str) -> "ZonosConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Canonical configs.  Real checkpoints ship their own config.json; these are
# the published Zonos-v0.1 shapes so the framework runs standalone (e.g. with
# random weights) when no checkpoint is on disk.
# ---------------------------------------------------------------------------

TRANSFORMER_CONFIG_DICT: dict[str, Any] = {
    "backbone": {
        "d_model": 2048,
        "d_intermediate": 0,
        "attn_mlp_d_intermediate": 8192,
        "n_layer": 26,
        "ssm_cfg": {},
        "attn_layer_idx": [],
        "attn_cfg": {"num_heads": 16, "num_heads_kv": 4},
        "rms_norm": False,
        "residual_in_fp32": False,
        "norm_epsilon": 1e-5,
    },
    "prefix_conditioner": {
        "conditioners": [
            {"type": "EspeakPhonemeConditioner", "name": "espeak"},
            {
                "type": "PassthroughConditioner",
                "name": "speaker",
                "cond_dim": 128,
                "uncond_type": "learned",
                "projection": "linear",
            },
            {
                "type": "FourierConditioner",
                "name": "emotion",
                "input_dim": 8,
                "uncond_type": "learned",
            },
            {
                "type": "FourierConditioner",
                "name": "fmax",
                "min_val": 0,
                "max_val": 24000,
                "uncond_type": "learned",
            },
            {
                "type": "FourierConditioner",
                "name": "pitch_std",
                "min_val": 0,
                "max_val": 400,
                "uncond_type": "learned",
            },
            {
                "type": "FourierConditioner",
                "name": "speaking_rate",
                "min_val": 0,
                "max_val": 40,
                "uncond_type": "learned",
            },
            {
                "type": "IntegerConditioner",
                "name": "language_id",
                "min_val": -1,
                "max_val": 126,
                "uncond_type": "learned",
            },
        ],
        "projection": "none",
    },
    "eos_token_id": 1024,
    "masked_token_id": 1025,
}

# The hybrid checkpoint's exact dims live in its config.json (read at load
# time and authoritative); this standalone stand-in is sized to the model
# card's 1.6B class (~1.5B here: 44 Mamba2 layers @ d=2048 ≈ 26M each + 4
# GQA+SwiGLU attention layers ≈ 61M each + embeddings/heads) so offline
# benchmarks and random-weight runs exercise flagship-scale compute.
HYBRID_CONFIG_DICT: dict[str, Any] = {
    "backbone": {
        "d_model": 2048,
        "d_intermediate": 0,
        "attn_mlp_d_intermediate": 8192,
        "n_layer": 48,
        "ssm_cfg": {"layer": "Mamba2"},
        "attn_layer_idx": [11, 23, 35, 47],
        "attn_cfg": {"num_heads": 16, "num_heads_kv": 4, "head_dim": 128},
        "rms_norm": True,
        "residual_in_fp32": True,
        "norm_epsilon": 1e-5,
    },
    "prefix_conditioner": TRANSFORMER_CONFIG_DICT["prefix_conditioner"],
    "eos_token_id": 1024,
    "masked_token_id": 1025,
}
