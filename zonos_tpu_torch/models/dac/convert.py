"""The HF ``DacModel`` state dict (``descript/dac_44khz``) <-> the port's DAC
parameters (counterpart of zonos_tpu/models/dac/convert.py).

The port keeps torch's conv layouts (Conv1d ``[C_out, C_in, K]``,
ConvTranspose1d ``[C_in, C_out, K]``), so conversion only folds weight norm,
``w = g * v / ||v||`` over all but axis 0, stored as ``weight_g`` /
``weight_v`` or as ``parametrizations.weight.original0`` / ``original1``,
and flattens the snake alphas ``[1, C, 1]`` to ``[C]``.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.models.dac.codec import DACConfig

_NORM_KEYS = (("weight_g", "weight_v"),
              ("parametrizations.weight.original0", "parametrizations.weight.original1"))


def _conv_weight(sd: dict, prefix: str, device) -> torch.Tensor:
    if prefix + ".weight" in sd:
        return sd[prefix + ".weight"].to(device, torch.float32)
    for g_key, v_key in _NORM_KEYS:
        if f"{prefix}.{g_key}" in sd:
            g = sd[f"{prefix}.{g_key}"].to(device, torch.float32)
            v = sd[f"{prefix}.{v_key}"].to(device, torch.float32)
            norm = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
            return g * v / norm.clamp_min(1e-12)
    raise KeyError(f"no weight found for {prefix}")


def _conv(sd: dict, prefix: str, device) -> dict:
    return {"w": _conv_weight(sd, prefix, device).contiguous(),
            "b": sd[prefix + ".bias"].to(device, torch.float32)}


def _alpha(sd: dict, key: str, device) -> torch.Tensor:
    return sd[key].to(device, torch.float32).reshape(-1)


def _res_unit(sd: dict, prefix: str, device) -> dict:
    return {"alpha1": _alpha(sd, prefix + ".snake1.alpha", device),
            "conv1": _conv(sd, prefix + ".conv1", device),
            "alpha2": _alpha(sd, prefix + ".snake2.alpha", device),
            "conv2": _conv(sd, prefix + ".conv2", device)}


def convert_dac_state_dict(sd: dict, cfg: DACConfig, device="cpu") -> dict:
    """HF ``DacModel`` state dict (tensors) -> the port's DAC parameters on
    ``device``, fp32."""
    enc_blocks = [
        {"res1": _res_unit(sd, f"encoder.block.{i}.res_unit1", device),
         "res2": _res_unit(sd, f"encoder.block.{i}.res_unit2", device),
         "res3": _res_unit(sd, f"encoder.block.{i}.res_unit3", device),
         "alpha": _alpha(sd, f"encoder.block.{i}.snake1.alpha", device),
         "down": _conv(sd, f"encoder.block.{i}.conv1", device)}
        for i in range(len(cfg.downsampling_ratios))
    ]
    dec_blocks = [
        {"alpha": _alpha(sd, f"decoder.block.{i}.snake1.alpha", device),
         "up": _conv(sd, f"decoder.block.{i}.conv_t1", device),
         "res1": _res_unit(sd, f"decoder.block.{i}.res_unit1", device),
         "res2": _res_unit(sd, f"decoder.block.{i}.res_unit2", device),
         "res3": _res_unit(sd, f"decoder.block.{i}.res_unit3", device)}
        for i in range(len(cfg.upsampling_ratios))
    ]
    quantizers = [
        {"in_proj": _conv(sd, f"quantizer.quantizers.{k}.in_proj", device),
         "out_proj": _conv(sd, f"quantizer.quantizers.{k}.out_proj", device),
         "codebook": sd[f"quantizer.quantizers.{k}.codebook.weight"].to(device, torch.float32)}
        for k in range(cfg.n_codebooks)
    ]
    return {
        "encoder": {"conv1": _conv(sd, "encoder.conv1", device), "blocks": enc_blocks,
                    "alpha": _alpha(sd, "encoder.snake1.alpha", device),
                    "conv2": _conv(sd, "encoder.conv2", device)},
        "decoder": {"conv1": _conv(sd, "decoder.conv1", device), "blocks": dec_blocks,
                    "alpha": _alpha(sd, "decoder.snake1.alpha", device),
                    "conv2": _conv(sd, "decoder.conv2", device)},
        "quantizers": quantizers,
    }


def export_dac_state_dict(params: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The port's DAC parameters -> an HF ``DacModel`` state dict on the host
    with every conv under weight norm as ``weight_g`` / ``weight_v``: ``v``
    the weight scaled per axis-0 slice by a factor in [0.5, 2) drawn from
    ``generator`` (on the host), ``g`` the weight's norm, so that folding
    gives the weight back."""
    sd: dict[str, torch.Tensor] = {}

    def conv(prefix: str, p: dict) -> None:
        w = p["w"].float().cpu()
        scale = 0.5 + 1.5 * torch.rand((w.shape[0], 1, 1), generator=generator)
        sd[f"{prefix}.weight_g"] = w.square().sum(dim=(1, 2), keepdim=True).sqrt()
        sd[f"{prefix}.weight_v"] = w * scale
        sd[f"{prefix}.bias"] = p["b"].float().cpu()

    def alpha(key: str, a: torch.Tensor) -> None:
        sd[key] = a.float().cpu().reshape(1, -1, 1)

    def res_unit(prefix: str, p: dict) -> None:
        alpha(prefix + ".snake1.alpha", p["alpha1"])
        conv(prefix + ".conv1", p["conv1"])
        alpha(prefix + ".snake2.alpha", p["alpha2"])
        conv(prefix + ".conv2", p["conv2"])

    for part in ("encoder", "decoder"):
        pp = params[part]
        conv(f"{part}.conv1", pp["conv1"])
        for i, b in enumerate(pp["blocks"]):
            pre = f"{part}.block.{i}"
            for r in (1, 2, 3):
                res_unit(f"{pre}.res_unit{r}", b[f"res{r}"])
            alpha(pre + ".snake1.alpha", b["alpha"])
            if part == "encoder":
                conv(pre + ".conv1", b["down"])
            else:
                conv(pre + ".conv_t1", b["up"])
        alpha(f"{part}.snake1.alpha", pp["alpha"])
        conv(f"{part}.conv2", pp["conv2"])
    for k, q in enumerate(params["quantizers"]):
        pre = f"quantizer.quantizers.{k}"
        conv(pre + ".in_proj", q["in_proj"])
        conv(pre + ".out_proj", q["out_proj"])
        sd[pre + ".codebook.weight"] = q["codebook"].float().cpu()
    return sd
