"""ECAPA-TDNN, the alternative speaker tower (counterpart of
zonos_tpu/models/speaker/ecapa.py; zonos/speaker_cloning.py:226-352):
Res2Net-style Bottle2neck blocks of dilated 1-D convs with
squeeze-excitation, multi-layer feature aggregation, attentive statistics
pooling with global context, and a 192-d embedding.

Activations are NCL (channels, then frames); conv weights torch's
``[C_out, C_in, K]``; BatchNorm is a folded ``{scale, shift}``.  fp32, with
the convolutions in fp32 (``fp32_convolutions``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from zonos_tpu_torch.models.speaker.resnet import batch_norm
from zonos_tpu_torch.utils.device import fp32_convolutions


def conv1d(x: torch.Tensor, p: dict, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv1d(x, p["w"], p["b"], padding=padding, dilation=dilation)


def se_module(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excitation over time."""
    s = x.mean(dim=2, keepdim=True)  # [B, C, 1]
    s = F.relu(F.conv1d(s, p["w1"], p["b1"]))
    return x * torch.sigmoid(F.conv1d(s, p["w2"], p["b2"]))


def bottle2neck(p: dict, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    """Res2Net block with hierarchical dilated convs."""
    out = batch_norm(F.relu(conv1d(x, p["conv1"])), p["bn1"])
    width = out.shape[1] // scale
    splits = torch.split(out, width, dim=1)
    pad = (p["convs"][0]["w"].shape[-1] // 2) * dilation
    pieces = []
    sp = None
    for i in range(scale - 1):
        sp = splits[i] if sp is None else sp + splits[i]
        sp = batch_norm(F.relu(conv1d(sp, p["convs"][i], dilation, pad)), p["bns"][i])
        pieces.append(sp)
    pieces.append(splits[scale - 1])
    out = batch_norm(F.relu(conv1d(torch.cat(pieces, dim=1), p["conv3"])), p["bn3"])
    return se_module(p["se"], out) + x


def ecapa_forward(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, 80, T] fp32 -> embedding [B, 192]."""
    with fp32_convolutions():
        x = batch_norm(F.relu(conv1d(mel, params["conv1"], padding=2)), params["bn1"])
        x1 = bottle2neck(params["layer1"], x, scale=8, dilation=2)
        x2 = bottle2neck(params["layer2"], x + x1, scale=8, dilation=3)
        x3 = bottle2neck(params["layer3"], x + x1 + x2, scale=8, dilation=4)
        x = F.relu(conv1d(torch.cat([x1, x2, x3], dim=1), params["layer4"]))  # [B, 1536, T]

        mu_g = x.mean(dim=2, keepdim=True).expand_as(x)
        sg_g = x.var(dim=2, keepdim=True, correction=0).clamp_min(1e-4).sqrt().expand_as(x)
        a = F.relu(conv1d(torch.cat([x, mu_g, sg_g], dim=1), params["att1"]))
        a = conv1d(torch.tanh(batch_norm(a, params["att_bn"])), params["att2"])
    w = torch.softmax(a, dim=2)  # over time
    mu = (x * w).sum(dim=2)
    sg = ((x.square() * w).sum(dim=2) - mu.square()).clamp_min(1e-4).sqrt()
    stats = batch_norm(torch.cat([mu, sg], dim=-1), params["bn5"], dim=-1)
    return batch_norm(stats @ params["fc6_w"] + params["fc6_b"], params["bn6"], dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_ecapa_params(generator: torch.Generator, C: int = 1024, device="cpu") -> dict:
    """N(0, 1/fan_in) convs, zero biases, identity BatchNorm; ``generator``
    lives on ``device``."""

    def randn(shape, fan):
        return torch.randn(shape, generator=generator, device=device) / math.sqrt(fan)

    def conv(k, cin, cout):
        return {"w": randn((cout, cin, k), k * cin), "b": torch.zeros(cout, device=device)}

    def bn(c):
        return {"scale": torch.ones(c, device=device), "shift": torch.zeros(c, device=device)}

    def block(scale=8, kernel=3):
        width = C // scale
        return {
            "conv1": conv(1, C, width * scale), "bn1": bn(width * scale),
            "convs": [conv(kernel, width, width) for _ in range(scale - 1)],
            "bns": [bn(width) for _ in range(scale - 1)],
            "conv3": conv(1, width * scale, C), "bn3": bn(C),
            "se": {"w1": randn((128, C, 1), C), "b1": torch.zeros(128, device=device),
                   "w2": randn((C, 128, 1), 128), "b2": torch.zeros(C, device=device)},
        }

    return {
        "conv1": conv(5, 80, C), "bn1": bn(C),
        "layer1": block(), "layer2": block(), "layer3": block(),
        "layer4": conv(1, 3 * C, 1536),
        "att1": conv(1, 4608, 256), "att_bn": bn(256), "att2": conv(1, 256, 1536),
        "bn5": bn(3072),
        "fc6_w": randn((3072, 192), 3072), "fc6_b": torch.zeros(192, device=device),
        "bn6": bn(192),
    }
