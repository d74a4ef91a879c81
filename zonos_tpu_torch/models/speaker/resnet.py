"""Speaker-verification tower: SimAM ResNet293 with attentive statistics
pooling and a linear bottleneck to a 256-d embedding (counterpart of
zonos_tpu/models/speaker/resnet.py).

Activations are NCHW with the mel bins as H and the frames as W; conv
weights are torch's ``[C_out, C_in, kh, kw]``; BatchNorm is inference-mode,
its running statistics folded into a scale and a shift at load time
(:func:`make_bn`).  The tower is fp32, its convolutions run with TF32 off
(``fp32_convolutions``), and no kernel of the port's own is in it: it is
``F.conv2d`` and plain tensor code, as the JAX package computes it with XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from zonos_tpu_torch.utils.device import fp32_convolutions

RESNET293_BLOCKS = (10, 20, 64, 3)


def batch_norm(x: torch.Tensor, p: dict, dim: int = 1) -> torch.Tensor:
    """Inference BatchNorm along ``dim``: ``p = {scale, shift}``."""
    shape = [1] * x.ndim
    shape[dim] = -1
    return x * p["scale"].reshape(shape) + p["shift"].reshape(shape)


def make_bn(gamma, beta, mean, var, eps: float = 1e-5, device="cpu") -> dict:
    """Fold BatchNorm's statistics into a scale and a shift, in fp32 on the
    host as zonos_tpu/models/speaker/resnet.py:35 folds them."""
    gamma, beta, mean, var = (torch.as_tensor(t).float().cpu() for t in (gamma, beta, mean, var))
    scale = gamma / torch.sqrt(var + eps)
    return {"scale": scale.to(device), "shift": (beta - mean * scale).to(device)}


def simam(x: torch.Tensor, lambda_p: float = 1e-4) -> torch.Tensor:
    """Parameter-free SimAM attention over the spatial dims of [B,C,H,W]."""
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)).square()
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4 * (v + lambda_p)) + 0.5)


def simam_block(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(batch_norm(F.conv2d(x, p["conv1"], stride=stride, padding=1), p["bn1"]))
    out = simam(batch_norm(F.conv2d(out, p["conv2"], padding=1), p["bn2"]))
    if "down_conv" in p:
        x = batch_norm(F.conv2d(x, p["down_conv"], stride=stride), p["down_bn"])
    return F.relu(out + x)


def resnet_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, 1, H=80, W=frames] -> feature map [B, C*8, H/8, W/8]."""
    x = F.relu(batch_norm(F.conv2d(x, params["stem_conv"], padding=1), params["stem_bn"]))
    for stage_idx, stage in enumerate(params["stages"]):
        stride = 1 if stage_idx == 0 else 2
        for i, block in enumerate(stage):
            x = simam_block(block, x, stride if i == 0 else 1)
    return x


def asp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Attentive statistics pooling: x [B, C, H', W] -> [B, 2*C*H'] (the
    weighted mean, then the weighted std).  The feature index is
    ``c*H' + h``, as the JAX package's NHWC flatten gives it."""
    B, C, H, W = x.shape
    feats = x.reshape(B, C * H, W).transpose(1, 2)  # [B, W, C*H]
    h = F.relu(feats @ p["att1_w"] + p["att1_b"])
    h = batch_norm(h, p["att_bn"], dim=-1)
    w = torch.softmax(h @ p["att2_w"] + p["att2_b"], dim=1)  # over time
    mu = (feats * w).sum(dim=1)
    sg = ((feats.square() * w).sum(dim=1) - mu.square()).clamp_min(1e-5).sqrt()
    return torch.cat([mu, sg], dim=-1)


def speaker_embed_forward(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, 80, frames] fp32 -> embedding [B, 256]."""
    with fp32_convolutions():
        fm = resnet_forward(params["resnet"], mel[:, None])
    pooled = asp_forward(params["asp"], fm)
    return pooled @ params["bottleneck_w"] + params["bottleneck_b"]


# ---------------------------------------------------------------------------
# Random init (the checkpoint's shapes; real weights come from convert.py)
# ---------------------------------------------------------------------------


def init_speaker_params(generator: torch.Generator, in_planes: int = 64, embd_dim: int = 256,
                        acoustic_dim: int = 80, blocks=RESNET293_BLOCKS, device="cpu") -> dict:
    """N(0, 1/fan_in) convs and projections, identity BatchNorm, zero
    biases; ``generator`` lives on ``device``."""

    def randn(shape, fan):
        return torch.randn(shape, generator=generator, device=device) / math.sqrt(fan)

    def conv(cin, cout, k):
        return randn((cout, cin, k, k), k * k * cin)

    def bn(c):
        return {"scale": torch.ones(c, device=device), "shift": torch.zeros(c, device=device)}

    stages = []
    cin = in_planes
    for stage_idx, n in enumerate(blocks):
        cout = in_planes * 2**stage_idx
        stage = []
        for b in range(n):
            blk = {"conv1": conv(cin, cout, 3), "bn1": bn(cout),
                   "conv2": conv(cout, cout, 3), "bn2": bn(cout)}
            stride = (1 if stage_idx == 0 else 2) if b == 0 else 1
            if stride != 1 or cin != cout:
                blk["down_conv"] = conv(cin, cout, 1)
                blk["down_bn"] = bn(cout)
            stage.append(blk)
            cin = cout
        stages.append(stage)
    feat = in_planes * 8 * (acoustic_dim // 8)  # C*H' after three stride-2 stages
    return {
        "resnet": {"stem_conv": conv(1, in_planes, 3), "stem_bn": bn(in_planes), "stages": stages},
        "asp": {"att1_w": randn((feat, 128), feat), "att1_b": torch.zeros(128, device=device),
                "att_bn": bn(128), "att2_w": randn((128, feat), 128),
                "att2_b": torch.zeros(feat, device=device)},
        "bottleneck_w": randn((2 * feat, embd_dim), 2 * feat),
        "bottleneck_b": torch.zeros(embd_dim, device=device),
    }
