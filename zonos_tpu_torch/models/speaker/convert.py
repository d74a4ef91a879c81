"""The reference speaker checkpoints (torch ``.pt`` state dicts
``ResNet293_SimAM_ASP_base.pt`` and ``ResNet293_SimAM_ASP_base_LDA-128.pt``)
-> the port's tower and LDA parameters (counterpart of
zonos_tpu/models/speaker/convert.py).

The port keeps torch's conv layout, so the tower's convs carry over as they
are; BatchNorm statistics are folded into a scale and a shift; the pooling's
1x1 Conv1d weights ``[out, in, 1]`` and the Linear weights ``[out, in]``
become ``[in, out]`` matrices.  The block counts are read from the keys.
"""

from __future__ import annotations

import re

import torch

from zonos_tpu_torch.models.speaker.resnet import RESNET293_BLOCKS, make_bn

_BLOCK_KEY = re.compile(r"^front\.layer(\d)\.(\d+)\.conv1\.weight$")


def tower_blocks(sd: dict) -> tuple[int, ...]:
    """The blocks of each of the four stages, from the state dict's keys."""
    counts = [0, 0, 0, 0]
    for k in sd:
        if m := _BLOCK_KEY.match(k):
            counts[int(m.group(1)) - 1] = max(counts[int(m.group(1)) - 1], int(m.group(2)) + 1)
    return tuple(counts)


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device, torch.float32)


def _bn(sd: dict, pre: str, device) -> dict:
    return make_bn(sd[pre + ".weight"], sd[pre + ".bias"], sd[pre + ".running_mean"],
                   sd[pre + ".running_var"], device=device)


def convert_speaker_state_dict(sd: dict, device="cpu") -> dict:
    """The tower's state dict (``front.*``, ``pooling.attention.*``,
    ``bottleneck.*``) -> the port's tower parameters on ``device``."""
    stages = []
    for stage_idx, n_blocks in enumerate(tower_blocks(sd)):
        stage = []
        for b in range(n_blocks):
            pre = f"front.layer{stage_idx + 1}.{b}"
            blk = {"conv1": _f32(sd[pre + ".conv1.weight"], device),
                   "bn1": _bn(sd, pre + ".bn1", device),
                   "conv2": _f32(sd[pre + ".conv2.weight"], device),
                   "bn2": _bn(sd, pre + ".bn2", device)}
            if pre + ".downsample.0.weight" in sd:
                blk["down_conv"] = _f32(sd[pre + ".downsample.0.weight"], device)
                blk["down_bn"] = _bn(sd, pre + ".downsample.1", device)
            stage.append(blk)
        stages.append(stage)
    return {
        "resnet": {"stem_conv": _f32(sd["front.conv1.weight"], device),
                   "stem_bn": _bn(sd, "front.bn1", device), "stages": stages},
        "asp": {
            "att1_w": _f32(sd["pooling.attention.0.weight"], device)[:, :, 0].T.contiguous(),
            "att1_b": _f32(sd["pooling.attention.0.bias"], device),
            "att_bn": _bn(sd, "pooling.attention.2", device),
            "att2_w": _f32(sd["pooling.attention.3.weight"], device)[:, :, 0].T.contiguous(),
            "att2_b": _f32(sd["pooling.attention.3.bias"], device),
        },
        "bottleneck_w": _f32(sd["bottleneck.weight"], device).T.contiguous(),
        "bottleneck_b": _f32(sd["bottleneck.bias"], device),
    }


def convert_lda_state_dict(sd: dict, device="cpu") -> dict:
    """The LDA head's ``nn.Linear(256, 128)`` state dict -> ``{w [256, 128], b}``."""
    return {"w": _f32(sd["weight"], device).T.contiguous(), "b": _f32(sd["bias"], device)}


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pt`` state dict, on the host."""
    return torch.load(path, weights_only=True, map_location="cpu")


def random_reference_state_dicts(generator: torch.Generator, in_planes: int = 64,
                                 blocks=RESNET293_BLOCKS, acoustic_dim: int = 80,
                                 embd_dim: int = 256) -> tuple[dict, dict]:
    """A tower and an LDA state dict in the reference's key names and shapes,
    for checks without the real files: every weight, bias and BatchNorm
    affine and mean N(0, 0.1^2), running variances in [0.5, 1.5), from
    ``generator`` (on the host), so the BatchNorm folding is exercised and
    the 97 blocks keep their activations in range."""
    sd: dict[str, torch.Tensor] = {}

    def put(key, *shape):
        sd[key] = torch.randn(shape, generator=generator) * 0.1

    def bn(pre, c):
        for name in ("weight", "bias", "running_mean"):
            put(f"{pre}.{name}", c)
        sd[pre + ".running_var"] = 0.5 + torch.rand((c,), generator=generator)
        sd[pre + ".num_batches_tracked"] = torch.tensor(0)

    put("front.conv1.weight", in_planes, 1, 3, 3)
    bn("front.bn1", in_planes)
    cin = in_planes
    for stage_idx, n in enumerate(blocks):
        cout = in_planes * 2**stage_idx
        for b in range(n):
            pre = f"front.layer{stage_idx + 1}.{b}"
            put(pre + ".conv1.weight", cout, cin, 3, 3)
            bn(pre + ".bn1", cout)
            put(pre + ".conv2.weight", cout, cout, 3, 3)
            bn(pre + ".bn2", cout)
            stride = (1 if stage_idx == 0 else 2) if b == 0 else 1
            if stride != 1 or cin != cout:
                put(pre + ".downsample.0.weight", cout, cin, 1, 1)
                bn(pre + ".downsample.1", cout)
            cin = cout
    feat = in_planes * 8 * (acoustic_dim // 8)
    put("pooling.attention.0.weight", 128, feat, 1)
    put("pooling.attention.0.bias", 128)
    bn("pooling.attention.2", 128)
    put("pooling.attention.3.weight", feat, 128, 1)
    put("pooling.attention.3.bias", feat)
    put("bottleneck.weight", embd_dim, 2 * feat)
    put("bottleneck.bias", embd_dim)
    lda = {"weight": torch.randn((128, embd_dim), generator=generator) * 0.1,
           "bias": torch.randn((128,), generator=generator) * 0.1}
    return sd, lda
