"""DAC codec (Descript Audio Codec, 44.1 kHz), decode side: RVQ lookup and
the decoder (zonos_tpu/models/dac/codec.py).

Decoder: conv (k=7) -> 4 upsampling blocks (snake -> transposed conv ->
3 dilated snake residual units, strides [8, 8, 4, 2]) -> snake -> conv
(k=7) -> tanh.  Hop = 512 samples = 86.13 frames/s.  fp32 throughout,
activations NWC.  Every residual unit goes through the K5 snake-conv kernel
on the card, at every channel width.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from zonos_tpu_torch.kernels.snake_conv import snake_residual_unit
from zonos_tpu_torch.models.dac.layers import conv1d, conv_transpose1d, snake


@dataclass(frozen=True)
class DACConfig:
    encoder_hidden_size: int = 64
    downsampling_ratios: tuple = (2, 4, 8, 8)
    decoder_hidden_size: int = 1536
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    sampling_rate: int = 44100

    @property
    def hidden_size(self) -> int:
        return self.encoder_hidden_size * 2 ** len(self.downsampling_ratios)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.downsampling_ratios))

    @property
    def upsampling_ratios(self) -> tuple:
        return tuple(reversed(self.downsampling_ratios))


# ---------------------------------------------------------------------------
# Init (decode side)
# ---------------------------------------------------------------------------


def _conv_init(gen, k, cin, cout, device, transposed=False, std=0.02):
    shape = (cin, cout, k) if transposed else (cout, cin, k)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return {"w": w * std, "b": torch.zeros((cout,), dtype=torch.float32, device=device)}


def _res_unit_init(gen, dim, device):
    ones = torch.ones((dim,), dtype=torch.float32, device=device)
    return {
        "alpha1": ones,
        "conv1": _conv_init(gen, 7, dim, dim, device),
        "alpha2": ones.clone(),
        "conv2": _conv_init(gen, 1, dim, dim, device),
    }


def init_dac_params(cfg: DACConfig, generator: torch.Generator, device="cpu") -> dict:
    """Random decoder + quantizer-lookup weights in torch conv layouts."""
    dec_blocks = []
    for i, stride in enumerate(cfg.upsampling_ratios):
        in_dim = cfg.decoder_hidden_size // 2**i
        out_dim = cfg.decoder_hidden_size // 2 ** (i + 1)
        dec_blocks.append({
            "alpha": torch.ones((in_dim,), dtype=torch.float32, device=device),
            "up": _conv_init(generator, 2 * stride, in_dim, out_dim, device, transposed=True),
            "res1": _res_unit_init(generator, out_dim, device),
            "res2": _res_unit_init(generator, out_dim, device),
            "res3": _res_unit_init(generator, out_dim, device),
        })
    final_dim = cfg.decoder_hidden_size // 2 ** len(cfg.upsampling_ratios)
    quantizers = [
        {
            "out_proj": _conv_init(generator, 1, cfg.codebook_dim, cfg.hidden_size, device),
            "codebook": torch.randn((cfg.codebook_size, cfg.codebook_dim), generator=generator,
                                    device=device) * 0.02,
        }
        for _ in range(cfg.n_codebooks)
    ]
    return {
        "decoder": {
            "conv1": _conv_init(generator, 7, cfg.hidden_size, cfg.decoder_hidden_size, device),
            "blocks": dec_blocks,
            "alpha": torch.ones((final_dim,), dtype=torch.float32, device=device),
            "conv2": _conv_init(generator, 7, final_dim, 1, device),
        },
        "quantizers": quantizers,
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _res_unit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """``x + conv1x1(snake(conv_k7_dil(snake(x))))``: K5 on the card."""
    return snake_residual_unit(p, x, dilation)


def rvq_decode(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, K, T] -> quantized latents [B, T, H]."""
    out = 0.0
    for k in range(codes.shape[1]):
        q = params["quantizers"][k]
        z = q["codebook"][codes[:, k]]  # [B, T, 8]
        out = out + conv1d(z, q["out_proj"]["w"], q["out_proj"]["b"])
    return out


def decoder_receptive_field_frames(cfg: DACConfig) -> int:
    """Upper bound on the decoder's receptive half-width, in code frames
    (12 for the 44.1 kHz config); derivation in the JAX package's codec."""
    res_half = sum((7 - 1) * d // 2 for d in (1, 3, 9))  # 39 steps per block
    half = 3 * cfg.hop_length  # decoder conv1
    cur = cfg.hop_length  # audio samples per step at the current resolution
    for stride in cfg.upsampling_ratios:
        half += 2 * cur  # transposed conv k = 2*stride
        cur //= stride
        half += res_half * cur
    half += 3  # final conv2
    return -(-half // cfg.hop_length)


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN runs fp32 convolutions in TF32 unless told not to; the DAC is fp32."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@_fp32_convolutions()
def dac_decode_latents(params: dict, cfg: DACConfig, latents: torch.Tensor) -> torch.Tensor:
    """quantized latents [B, T, H] -> waveform [B, T*512, 1] in [-1, 1]."""
    p = params["decoder"]
    x = conv1d(latents, p["conv1"]["w"], p["conv1"]["b"], padding=3)
    for block, stride in zip(p["blocks"], cfg.upsampling_ratios):
        x = snake(x, block["alpha"])
        x = conv_transpose1d(x, block["up"]["w"], block["up"]["b"], stride=stride,
                             padding=int(np.ceil(stride / 2)))
        x = _res_unit(block["res1"], x, 1)
        x = _res_unit(block["res2"], x, 3)
        x = _res_unit(block["res3"], x, 9)
    x = snake(x, p["alpha"])
    x = conv1d(x, p["conv2"]["w"], p["conv2"]["b"], padding=3)
    return torch.tanh(x)


@_fp32_convolutions()
def dac_decode(params: dict, cfg: DACConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, K, T] -> waveform [B, T*512, 1]."""
    return dac_decode_latents(params, cfg, rvq_decode(params, codes))
