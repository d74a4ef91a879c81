"""DAC autoencoder, decode side: codes -> 44.1 kHz waveform -> wav files
(zonos_tpu/models/dac/__init__.py).  Weights are a random init from a
``torch.Generator`` or come from :func:`zonos_tpu_torch.convert.convert_dac_params`."""

from __future__ import annotations

import logging

import numpy as np
import torch

from zonos_tpu_torch.audio import fade_in_out, normalize_loudness, save_audio, trim_silence
from zonos_tpu_torch.models.dac.codec import (
    DACConfig,
    dac_decode,
    decoder_receptive_field_frames,
    init_dac_params,
)
from zonos_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("zonos_tpu_torch.dac")


class DACAutoencoder:
    """44.1 kHz DAC decoder wrapper (fp32).  ``device`` defaults to ``"cuda"``
    and raises when there is no card."""

    def __init__(self, params: dict | None = None, cfg: DACConfig | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or DACConfig()
        self.device = resolve_device(device)
        self.codebook_size = self.cfg.codebook_size
        self.num_codebooks = self.cfg.n_codebooks
        self.sampling_rate = self.cfg.sampling_rate
        self.hop = self.cfg.hop_length
        self.receptive_field_frames = decoder_receptive_field_frames(self.cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_dac_params(self.cfg, gen, self.device)
        self.params = params

    @torch.inference_mode()
    def decode(self, codes) -> np.ndarray:
        """codes [B, K, T] -> wav [B, 1, samples] float32."""
        codes = torch.as_tensor(np.asarray(codes), dtype=torch.int64, device=self.device)
        if codes.shape[1] != self.num_codebooks:
            raise ValueError(f"expected {self.num_codebooks} codebooks, got {codes.shape[1]}")
        wav = dac_decode(self.params, self.cfg, codes)  # [B, samples, 1]
        return wav.transpose(1, 2).cpu().numpy()

    def codes_to_wavs(self, codes) -> list[np.ndarray]:
        """Decode + normalize to -23 LUFS + trim + fade, per sample."""
        if isinstance(codes, (list, tuple)):
            code_list = [np.asarray(c)[None] if np.asarray(c).ndim == 2 else np.asarray(c)
                         for c in codes]
        else:
            codes = np.asarray(codes)
            code_list = [codes[None]] if codes.ndim == 2 else [codes[i:i + 1] for i in range(codes.shape[0])]
        results = []
        for c in code_list:
            if c.shape[2] == 0:
                logger.warning("empty code sequence, skipping decode")
                continue
            wav = self.decode(c)[0]  # [1, samples]
            wav = normalize_loudness(wav, self.sampling_rate, -23.0)
            wav = trim_silence(wav)
            results.append(fade_in_out(wav))
        return results

    def save_codes(self, paths, codes) -> None:
        if isinstance(paths, str):
            paths = [paths]
        wavs = self.codes_to_wavs(codes)
        if len(paths) != len(wavs):
            raise ValueError(f"{len(paths)} paths != {len(wavs)} wavs")
        for p, w in zip(paths, wavs):
            save_audio(p, w, self.sampling_rate)
