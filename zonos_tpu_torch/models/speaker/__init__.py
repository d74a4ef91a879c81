"""Speaker embedding (the voice-cloning tower), counterpart of
zonos_tpu/models/speaker/__init__.py.

``SpeakerEmbedding``: a clip -> mono -> 16 kHz -> log-mel on the host
(``mel.py``) -> the SimAM ResNet293 tower on the device -> a 256-d
embedding.  ``SpeakerEmbeddingLDA`` adds the 256 -> 128 LDA head the TTS
model's speaker conditioner takes.  Weights come from
``Zyphra/Zonos-v0.1-speaker-embedding`` in the local models directory
(``utils/hub.py``); without the files each part warns and uses a seeded
random init.  ``device`` defaults to ``"cuda"`` and raises without a card.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zonos_tpu_torch.audio.io import resample, to_mono
from zonos_tpu_torch.models.speaker.convert import (
    convert_lda_state_dict,
    convert_speaker_state_dict,
    load_reference_checkpoint,
)
from zonos_tpu_torch.models.speaker.mel import log_mel_features
from zonos_tpu_torch.models.speaker.resnet import init_speaker_params, speaker_embed_forward
from zonos_tpu_torch.utils.device import resolve_device
from zonos_tpu_torch.utils.hub import hub_download

logger = logging.getLogger("zonos_tpu_torch.speaker")

SPEAKER_REPO = "Zyphra/Zonos-v0.1-speaker-embedding"
TOWER_FILE = "ResNet293_SimAM_ASP_base.pt"
LDA_FILE = "ResNet293_SimAM_ASP_base_LDA-128.pt"
SAMPLE_RATE = 16000


class SpeakerEmbedding:
    """A reference clip -> 256-d speaker embedding (fp32 tower)."""

    def __init__(self, params: dict | None = None, device: str | torch.device = "cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.params = params if params is not None else self._load_params(seed)

    def _load_params(self, seed: int) -> dict:
        try:
            path = hub_download(SPEAKER_REPO, TOWER_FILE)
        except FileNotFoundError:
            logger.warning("speaker checkpoint not found; using random tower weights")
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return init_speaker_params(gen, device=self.device)
        return convert_speaker_state_dict(load_reference_checkpoint(path), self.device)

    @staticmethod
    def prepare_input(wav: np.ndarray, sample_rate: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if wav.ndim >= 3:
            raise ValueError(f"wav must be [samples] or [channels, samples], got {wav.shape}")
        return resample(to_mono(wav), sample_rate, SAMPLE_RATE)

    def mel(self, wav: np.ndarray, sample_rate: int) -> torch.Tensor:
        """The tower's input, on the device: log-mel [1, 80, frames]."""
        mel = log_mel_features(self.prepare_input(wav, sample_rate))
        return torch.from_numpy(mel).to(self.device)

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        return speaker_embed_forward(self.params, self.mel(wav, sample_rate)).cpu().numpy()


class SpeakerEmbeddingLDA:
    """The 256-d tower embedding and its 128-d LDA projection (what the TTS
    model consumes)."""

    def __init__(self, params: dict | None = None, lda: dict | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.model = SpeakerEmbedding(params, device, seed)
        self.device = self.model.device
        self.lda = lda if lda is not None else self._load_lda()

    def _load_lda(self) -> dict:
        try:
            path = hub_download(SPEAKER_REPO, LDA_FILE)
        except FileNotFoundError:
            logger.warning("LDA checkpoint not found; using random projection")
            # the JAX package's fallback, drawn the same way
            rng = np.random.default_rng(0)
            w = (rng.standard_normal((256, 128)) / 16).astype(np.float32)
            return {"w": torch.from_numpy(w).to(self.device),
                    "b": torch.zeros(128, device=self.device)}
        return convert_lda_state_dict(load_reference_checkpoint(path), self.device)

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sample_rate: int) -> tuple[np.ndarray, np.ndarray]:
        emb = speaker_embed_forward(self.model.params, self.model.mel(wav, sample_rate))
        lda = emb @ self.lda["w"] + self.lda["b"]
        return emb.cpu().numpy(), lda.cpu().numpy()
