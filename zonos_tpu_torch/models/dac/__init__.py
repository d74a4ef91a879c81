"""DAC autoencoder: a wav file or waveform -> codes (the audio prefix of a
voice continuation), and codes -> 44.1 kHz waveform -> wav files
(zonos_tpu/models/dac/__init__.py).  Weights come from ``params``, else
from ``descript/dac_44khz/model.safetensors`` in the local models directory
(``utils/hub.py``; HF ``DacModel`` naming, ``models/dac/convert.py``), else,
with a warning, from a random init drawn from a ``torch.Generator``."""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from zonos_tpu_torch.audio import (
    fade_in_out,
    load_audio,
    normalize_loudness,
    resample,
    save_audio,
    trim_silence,
)
from zonos_tpu_torch.audio.io import to_mono
from zonos_tpu_torch.models.dac.codec import (
    DACConfig,
    dac_decode,
    dac_encode,
    decoder_receptive_field_frames,
    init_dac_params,
)
from zonos_tpu_torch.models.dac.convert import convert_dac_state_dict
from zonos_tpu_torch.utils.checkpoint import load_safetensors
from zonos_tpu_torch.utils.device import resolve_device
from zonos_tpu_torch.utils.hub import hub_download

logger = logging.getLogger("zonos_tpu_torch.dac")


class DACAutoencoder:
    """44.1 kHz DAC codec wrapper (fp32).  ``device`` defaults to ``"cuda"``
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
            params = self._load_params(seed)
        self.params = params

    def _load_params(self, seed: int) -> dict:
        try:
            path = hub_download("descript/dac_44khz", "model.safetensors")
        except FileNotFoundError:
            logger.warning("DAC checkpoint not found locally; using random codec weights "
                           "(decoded audio is noise until a checkpoint is provided)")
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return init_dac_params(self.cfg, gen, self.device)
        return convert_dac_state_dict(load_safetensors(path), self.cfg, self.device)

    def preprocess(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Resample to 44.1 kHz and left-pad with zeros to a multiple of the
        hop (zonos_tpu/models/dac/__init__.py:76-82)."""
        wav = resample(np.asarray(wav, np.float32), sr, self.sampling_rate)
        left_pad = math.ceil(wav.shape[-1] / self.hop) * self.hop - wav.shape[-1]
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(left_pad, 0)])

    @torch.inference_mode()
    def encode(self, wav) -> np.ndarray:
        """wav [B, 1, T] float32, T a multiple of the hop -> codes [B, K,
        T/512] int64."""
        x = torch.as_tensor(np.asarray(wav, np.float32), device=self.device).transpose(1, 2)
        return dac_encode(self.params, self.cfg, x.contiguous()).cpu().numpy()

    def load_prefix_audio(self, audio_path: str) -> np.ndarray:
        """Read a wav file, average it to mono, ``preprocess`` and ``encode``
        it: codes [1, K, T] for ``Zonos.generate(audio_prefix_codes=...)``."""
        wav, sr = load_audio(audio_path)
        return self.encode(self.preprocess(to_mono(wav), sr)[None])

    @torch.inference_mode()
    def decode(self, codes) -> np.ndarray:
        """codes [B, K, T] -> wav [B, 1, samples] float32."""
        codes = torch.as_tensor(np.asarray(codes), dtype=torch.int64, device=self.device)
        if codes.shape[1] != self.num_codebooks:
            raise ValueError(f"expected {self.num_codebooks} codebooks, got {codes.shape[1]}")
        wav = dac_decode(self.params, self.cfg, codes)  # [B, samples, 1]
        return wav.transpose(1, 2).cpu().numpy()

    # -- post-processing (zonos_tpu/models/dac/__init__.py:106-110) -----
    def trim_silence(self, wav: np.ndarray, threshold: float = 1e-5,
                     frame_size: int = 512) -> np.ndarray:
        return trim_silence(wav, threshold, frame_size)

    def normalize_loudness(self, audio: np.ndarray, sr: int,
                           target_lufs: float = -19.0) -> np.ndarray:
        return normalize_loudness(audio, sr, target_lufs)

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
            wav = self.normalize_loudness(wav, self.sampling_rate, -23.0)
            wav = self.trim_silence(wav)
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

    # -- quality scoring -------------------------------------------------
    _predictor = None

    def quality_string(self, aesthetics: dict[str, float]) -> str:
        return " ".join(f"{k}={v:.1f}" for k, v in aesthetics.items())

    def audio_quality(self, wavs, sr, qualities=("CU", "CE", "PQ", "AQ"),
                      average_overall=True):
        """Audiobox-aesthetics scores where that package is installed
        (zonos_tpu/models/dac/__init__.py:150-184); otherwise a
        self-contained spectral proxy (:func:`_spectral_quality_proxy`), so
        best-of-N selection still works offline.  ``AQ`` is the mean of the
        other scores asked for (of CU, CE and PQ if none is)."""
        if not isinstance(wavs, list):
            wavs = [wavs]
        qualities = list(qualities)
        base = [q for q in qualities if q != "AQ"] or ["CU", "CE", "PQ"]

        if DACAutoencoder._predictor is None:
            try:
                from audiobox_aesthetics.infer import initialize_predictor  # type: ignore

                DACAutoencoder._predictor = initialize_predictor()
            except Exception:  # not installed, or its weights cannot be had offline
                DACAutoencoder._predictor = False
        if DACAutoencoder._predictor:
            raw = DACAutoencoder._predictor.forward(
                [{"path": w, "sample_rate": sr} for w in wavs])
            scores = [{q: r[q] for q in base} for r in raw]
        else:
            scores = [{q: _spectral_quality_proxy(np.asarray(w), sr) for q in base} for w in wavs]

        for s in scores:
            if "AQ" in qualities:
                s["AQ"] = sum(s[q] for q in base) / len(base)
        if average_overall:
            keys = scores[0].keys()
            return {k: sum(s[k] for s in scores) / len(scores) for k in keys}
        return scores

    def best_per_chunk(self, wavs: list, sr, n: int = -1) -> list:
        """The best wav (by AQ) of each chunk of ``n`` (all: -1)."""
        n = len(wavs) if n == -1 or n > len(wavs) else n
        per = self.audio_quality(wavs, sr, qualities=["AQ"], average_overall=False)
        best = []
        for i in range(0, len(wavs), n):
            group = per[i:i + n]
            j = max(range(len(group)), key=lambda j: group[j]["AQ"])
            best.append(wavs[i + j])
        return best


def _spectral_quality_proxy(wav: np.ndarray, sr: int) -> float:
    """A cheap 1-10 quality proxy: it penalizes clipping, DC offset, very low
    energy and the spectral flatness of noise.  Not a perceptual model: a
    deterministic stand-in so that offline best-of-N ranking is stable."""
    x = wav.reshape(-1).astype(np.float64)
    if x.size == 0:
        return 0.0
    rms = np.sqrt((x**2).mean())
    clip_frac = (np.abs(x) > 0.985).mean()
    dc = abs(x.mean())
    spec = np.abs(np.fft.rfft(x[: min(x.size, sr)]))[1:]
    spec = spec / max(spec.sum(), 1e-12)
    ent = -(spec * np.log(spec + 1e-12)).sum() / np.log(spec.size)  # 1 = flat / noise
    score = 8.0
    score -= 6.0 * ent
    score -= 20.0 * clip_frac
    score -= 10.0 * dc
    score += 2.0 * min(rms * 10, 1.0)
    return float(np.clip(score, 0.0, 10.0))
