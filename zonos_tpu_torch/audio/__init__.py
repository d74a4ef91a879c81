"""Host-side audio: WAV I/O, resampling, loudness, silence trimming, fades.

numpy/scipy only; a copy of the JAX package's host audio layer so the port
imports nothing from it.
"""

from zonos_tpu_torch.audio.io import load_audio, resample, save_audio
from zonos_tpu_torch.audio.loudness import integrated_loudness, normalize_loudness
from zonos_tpu_torch.audio.process import fade_in_out, trim_silence

__all__ = [
    "load_audio",
    "save_audio",
    "resample",
    "integrated_loudness",
    "normalize_loudness",
    "trim_silence",
    "fade_in_out",
]
