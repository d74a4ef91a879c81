"""zonos_tpu_torch — the PyTorch/CUDA port of zonos_tpu for NVIDIA Hopper.

The JAX package ``zonos_tpu`` is the reference; this package imports
nothing from it (nor JAX).  Module names mirror the JAX package's.  Plain
tensor code is PyTorch; the kernels the JAX package wrote in Pallas are
hand-written CUDA C++ under ``csrc/``, each beside a plain PyTorch version
(``kernels/``).  Entry points run on the card unless the caller passes
``device="cpu"``::

    from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT  # or HYBRID_CONFIG_DICT
    model = Zonos(ZonosConfig.from_dict(TRANSFORMER_CONFIG_DICT))
    codes = model.generate(model.prepare_conditioning(make_cond_dict(text="Hello!")))
    DACAutoencoder().save_codes(["out.wav"], codes)

or, with the reference checkpoints under ``$ZONOS_TPU_MODELS_DIR`` (default
``./models/<repo_id>/``; nothing is downloaded), the README's quick start::

    model = Zonos.from_pretrained("Zyphra/Zonos-v0.1-transformer")
    wav, sr = load_audio("voice.wav")
    speaker = model.make_speaker_embedding(wav, sr)
    prefix = model.prepare_conditioning(make_cond_dict(text="Hello!", speaker=speaker))
    model.autoencoder.save_codes(["out.wav"], model.generate(prefix))

Training on one device: ``zonos_tpu_torch.parallel`` (the loss, the step
functions, the optimizers, LoRA), ``zonos_tpu_torch.data`` (datasets, the
DAC-code cache, the loader) and ``python -m zonos_tpu_torch.apps.train_cli``.
"""

import torch as _torch

# PyTorch's CPU exp goes to MKL's vector math.  The first call in a process,
# when it is split over several threads, can return some threads' share at
# ~1e-4 relative error, and every later call is exact (seen with PyTorch
# 2.13.0's CPU build and MKL 2024.2: 8 of 30 fresh processes on an 8-core CPU;
# one small call on one thread first: 0 of 30).  This small call makes the
# plain versions give the same bits from the first call on.  Drop it once
# tests/test_torch_port_plans.py records no mismatch without it.
_torch.exp(_torch.zeros(4))

from zonos_tpu_torch.conditioning import make_cond_dict, supported_language_codes  # noqa: E402
from zonos_tpu_torch.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig  # noqa: E402
from zonos_tpu_torch.audio import load_audio  # noqa: E402
from zonos_tpu_torch.models.dac import DACAutoencoder  # noqa: E402
from zonos_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingLDA  # noqa: E402
from zonos_tpu_torch.models.tts import Zonos  # noqa: E402
from zonos_tpu_torch.speaker_db import SpeakerUtils  # noqa: E402
from zonos_tpu_torch.utils.checkpoint import (  # noqa: E402
    export_zonos_checkpoint,
    load_zonos_checkpoint,
)

__all__ = [
    "BackboneConfig",
    "DACAutoencoder",
    "PrefixConditionerConfig",
    "SpeakerEmbedding",
    "SpeakerEmbeddingLDA",
    "SpeakerUtils",
    "ZonosConfig",
    "Zonos",
    "export_zonos_checkpoint",
    "load_audio",
    "load_zonos_checkpoint",
    "make_cond_dict",
    "supported_language_codes",
]
