"""zonos_tpu_torch — the PyTorch/CUDA port of zonos_tpu for NVIDIA Hopper.

The JAX package ``zonos_tpu`` is the reference; this package imports
nothing from it (nor JAX).  Module names mirror the JAX package's.  Plain
tensor code is PyTorch; the kernels the JAX package wrote in Pallas are
hand-written CUDA C++ under ``csrc/``, each beside a plain PyTorch version
(``kernels/``).  Entry points run on the card unless the caller passes
``device="cpu"``::

    from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
    model = Zonos(ZonosConfig.from_dict(TRANSFORMER_CONFIG_DICT))
    codes = model.generate(model.prepare_conditioning(make_cond_dict(text="Hello!")))
    DACAutoencoder().save_codes(["out.wav"], codes)
"""

from zonos_tpu_torch.conditioning import make_cond_dict, supported_language_codes
from zonos_tpu_torch.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig
from zonos_tpu_torch.models.dac import DACAutoencoder
from zonos_tpu_torch.models.tts import Zonos

__all__ = [
    "BackboneConfig",
    "DACAutoencoder",
    "PrefixConditionerConfig",
    "ZonosConfig",
    "Zonos",
    "make_cond_dict",
    "supported_language_codes",
]
