"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is present;
they run on the CPU only when the caller asks for it (``device="cpu"``, as
the tests do).  Nothing falls back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
