"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is present;
they run on the CPU only when the caller asks for it (``device="cpu"``, as
the tests do).  Nothing falls back silently.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN runs fp32 convolutions in TF32 unless told not to: inside this
    context it runs them in fp32; every other cuDNN setting, and the flags
    after it, are as they were.  Also a decorator (``@fp32_convolutions()``)."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                 deterministic=c.deterministic, allow_tf32=False):
        yield
