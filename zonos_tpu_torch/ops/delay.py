"""Delay codebook pattern: codebook ``k`` is staggered by ``k+1`` steps
(zonos_tpu/ops/delay.py).  Codes are ``[batch, n_codebooks, time]``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def apply_delay_pattern(codes: torch.Tensor, mask_token: int) -> torch.Tensor:
    """``[B, K, T]`` -> ``[B, K, T+K]`` with ``out[:, k, t] = codes[:, k, t-(k+1)]``
    and the mask token before the start and past the end."""
    K = codes.shape[1]
    padded = F.pad(codes, (0, K), value=mask_token)
    rows = [torch.roll(padded[:, k], k + 1, dims=-1) for k in range(K)]
    return torch.stack(rows, dim=1)


def revert_delay_pattern(codes):
    """Inverse of :func:`apply_delay_pattern`: ``[B, K, S]`` -> ``[B, K, S-K]``
    with ``out[:, k, t] = codes[:, k, t+k+1]``.  Takes numpy or torch."""
    _, K, S = codes.shape
    rows = [codes[:, k, k + 1 : S - K + k + 1] for k in range(K)]
    if isinstance(codes, np.ndarray):
        return np.stack(rows, axis=1)
    return torch.stack(rows, dim=1)
