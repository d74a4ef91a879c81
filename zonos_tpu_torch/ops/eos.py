"""EOS choreography as tensor functions with no host sync
(zonos_tpu/ops/eos.py):

1. when codebook 0 first samples EOS, the sample enters EOS mode, the frame
   is resampled once with EOS banned, and a 6-step silence window begins
   during which EOS stays banned;
2. in EOS mode the repetition penalty is off for that sample;
3. once EOS fires the sample has 9 steps left and EOS walks down the
   codebook staircase: codebooks below the staircase index emit the mask
   token, the staircase codebook emits EOS.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EosState(NamedTuple):
    remaining: torch.Tensor  # [B] int32 steps left
    stopping: torch.Tensor  # [B] bool: EOS fired, staircase active
    eos_mode: torch.Tensor  # [B] bool: first EOS seen
    steps_after_eos: torch.Tensor  # [B] int32 silence-window countdown

    @classmethod
    def init(cls, batch: int, max_steps: int, window: int, device="cpu"):
        return cls(
            remaining=torch.full((batch,), max_steps, dtype=torch.int32, device=device),
            stopping=torch.zeros((batch,), dtype=torch.bool, device=device),
            eos_mode=torch.zeros((batch,), dtype=torch.bool, device=device),
            steps_after_eos=torch.full((batch,), window, dtype=torch.int32, device=device),
        )


def eos_logit_mask(state: EosState, logits: torch.Tensor, eos_id: int):
    """Pre-sampling: ban EOS in codebook 0 while the silence window runs.
    Returns new logits (the input is not modified) and the new state."""
    eos_active = state.eos_mode & (state.steps_after_eos > 0)
    logits = logits.clone()
    logits[:, 0, eos_id] = torch.where(
        eos_active, torch.full_like(logits[:, 0, eos_id], float("-inf")), logits[:, 0, eos_id]
    )
    return logits, state._replace(
        steps_after_eos=state.steps_after_eos - eos_active.to(torch.int32)
    )


def eos_update(
    state: EosState,
    token: torch.Tensor,  # [B, K] sampled frame
    resampled: torch.Tensor,  # [B, K] frame sampled with EOS banned
    eos_id: int,
    mask_id: int,
    n_codebooks: int,
    silence_window: int,
):
    """Post-sampling: first-EOS resample substitution, remaining-step
    clamping and staircase placement.  Returns the final frame and state."""
    new_eos = (token[:, 0] == eos_id) & (~state.eos_mode)
    token = torch.where(new_eos[:, None], resampled, token)
    eos_mode = state.eos_mode | new_eos
    steps_after_eos = torch.where(
        new_eos, torch.full_like(state.steps_after_eos, silence_window), state.steps_after_eos
    )

    eos_in_cb0 = token[:, 0] == eos_id  # false for freshly resampled samples
    remaining = torch.where(
        eos_in_cb0, torch.clamp(state.remaining, max=n_codebooks), state.remaining
    )
    stopping = state.stopping | eos_in_cb0

    idx = torch.clamp(n_codebooks - remaining, 0, n_codebooks - 1)  # [B]
    cb = torch.arange(n_codebooks, device=token.device)[None, :]
    token = torch.where(stopping[:, None] & (cb < idx[:, None]),
                        torch.full_like(token, mask_id), token)
    token = torch.where(stopping[:, None] & (cb == idx[:, None]),
                        torch.full_like(token, eos_id), token)

    return token, EosState(
        remaining=remaining - 1,
        stopping=stopping,
        eos_mode=eos_mode,
        steps_after_eos=steps_after_eos,
    )
