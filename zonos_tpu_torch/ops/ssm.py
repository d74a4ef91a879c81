"""Mamba2 selective state-space (SSD) ops (counterpart of
zonos_tpu/ops/ssm.py:31-254).

- :func:`ssd_chunked`: the prefill over a whole sequence: K6
  (``kernels/ssd.py``) for CUDA tensors it takes (``kernel_takes``: fp32,
  headdim <= 64, d_state <= 128; any batch and ngroups), the plain chunked
  formulation otherwise, as JAX computes any width.
- :func:`ssd_decode_step`: one recurrence step with JAX's algebra, the
  output from the OLD state, ``y = dA (C.s) + (B.C) dt x + D x``; K7
  (``kernels/ssm_state.py``) supplies ``C.s`` and ``B.C`` and writes the new
  state in place in its storage dtype (and an int8 or int4 state's scales)
  where it takes the state's width, its plain version otherwise.
- :func:`causal_conv1d_prefill` / :func:`causal_conv1d_step`: the depthwise
  causal conv and its streaming state (the tail of the padded pre-activation
  input), as plain tensor code: the taps' fp32 products added in tap order,
  rounded once to the input's dtype, then the bias.

Every reduction here has an order fixed by the widths, never by the batch (a
batched library reduction or cuDNN's convolution picks its algorithm by the
whole shape), so a request's rows give the same bits alone and co-batched.

Shapes: x ``[B, L, H, P]``, dt ``[B, L, H]``, A ``[H]`` (negative), B/C
``[B, L, G, N]``, D ``[H]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zonos_tpu_torch.kernels import ssd as ssd_kernel
from zonos_tpu_torch.kernels import ssm_state

__all__ = ["causal_conv1d_prefill", "causal_conv1d_step", "ssd_chunked", "ssd_decode_step"]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, D: torch.Tensor, init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 prefill scan (shapes as ``kernels.ssd.ssd_chunked_plain``):
    K6 where it takes the operands, the plain version otherwise."""
    takes = ssd_kernel.kernel_takes(x, dt, A, Bm, Cm, D, init_state)
    fn = ssd_kernel.ssd_chunked if takes else ssd_kernel.ssd_chunked_plain
    return fn(x, dt, A, Bm, Cm, D, init_state)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, D: torch.Tensor, state: torch.Tensor,
                    scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, P], dt [B, H], A [H], B/C [B, G, N], D [H] fp32; state
    [B, H, P, N] in its storage dtype (int4: [B, H, P, N/2] packed), updated
    in place, and for an int8 or int4 state its ``scale`` [B, H, 1, 1] fp32,
    updated in place too.  Returns (y [B, H, P] fp32, state)."""
    Bsz, H, P = x.shape
    Bh = Bm.repeat_interleave(H // Bm.shape[1], dim=1)  # [B, H, N]
    Ch = Cm.repeat_interleave(H // Cm.shape[1], dim=1)
    dA = torch.exp(dt * A[None, :])  # [B, H]
    xdt = x * dt[..., None]  # [B, H, P]
    N = Bh.shape[-1]
    args = (state.view(Bsz * H, P, state.shape[-1]), Ch.reshape(Bsz * H, N),
            Bh.reshape(Bsz * H, N), dA.reshape(Bsz * H, 1), xdt.reshape(Bsz * H, P),
            None if scale is None else scale.view(Bsz * H))
    step = (ssm_state.fused_state_step if ssm_state.kernel_takes(*args)
            else ssm_state.fused_state_step_plain)
    bc = torch.empty(Bsz * H, dtype=torch.float32, device=x.device)  # B.C, one scalar a head
    y_state, _ = step(*args, bc=bc)
    y = (dA[..., None] * y_state.view(Bsz, H, P) + bc.view(Bsz, H, 1) * xdt
         + x * D[None, :, None])
    return y, state


def _taps(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, L: int) -> torch.Tensor:
    """sum_k xp[:, k:k + L] w[k] + b over the K taps of a depthwise conv, xp
    [B, L + K - 1, C]: fp32 products added in tap order, rounded once to xp's
    dtype, then the bias in that dtype (JAX's conv, then ``+ b``)."""
    xf, wf = xp.float(), w.float()
    y = xf[:, :L] * wf[0]
    for k in range(1, w.shape[0]):
        y = torch.addcmul(y, xf[:, k:k + L], wf[k])
    return y.to(xp.dtype) + b


def causal_conv1d_prefill(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over x [B, L, C] with kernel w [K, C] -> (y [B, L, C],
    conv state [B, K-1, C], the last K-1 rows of the left-padded input)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))  # [B, L + K - 1, C]
    return _taps(xp, w, b, x.shape[1]), xp[:, xp.shape[1] - (K - 1):, :]


def causal_conv1d_step(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step: x [B, C], conv state [B, K-1, C] -> (y [B, C], new state)."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)  # [B, K, C]
    return _taps(window, w, b, 1)[:, 0], window[:, 1:, :]
