"""K7 decode-state step (csrc/ssm_state.cu) and its plain version.

Replaces ``fused_state_step`` (zonos_tpu/ops/pallas_state.py:49), the fused
form of the state half of ``ssd_decode_step`` (zonos_tpu/ops/ssm.py:218-226):
over the stored ``[BH, P, N]`` state, ``y = sum_n s * C`` from the old state
and ``s' = s * dA + xdt (x) B``, with ``s'`` written back **in place** in the
storage dtype (fp32, bf16, or float8 e4m3 saturated to +-448).  The kernel
reads the state once and writes it once, a slab of rows per CTA moved by one
TMA bulk copy each way (:func:`slab_plan` cuts the slabs); bound and design:
see the source note.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count
from zonos_tpu_torch.ops.quant import store_cast

STATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"zt_ssm_state_step": [_P] * 6 + [_I] * 5 + [_P]}
MAX_SLAB_BYTES = 32 * 1024  # a CTA's slab in shared memory; compiled into the kernel
MIN_SLAB_BYTES = 2048  # below this a CTA's fixed costs outweigh what it moves
CTAS_PER_SM = 6  # the grid the plan aims for, several CTAs per SM


def slab_plan(BH: int, P: int, N: int, itemsize: int, sms: int = 132) -> tuple[int, int]:
    """K7's launch plan: ``(rows, ctas_per_bh)``.  Each bh row's P state rows
    are cut into ``ctas_per_bh = ceil(P / rows)`` slabs of ``rows`` rows (the
    last may be shorter), one CTA each, grid ``(BH, ctas_per_bh)``: bh on
    grid.x, which takes 2^31 - 1 (grid.y stops at 65,535).  A slab is halved from the whole row until the grid holds
    ``CTAS_PER_SM`` CTAs per SM or the slab would drop below
    ``MIN_SLAB_BYTES``; it never exceeds ``MAX_SLAB_BYTES``.  At BH 128, P 64,
    N 128 (batch 1 with CFG) that is 8 fp32 rows (4 KB) and 1024 CTAs; at BH
    1024 in f8 one 8 KB slab a bh row."""
    row_bytes = N * itemsize
    rows = P
    while rows > 1 and (rows * row_bytes > MAX_SLAB_BYTES or (
            BH * -(-P // rows) < CTAS_PER_SM * sms and rows * row_bytes > MIN_SLAB_BYTES)):
        rows = -(-rows // 2)
    return rows, -(-P // rows)


def storage_ulp(state: torch.Tensor) -> torch.Tensor:
    """One ulp of ``state``'s storage dtype at each stored value (fp32): the
    unit in which a kernel's stored state is held to the plain version's."""
    mant, min_exp = {torch.float32: (23, -126), torch.bfloat16: (7, -126),
                     torch.float8_e4m3fn: (3, -6)}[state.dtype]
    mag = state.float().abs().clamp_min(2.0 ** min_exp)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def fused_state_step_plain(state: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                           dA: torch.Tensor, xdt: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """state [BH, P, N] (storage dtype, updated in place), C/B [BH, N], dA
    [BH, 1], xdt [BH, P] fp32 -> (y [BH, P] fp32, state)."""
    s = state.float()
    y = torch.einsum("bpn,bn->bp", s, C)
    store_cast(state, s * dA[:, :, None] + xdt[:, :, None] * B[:, None, :])
    return y, state


def _refusal(state, C, B, dA, xdt):
    """Why the kernel does not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if it does."""
    if state.dtype not in STATE_DTYPES:
        return TypeError, f"fused_state_step stores fp32, bf16 or float8_e4m3fn, not {state.dtype}"
    if any(t.dtype != torch.float32 for t in (C, B, dA, xdt)):
        return TypeError, "fused_state_step takes fp32 C, B, dA and xdt"
    if state.dim() != 3:
        return ValueError, f"bad state shape {tuple(state.shape)}"
    BH, P, N = state.shape
    if C.shape != (BH, N) or B.shape != (BH, N) or dA.shape != (BH, 1) or xdt.shape != (BH, P):
        return ValueError, (f"bad shapes state {tuple(state.shape)} C {tuple(C.shape)} "
                            f"B {tuple(B.shape)} dA {tuple(dA.shape)} xdt {tuple(xdt.shape)}")
    lanes = N * state.element_size() // 16  # 16-byte slices per state row
    if (N * state.element_size()) % 16 or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        return ValueError, (f"d_state {N} in {state.dtype} is not 16-byte slices of a power of "
                            "two up to 32")
    if P > 65535:  # bounds grid.y, ceil(P / rows) slabs a bh row
        return ValueError, f"{P} state rows a head pass the grid's 65,535 slabs"
    return None


def kernel_takes(state, C, B, dA, xdt) -> bool:
    """Whether K7 takes these operands, by dtype and shape: an fp32, bf16 or
    f8 state whose rows are a power-of-two count (at most 32) of 16-byte
    slices, at most 65,535 rows a head, fp32 C, B, dA and xdt.
    ``ops/ssm.py`` runs the plain version where it does not."""
    return _refusal(state, C, B, dA, xdt) is None


def fused_state_step(state: torch.Tensor, C: torch.Tensor, B: torch.Tensor, dA: torch.Tensor,
                     xdt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 for CUDA tensors; CPU tensors take the plain version.  Shapes and
    the in-place contract as :func:`fused_state_step_plain`."""
    if not state.is_cuda:
        return fused_state_step_plain(state, C, B, dA, xdt)
    inputs = (C, B, dA, xdt)
    if any(t.device != state.device for t in inputs):
        raise ValueError("fused_state_step operands must lie on one CUDA device")
    refusal = _refusal(state, C, B, dA, xdt)
    if refusal is not None:
        raise refusal[0](refusal[1])
    BH, P, N = state.shape
    if not (state.is_contiguous() and state.data_ptr() % 16 == 0
            and all(t.is_contiguous() for t in inputs)):
        raise ValueError("fused_state_step takes contiguous tensors and a 16-byte-aligned state")
    y = torch.empty((BH, P), dtype=torch.float32, device=state.device)
    rows, _ = slab_plan(BH, P, N, state.element_size(), sm_count(state.device.index))
    lib = library("ssm_state", _SIGNATURES)
    rc = lib.zt_ssm_state_step(
        state.data_ptr(), C.data_ptr(), B.data_ptr(), dA.data_ptr(), xdt.data_ptr(), y.data_ptr(),
        BH, P, N, STATE_DTYPES[state.dtype], rows,
        torch.cuda.current_stream(state.device).cuda_stream,
    )
    check(rc, "fused_state_step")
    launch_counts["fused_state_step"] += 1
    return y, state

