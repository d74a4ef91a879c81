"""K7 decode-state step (csrc/ssm_state.cu) and its plain version.

Replaces ``fused_state_step`` (zonos_tpu/ops/pallas_state.py:49), the fused
form of the state half of ``ssd_decode_step`` (zonos_tpu/ops/ssm.py:218-226):
over the stored ``[BH, P, N]`` state, ``y = sum_n s * C`` from the old state
and ``s' = s * dA + xdt (x) B``, with ``s'`` written back **in place** in the
storage dtype (fp32, bf16, or float8 e4m3 saturated to +-448).  The kernel
reads the state once and writes it once, a slab of rows per CTA moved by one
TMA bulk copy each way (:func:`slab_plan` cuts the slabs); bound and design:
see the source note.

The int8 and int4 states (zonos_tpu/models/hybrid.py:145-191, where JAX
computes them with XLA ops around its plain step) pass a ``scale`` [BH] fp32,
one per (row, head): the stored values are ``q * scale``; the new state is
stored as ``q = clamp(rint(s' / scale'), +-127)`` (int4: +-7, two to a byte,
element 2i in the low nibble) with ``scale' = max(absmax(s'), 1e-20) / 127``
(``/ 7``) over the whole head, both written in place.  An int4 state's rows
hold ``N / 2`` bytes, which is how it is told from an int8 one.  One CTA owns
a whole head, since the scale spans it.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count
from zonos_tpu_torch.ops.quant import store_cast

STATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# the quantized states' grid limits; the scale is max(absmax, 1e-20) times the fp32
# reciprocal of the limit, as XLA computes JAX's `/ 127.0` and `/ 7.0`, while q divides by
# the scale (both held against JAX's _store_ssm, tests/test_torch_port_state_modes.py)
GRID_LIMITS = {"int8": 127, "int4": 7}
_RECIPROCALS = {mode: torch.tensor(1.0 / lim, dtype=torch.float32).item()
                for mode, lim in GRID_LIMITS.items()}
SCALE_FLOOR = 1e-20
QUANT_THREADS = 256  # a CTA of the quantized kernel; compiled into it
QUANT_VALUES_PER_THREAD = 64  # the new values a thread holds in registers; compiled in too

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"zt_ssm_state_step": [_P] * 7 + [_I] * 5 + [_P],
               "zt_ssm_state_step_quant": [_P] * 8 + [_I] * 4 + [_P]}
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


def quant_mode(state: torch.Tensor, C: torch.Tensor) -> str | None:
    """``"int8"`` or ``"int4"`` for an int8 state (int4 when its rows hold
    ``N / 2`` bytes, N being C's width), None for a float state."""
    if state.dtype != torch.int8:
        return None
    return "int4" if 2 * state.shape[-1] == C.shape[-1] else "int8"


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., N/2]`` -> int8 ``[..., N]``: element 2i from the low nibble,
    2i+1 from the high one, each sign-extended (zonos_tpu/models/hybrid.py:157-163)."""
    lo = ((packed & 15) ^ 8) - 8
    hi = packed >> 4  # an arithmetic shift
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def dequantize_state(q: torch.Tensor, scale: torch.Tensor, mode: str) -> torch.Tensor:
    """Stored ``q`` (int8, or int4 packed) times ``scale`` (broadcast over the
    last two dims) -> the fp32 state."""
    return (unpack_int4(q) if mode == "int4" else q).float() * scale


def quantize_state(s: torch.Tensor, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``s [..., P, N]`` -> (``q`` int8 ``[..., P, N]`` or int4-packed
    ``[..., P, N/2]``, ``scale`` fp32 ``[..., 1, 1]``): one scale a head from
    its absmax (zonos_tpu/models/hybrid.py:169-187)."""
    lim = GRID_LIMITS[mode]
    amax = s.abs().amax(dim=(-2, -1), keepdim=True)
    scale = amax.clamp_min(SCALE_FLOOR) * _RECIPROCALS[mode]
    q = torch.clamp(torch.round(s / scale), -lim, lim).to(torch.int8)
    if mode == "int4":
        q = (q[..., 0::2] & 15) | (q[..., 1::2] << 4)
    return q, scale


def storage_ulp(state: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """One ulp of ``state``'s storage dtype at each stored value (fp32): the
    unit in which a kernel's stored state is held to the plain version's.  An
    int8 or int4 state's step is its grid's, the head's ``scale`` [BH]."""
    if state.dtype == torch.int8:
        return scale.float().view(-1, *([1] * (state.dim() - 1))).expand(state.shape)
    mant, min_exp = {torch.float32: (23, -126), torch.bfloat16: (7, -126),
                     torch.float8_e4m3fn: (3, -6)}[state.dtype]
    mag = state.float().abs().clamp_min(2.0 ** min_exp)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def bc_plain(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``sum_n B C`` of each row of B/C [BH, N] fp32 -> [BH], in an order
    fixed by N: pairs of halves added elementwise until one column is left
    (the kernel's own order is fixed by N and the storage type)."""
    p = B * C
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = torch.cat([p[:, :h] + p[:, h:2 * h], p[:, 2 * h:]], dim=-1)
    return p[:, 0]


def fused_state_step_plain(state: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                           dA: torch.Tensor, xdt: torch.Tensor, scale: torch.Tensor | None = None,
                           bc: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """state [BH, P, N] (storage dtype, updated in place; an int4 state [BH,
    P, N/2]), C/B [BH, N], dA [BH, 1], xdt [BH, P] fp32, and for an int8 or
    int4 state its ``scale`` [BH] fp32, updated in place too -> (y [BH, P]
    fp32, state); ``bc`` [BH] fp32, when given, receives ``sum_n B C``
    (:func:`bc_plain`)."""
    mode = quant_mode(state, C)
    if bc is not None:
        bc.copy_(bc_plain(B, C))
    s = state.float() if mode is None else dequantize_state(state, scale.view(-1, 1, 1), mode)
    y = torch.einsum("bpn,bn->bp", s, C)
    new = s * dA[:, :, None] + xdt[:, :, None] * B[:, None, :]
    if mode is None:
        store_cast(state, new)
    else:
        q, new_scale = quantize_state(new, mode)
        state.copy_(q)
        scale.copy_(new_scale.view(scale.shape))
    return y, state


def _quant_refusal(state, C, B, dA, xdt, scale, mode):
    """``_refusal`` for an int8 or int4 state: one CTA of ``QUANT_THREADS``
    threads a head, each holding at most ``QUANT_VALUES_PER_THREAD`` values,
    in pieces of 16 values along a row."""
    BH, P, N = state.shape[0], state.shape[1], C.shape[-1]
    if scale is None or scale.dtype != torch.float32 or scale.numel() != BH:
        return ValueError, f"an {mode} state needs fp32 scales [{BH}]"
    lanes = N // 16  # 16-value pieces a row
    if N % 16 or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        return ValueError, f"d_state {N} is not 16-value pieces of a power of two up to 32"
    if P * N > QUANT_THREADS * QUANT_VALUES_PER_THREAD:
        return ValueError, (f"a head of {P} x {N} values passes the {QUANT_THREADS} x "
                            f"{QUANT_VALUES_PER_THREAD} a CTA holds")
    return None


def _refusal(state, C, B, dA, xdt, scale=None):
    """Why the kernel does not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if it does."""
    if state.dtype not in STATE_DTYPES and state.dtype != torch.int8:
        return TypeError, (f"fused_state_step stores fp32, bf16, float8_e4m3fn or int8, not "
                           f"{state.dtype}")
    if any(t.dtype != torch.float32 for t in (C, B, dA, xdt)):
        return TypeError, "fused_state_step takes fp32 C, B, dA and xdt"
    if state.dim() != 3 or C.dim() != 2:
        return ValueError, f"bad shapes state {tuple(state.shape)} C {tuple(C.shape)}"
    BH, P, N = state.shape[0], state.shape[1], C.shape[-1]
    mode = quant_mode(state, C)
    if state.shape[2] != (N // 2 if mode == "int4" else N) or C.shape != (BH, N) or \
            B.shape != (BH, N) or dA.shape != (BH, 1) or xdt.shape != (BH, P):
        return ValueError, (f"bad shapes state {tuple(state.shape)} C {tuple(C.shape)} "
                            f"B {tuple(B.shape)} dA {tuple(dA.shape)} xdt {tuple(xdt.shape)}")
    if mode is not None:
        return _quant_refusal(state, C, B, dA, xdt, scale, mode)
    lanes = N * state.element_size() // 16  # 16-byte slices per state row
    if (N * state.element_size()) % 16 or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        return ValueError, (f"d_state {N} in {state.dtype} is not 16-byte slices of a power of "
                            "two up to 32")
    if P > 65535:  # bounds grid.y, ceil(P / rows) slabs a bh row
        return ValueError, f"{P} state rows a head pass the grid's 65,535 slabs"
    return None


def kernel_takes(state, C, B, dA, xdt, scale=None) -> bool:
    """Whether K7 takes these operands, by dtype and shape: fp32 C, B, dA
    and xdt, and an fp32, bf16 or f8 state whose rows are a power-of-two
    count (at most 32) of 16-byte slices, at most 65,535 rows a head; or an
    int8 or int4 state with its fp32 scales whose rows are a power-of-two
    count (at most 32) of 16 values and whose heads hold at most 16,384
    values.  ``ops/ssm.py`` runs the plain version where it does not."""
    return _refusal(state, C, B, dA, xdt, scale) is None


def fused_state_step(state: torch.Tensor, C: torch.Tensor, B: torch.Tensor, dA: torch.Tensor,
                     xdt: torch.Tensor, scale: torch.Tensor | None = None,
                     bc: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 for CUDA tensors; CPU tensors take the plain version.  Shapes and
    the in-place contract as :func:`fused_state_step_plain`."""
    if not state.is_cuda:
        return fused_state_step_plain(state, C, B, dA, xdt, scale, bc)
    inputs = (C, B, dA, xdt) + tuple(t for t in (scale, bc) if t is not None)
    if any(t.device != state.device for t in inputs):
        raise ValueError("fused_state_step operands must lie on one CUDA device")
    refusal = _refusal(state, C, B, dA, xdt, scale)
    if refusal is not None:
        raise refusal[0](refusal[1])
    BH, P, N = state.shape[0], state.shape[1], C.shape[-1]
    if not (state.is_contiguous() and state.data_ptr() % 16 == 0
            and all(t.is_contiguous() for t in inputs)):
        raise ValueError("fused_state_step takes contiguous tensors and a 16-byte-aligned state")
    if bc is not None and (bc.dtype != torch.float32 or bc.numel() != BH):
        raise ValueError(f"bc must be fp32 [{BH}]")
    y = torch.empty((BH, P), dtype=torch.float32, device=state.device)
    lib = library("ssm_state", _SIGNATURES)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    mode = quant_mode(state, C)
    bc_ptr = None if bc is None else bc.data_ptr()
    if mode is None:
        rows, _ = slab_plan(BH, P, N, state.element_size(), sm_count(state.device.index))
        rc = lib.zt_ssm_state_step(
            state.data_ptr(), C.data_ptr(), B.data_ptr(), dA.data_ptr(), xdt.data_ptr(),
            y.data_ptr(), bc_ptr, BH, P, N, STATE_DTYPES[state.dtype], rows, stream)
        name = "fused_state_step"
    else:
        rc = lib.zt_ssm_state_step_quant(
            state.data_ptr(), scale.data_ptr(), C.data_ptr(), B.data_ptr(), dA.data_ptr(),
            xdt.data_ptr(), y.data_ptr(), bc_ptr, BH, P, N, int(mode == "int4"), stream)
        name = f"fused_state_step_{mode}"
    check(rc, name)
    launch_counts[name] += 1
    return y, state

