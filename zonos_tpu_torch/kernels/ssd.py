"""K6 chunked-SSD prefill (csrc/ssd_chunked.cu) and its plain version.

Replaces ``ssd_chunked_pallas`` (zonos_tpu/ops/pallas_ssm.py:167) and its
XLA twin ``ssd_chunked`` (zonos_tpu/ops/ssm.py:74-135): the Mamba2
selective scan over a whole sequence as 64-step chunks, from an optional
initial state.  The kernel takes any ``ngroups`` and any batch; ``kernel_takes``
says which dtypes and widths it takes (``ops/ssm.py`` dispatches on it).

Bound and design: see the source note.  A CTA per (row, head) loops
over the chunks with the fp32 ``[P, N]`` state in its warps' tensor-core
accumulators; the CTAs of one (row, group) form a cluster that computes
C.B^T once a chunk.  :func:`ssd_plan` chooses the launch.

Under autograd (``grad_required``: the hybrid's training forward) K6 runs as
the forward of :class:`_SsdGrad`, whose backward recomputes the plain chunked
formulation on the saved inputs and differentiates it with respect to x, dt,
A, B, C, D (and an initial state): the gradients are the bits
``torch.autograd`` gives through :func:`ssd_chunked_plain`.  The JAX package's
``ssd_chunked_pallas`` has no VJP at all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from zonos_tpu_torch.kernels import grad_required, launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

CHUNK = 64  # compiled into the kernel
MAX_HEADDIM, MAX_D_STATE = 64, 128  # the kernel's shared-memory layout
CLUSTER = 2  # CTAs sharing one C.B^T, where the heads of a group allow it (--sweep)
WARPS = 16  # the warps a CTA aims at (--sweep)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"zt_ssd_chunked": [_P] * 9 + [_I] * 8 + [_P],
               "zt_ssd_chunked_prepare": [],
               "zt_ssd_chunked_smem": [_I] * 6,
               "zt_ssd_chunked_max_active_clusters": [_I] * 6 + [_P]}


class SsdPlan(NamedTuple):
    groups: int  # warps over the state's columns for each 16 rows of P
    cluster: int  # CTAs (heads of one group) sharing one C.B^T


def ssd_plan(B: int, L: int, H: int, G: int, P: int, N: int, sm_count: int) -> SsdPlan:
    """K6's launch for these widths: one CTA a (row, head), ``WARPS`` warps
    where N's tiles allow, and clusters of up to ``CLUSTER`` CTAs of one (row,
    group).  It depends on the widths alone, never on ``B``, ``L`` or
    ``sm_count``, so a row's outputs do not depend on its batch.  The kernel
    (``config`` in csrc/ssd_chunked.cu) takes it at every width
    ``kernel_takes`` accepts."""
    del B, L, sm_count  # the plan is the same at every batch and length, on every card
    m_tiles, n_tiles = -(-P // 16), -(-N // 16) * 2  # 16-row tiles of P, 8-column tiles of N
    groups = max(ng for ng in (1, 2, 4, 8) if m_tiles * ng <= WARPS and n_tiles % ng == 0)
    cluster = max(c for c in (1, 2, 4, 8) if c <= CLUSTER and (H // G) % c == 0)
    return SsdPlan(groups, cluster)


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The library, with the kernel's shared-memory limit raised on the device:
    once, at the first launch, so never while a CUDA graph is being captured."""
    lib = library("ssd_chunked", _SIGNATURES)
    with torch.cuda.device(device_index):
        check(lib.zt_ssd_chunked_prepare(), "ssd_chunked_prepare")
    return lib


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, D: torch.Tensor, init_state: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, H, P], dt [B, L, H] (softplus'd), A [H] (negative), B/C
    [B, L, G, N], D [H], init_state [B, H, P, N] -> (y [B, L, H, P], final
    state [B, H, P, N]); fp32, the chunked formulation of the JAX package."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-L) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // CHUNK

    def chunks(t):  # [B, Lp, ...] -> [B, nc, Q, ...]
        return t.reshape(Bsz, nc, CHUNK, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)
    Bc = chunks(Bm.repeat_interleave(H // G, dim=2))  # [B, nc, Q, H, N]
    Cc = chunks(Cm.repeat_interleave(H // G, dim=2))
    s = torch.cumsum(dtc * A, dim=2)  # [B, nc, Q, H] cumulative log-decay

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(s_i - s_j) dt_j x_j; the
    # exponent is masked before exp (the upper triangle would overflow)
    causal = torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=x.device).tril()
    diff = s[:, :, :, None, :] - s[:, :, None, :, :]  # [B, nc, Q(i), Q(j), H]
    decay = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("bnihs,bnjhs->bnijh", Cc, Bc)
    w = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w, xc)

    # chunk summary state and the sequential carry between chunks
    tail = torch.exp(s[:, :, -1:, :] - s)
    contrib = xc * (dtc * tail)[..., None]
    s_chunk = torch.einsum("bnqhp,bnqhs->bnhps", contrib, Bc)  # [B, nc, H, P, N]
    chunk_decay = torch.exp(s[:, :, -1, :])  # [B, nc, H]
    h = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    befores = []
    for n in range(nc):
        befores.append(h)
        h = h * chunk_decay[:, n, :, None, None] + s_chunk[:, n]
    h_before = torch.stack(befores, dim=1)  # state before each chunk

    y_inter = torch.einsum("bnqhs,bnhps->bnqhp", Cc * torch.exp(s)[..., None], h_before)
    y = (y_intra + y_inter).reshape(Bsz, Lp, H, P)[:, :L]
    return y + x[:, :L] * D[None, None, :, None], h


def _refusal(x, dt, A, Bm, Cm, D, init_state=None):
    """Why the kernel does not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if it does."""
    tensors = [x, dt, A, Bm, Cm, D] + ([init_state] if init_state is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        return TypeError, "ssd_chunked takes fp32 operands"
    if x.dim() != 4 or Bm.dim() != 4:
        return ValueError, f"bad shapes x {tuple(x.shape)} B {tuple(Bm.shape)}"
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, L, H) or A.shape != (H,) or D.shape != (H,)
            or Bm.shape != (Bsz, L, G, N) or Cm.shape != Bm.shape or G < 1 or H % G
            or (init_state is not None and init_state.shape != (Bsz, H, P, N))):
        return ValueError, (f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                            f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)} "
                            f"D {tuple(D.shape)}")
    if P % 4 or P > MAX_HEADDIM or N % 4 or N > MAX_D_STATE or L < 1:
        return ValueError, (f"the kernel takes headdim <= {MAX_HEADDIM} and d_state <= "
                            f"{MAX_D_STATE}, multiples of 4, and L >= 1; got P={P} N={N} L={L}")
    return None


def kernel_takes(x, dt, A, Bm, Cm, D, init_state=None) -> bool:
    """Whether K6 takes these operands, by dtype and shape: fp32, headdim at
    most 64 and d_state at most 128, multiples of 4 (the flagship's 64 and 128
    sit on the limits).  ``ops/ssm.py`` runs the plain version where it does
    not."""
    return _refusal(x, dt, A, Bm, Cm, D, init_state) is None


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, D: torch.Tensor, init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 for CUDA tensors (any ngroups, any batch) by :func:`ssd_plan`; CPU
    tensors take the plain version.  Shapes and dtypes as
    :func:`ssd_chunked_plain`.  Under autograd both outputs carry their
    gradients (:class:`_SsdGrad`)."""
    if grad_required(x, dt, A, Bm, Cm, D, init_state):
        return _SsdGrad.apply(x, dt, A, Bm, Cm, D, init_state)
    return _ssd(x, dt, A, Bm, Cm, D, init_state)


class _SsdGrad(torch.autograd.Function):
    """K6 forward; the plain formulation's gradient (module note).  An unused
    output's gradient arrives as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, init_state)
        return _ssd(x, dt, A, Bm, Cm, D, init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        return ssd_backward(ctx.saved_tensors, dy, dfinal, ctx.needs_input_grad)


def ssd_backward(inputs, dy: torch.Tensor, dfinal: torch.Tensor, wanted=(True,) * 7) -> tuple:
    """The gradients of ``inputs`` ``(x, dt, A, B, C, D, init_state)`` (None
    where not ``wanted``) for the upstream gradients of y and of the final
    state: :func:`ssd_chunked_plain` recomputed and differentiated."""
    with torch.enable_grad():
        args = [None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(inputs, wanted)]
        outs = ssd_chunked_plain(*args)
        grads = iter(torch.autograd.grad(outs, [t for t, need in zip(args, wanted) if need],
                                         (dy, dfinal)))
    return tuple(next(grads) if need else None for need in wanted)


def _ssd(x, dt, A, Bm, Cm, D, init_state) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's launch on CUDA tensors, the plain version on CPU ones."""
    if not x.is_cuda:
        return ssd_chunked_plain(x, dt, A, Bm, Cm, D, init_state)
    tensors = [x, dt, A, Bm, Cm, D] + ([init_state] if init_state is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_chunked operands must lie on one CUDA device")
    refusal = _refusal(x, dt, A, Bm, Cm, D, init_state)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("ssd_chunked takes contiguous, 16-byte-aligned tensors")
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y, final = launch(x, dt, A, Bm, Cm, D, init_state,
                      ssd_plan(Bsz, L, H, G, P, N, sm_count(x.device.index)))
    launch_counts["ssd_chunked"] += 1
    return y, final


def launch(x, dt, A, Bm, Cm, D, init_state, plan: SsdPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K6 by ``plan`` on operands :func:`ssd_chunked` has checked
    (``--sweep`` launches other plans through it; it counts no launch)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    rc = _library(x.device.index).zt_ssd_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        init_state.data_ptr() if init_state is not None else None, y.data_ptr(),
        final.data_ptr(), Bsz, L, H, G, P, N, plan.groups, plan.cluster,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "ssd_chunked")
    return y, final
