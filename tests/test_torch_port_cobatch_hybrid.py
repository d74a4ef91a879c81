"""The hybrid's Mamba2 decode reductions in an order the batch does not move,
on the CPU, against the JAX package.

On the card a batched library reduction picks its algorithm by the whole
shape, batch included: the decode step's B.C ``torch.einsum`` and the causal
conv's ``torch.einsum`` / cuDNN grouped ``F.conv1d`` gave a request's rows
other bits co-batched than alone.  The port now takes B.C from K7 (its plain
version ``bc_plain`` adds the products' halves pairwise, an order N fixes)
and adds the conv's taps in tap order (``ops/ssm.py`` ``_taps``: fp32
products, rounded once, then the bias).  Held here: both against JAX's
``ssd_decode_step`` / ``causal_conv1d_*`` on the same inputs, and a row alone
the same bits as inside a batch of 4.  Tolerances: fp32 1e-6 x max|ref| (the
same sums in another order); a bf16 conv one bf16 ulp of max|ref| (both round
the fp32 sum once, then add the bias in bf16).  The card-side checks are
``tests/test_torch_port_cuda.py::test_hybrid_decode_step_row_alone_equals_row_in_batch_64``
and ``chip_smoke.py``'s ``[cobatch hybrid]``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.ops import ssm as jssm
from zonos_tpu_torch.kernels.ssm_state import bc_plain, fused_state_step_plain
from zonos_tpu_torch.ops import ssm as tssm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


@pytest.mark.parametrize("N", [16, 24, 128])
def test_bc_plain_matches_jax_and_keeps_a_row_alone(N):
    """B.C per row against JAX's ``einsum("bhn,bhn->bh")`` (1e-6 x max|ref|),
    through the plain K7 step too, and rows 0 and 2 alone the same bits as
    inside 4 rows."""
    rng = np.random.default_rng(N)
    B = rng.normal(size=(4, N)).astype(np.float32)
    C = rng.normal(size=(4, N)).astype(np.float32)
    ref = np.asarray(jnp.einsum("bn,bn->b", B, C))
    got = bc_plain(_t(B), _t(C))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max() * np.sqrt(N)
    bc = torch.empty(4)
    fused_state_step_plain(torch.zeros(4, 2, N), _t(C), _t(B), torch.ones(4, 1),
                           torch.zeros(4, 2), bc=bc)
    assert torch.equal(bc, got)
    for r in (0, 2):
        assert torch.equal(bc_plain(_t(B[r:r + 1]), _t(C[r:r + 1])), got[r:r + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 9])
def test_causal_conv_taps_match_jax_and_keep_a_row_alone(L, dtype):
    """The prefill over L steps and one streaming step after it against
    JAX's conv (in the compute dtype: fp32 within 1e-6 x max|ref|, bf16
    within one bf16 ulp of max|ref|); rows 0 and 3 alone the same bits as
    inside 4 rows."""
    rng = np.random.default_rng(L)
    K, C = 4, 48
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = rng.normal(size=(4, L, C)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    xn = rng.normal(size=(4, C)).astype(np.float32)
    jx, jw, jb, jxn = (jnp.asarray(a, jdt) for a in (x, w, b, xn))
    ref_y, ref_state = jssm.causal_conv1d_prefill(jx, jw, jb)
    ref_y1, _ = jssm.causal_conv1d_step(jxn, ref_state, jw, jb)
    tx, tw, tb, txn = (_t(a).to(tdt) for a in (x, w, b, xn))
    y, state = tssm.causal_conv1d_prefill(tx, tw, tb)
    y1, state1 = tssm.causal_conv1d_step(txn, state, tw, tb)
    for ours, ref in ((y, ref_y), (y1, ref_y1)):
        assert ours.dtype == tdt
        ref = np.asarray(ref.astype(jnp.float32))
        top = float(np.abs(ref).max())
        tol = 1e-6 * top if dtype == "float32" else _bf16_ulp(top)
        assert np.abs(ours.float().numpy() - ref).max() <= tol
    for r in (0, 3):
        ya, sa = tssm.causal_conv1d_prefill(tx[r:r + 1], tw, tb)
        y1a, s1a = tssm.causal_conv1d_step(txn[r:r + 1], sa, tw, tb)
        assert torch.equal(ya, y[r:r + 1]) and torch.equal(sa, state[r:r + 1])
        assert torch.equal(y1a, y1[r:r + 1]) and torch.equal(s1a, state1[r:r + 1])
