"""K6, the chunked-SSD prefill: a CPU model of its Hopper kernel and its plan.

The kernel (``csrc/ssd_chunked.cu``) runs only on the card.  Here a numpy
model of it follows its index maps lane by lane: each warp's (m-tile, column
group), the mma.sync m16n8k8 TF32 fragments (``_mma`` builds the 16x8 and 8x8
operands from the registers by PTX's fragment layout, which the kernel's
index expressions must match), the permuted k order of C.B^T and of h.C^T
(whose A operand is the state's own accumulator), the C.B^T columns each
cluster rank computes and the others read, the partials' fixed order, and
the 3xTF32 split: hi = a with its low 13 mantissa bits masked off (a tf32
value), lo = a - hi, of which the tensor cores read the tf32 part (masked the
same way).  At the flagship widths it is held against ``ssd_chunked_plain``
and JAX's ``zonos_tpu.ops.ssm.ssd_chunked`` at the card's tolerance, 1e-4 x
max|ref|; one TF32 pass misses it, which is why the kernel takes three.

The plan (``ssd_plan``) is checked over every width ``kernel_takes`` accepts:
every y and final-state element written exactly once, the shared memory
within 227 KB, the cluster within the portable 8 CTAs of one (row, group),
and the plan a function of the widths alone (not of the batch).  What the
kernel takes of a plan is ``tests/_k6_plans.py``'s copy of its checks.

Tolerance: 1e-4 x max|ref| for y and the final state (the card check's).
"""

from __future__ import annotations

import itertools

import _k6_plans as k6_plans  # tests/, on sys.path under pytest
import numpy as np
import pytest
import torch

from zonos_tpu.ops import ssm as jssm
from zonos_tpu_torch.kernels.ssd import (
    CHUNK,
    SsdPlan,
    kernel_takes,
    ssd_chunked_plain,
    ssd_plan,
)

Q = CHUNK
LANE = np.arange(32)
GID, TIG = LANE // 4, LANE % 4

# PTX's m16n8k8 .tf32 fragment layout: (row, col) of each (lane, register)
_A_RC = np.stack([np.stack([GID, GID + 8, GID, GID + 8], 1),
                  np.stack([TIG, TIG, TIG + 4, TIG + 4], 1)])  # [2, 32, 4]
_B_RC = np.stack([np.stack([TIG, TIG + 4], 1), np.stack([GID, GID], 1)])  # [2, 32, 2] (k, n)
_D_RC = np.stack([np.stack([GID, GID, GID + 8, GID + 8], 1),
                  np.stack([2 * TIG, 2 * TIG + 1, 2 * TIG, 2 * TIG + 1], 1)])
_A_FLAT = (_A_RC[0] * 8 + _A_RC[1]).reshape(-1)
_B_FLAT = (_B_RC[0] * 8 + _B_RC[1]).reshape(-1)
_D_FLAT = (_D_RC[0] * 8 + _D_RC[1]).reshape(-1)


def _trunc_tf32(a: np.ndarray) -> np.ndarray:
    """What the tensor cores read of an fp32 register as tf32: its low 13 mantissa
    bits dropped."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: np.ndarray, passes: int) -> tuple[np.ndarray, np.ndarray | None]:
    """The kernel's split: hi = a with its low 13 mantissa bits cleared, lo = a -
    hi (exact in fp32) as the tensor cores read it."""
    a = np.asarray(a, np.float32)
    hi = _trunc_tf32(a)
    return hi, (_trunc_tf32(a - hi) if passes == 3 else None)


def _mma(d: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One mma.sync m16n8k8: d [..., 32, 4] += A [..., 32, 4] x B [..., 32, 2]
    (fragments), the 8 products summed exactly and added to the fp32 d."""
    lead = a.shape[:-2]
    am = np.zeros(lead + (128,))
    am[..., _A_FLAT] = a.reshape(lead + (128,))
    bm = np.zeros(lead + (64,))
    bm[..., _B_FLAT] = b.reshape(lead + (64,))
    prod = (am.reshape(lead + (16, 8)) @ bm.reshape(lead + (8, 8))).reshape(lead + (128,))
    return (d + prod[..., _D_FLAT].reshape(lead + (32, 4))).astype(np.float32)


def _mma3(d, a, b, passes: int, where=None):
    """d += a b in the kernel's order: a_lo b_hi, a_hi b_lo, a_hi b_hi (3xTF32) or
    a_hi b_hi alone (one pass); only where ``where`` holds (a skipped mma)."""
    ah, al = _split(a, passes)
    bh, bl = _split(b, passes)
    out = d
    if passes == 3:
        out = _mma(out, al, bh)
        out = _mma(out, ah, bl)
    out = _mma(out, ah, bh)
    if where is None:
        return out
    return np.where(np.reshape(where, where.shape + (1,) * (out.ndim - np.ndim(where))), out, d)


class Maps:
    """The kernel's index maps for one plan: CTA -> (row, head, cluster rank),
    warp -> (m-tile, column group), and the state tiles a warp owns."""

    def __init__(self, B, H, G, P, N, plan):
        self.plan, self.B, self.H, self.G, self.P, self.N = plan, B, H, G, P, N
        self.mt, self.ng, self.c = k6_plans.m_tiles(P), plan.groups, plan.cluster
        self.npad = k6_plans.npad(N)
        self.ntg = self.npad // (8 * self.ng)
        self.warps = k6_plans.warps(P, plan)
        bh = np.arange(B * H)
        self.b, self.h = bh // H, bh % H
        self.grp = self.h // (H // G)
        self.rank = bh % self.c
        warp = np.arange(self.warps)
        self.mtw, self.g = warp % self.mt, warp // self.mt
        self.pr = 16 * self.mtw[:, None] + GID[None, :]  # [warps, 32] first state row

    def state_rows_cols(self):
        """(p, n, owned) of each (CTA, warp, u, lane, register) of the state."""
        u = np.arange(16 // self.ng)
        half = np.array([0, 0, 1, 1])
        odd = np.array([0, 1, 0, 1])
        p = self.pr[None, :, None, :, None] + 8 * half[None, None, None, None, :]
        p = np.broadcast_to(p, (len(self.b),) + p.shape[1:])
        n = (8 * (self.g[:, None, None, None] * self.ntg + u[None, :, None, None])
             + 2 * TIG[None, None, :, None] + odd[None, None, None, :])[None]
        owned = (u < self.ntg)[None, None, :, None, None]
        return np.broadcast_arrays(p, n, owned)

    def y_rows_cols(self):
        """(i, p, it) of each (CTA, warp, v, lane, register) of y a warp finishes."""
        v = np.arange(8 // self.ng)
        it = self.g[:, None] + self.ng * v[None, :]  # [warps, kOwn]
        odd = np.array([0, 1, 0, 1])
        half = np.array([0, 0, 1, 1])
        i = 8 * it[:, :, None, None] + 2 * TIG[None, None, :, None] + odd
        p = self.pr[None, :, None, :, None] + 8 * half[None, None, None, None, :]
        p = np.broadcast_to(p, (len(self.b),) + p.shape[1:])
        return np.broadcast_arrays(i[None], p, it[None, :, :, None, None])


def kernel_model(x, dt, A, Bm, Cm, D, init, plan, passes: int = 3):
    """The kernel's arithmetic, chunk by chunk, on numpy fp32 operands (shapes as
    ``ssd_chunked_plain``) -> (y, final state)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    m = Maps(Bsz, H, G, P, N, plan)
    X, Wn, npad, mt, ng = len(m.b), m.warps, m.npad, m.mt, m.ng
    k_tiles, k_own = 16 // ng, 8 // ng
    pc = 16 * mt
    y = np.zeros_like(x)
    # the state in the accumulators: [CTA, warp, u, lane, reg]
    sp_, sn, owned = m.state_rows_cols()
    hs = np.zeros((X, Wn, k_tiles, 32, 4), np.float32)
    if init is not None:
        ok = owned & (sp_ < P) & (sn < N)
        hs = np.where(ok, init[m.b[:, None, None, None, None], m.h[:, None, None, None, None],
                               np.minimum(sp_, P - 1), np.minimum(sn, N - 1)], 0).astype(np.float32)
    xi = np.arange(X)[:, None, None]
    for ch in range(-(-L // Q)):
        t0, valid = ch * Q, min(Q, L - ch * Q)
        kmax = -(-valid // 8)
        # the stage: x (zero past P), B, C (zero past N), dt; zero rows past valid
        xs = np.zeros((X, Q, pc), np.float32)
        xs[:, :valid, :P] = x[m.b, t0:t0 + valid][np.arange(X), :, m.h]
        bs = np.zeros((X, Q, npad), np.float32)
        cs = np.zeros((X, Q, npad), np.float32)
        bs[:, :valid, :N] = Bm[m.b, t0:t0 + valid][np.arange(X), :, m.grp]
        cs[:, :valid, :N] = Cm[m.b, t0:t0 + valid][np.arange(X), :, m.grp]
        dts = np.zeros((X, Q), np.float32)
        dts[:, :valid] = dt[m.b, t0:t0 + valid, m.h]

        # the cumulative log-decay as warp 0 takes it: pairs, then a shuffle scan
        a_h = A[m.h].astype(np.float32)[:, None]
        d0, d1 = dts[:, 0::2] * a_h, dts[:, 1::2] * a_h
        v = d0 + d1
        for off in (1, 2, 4, 8, 16):
            v = np.concatenate([v[:, :off], v[:, off:] + v[:, :-off]], axis=1)
        before = np.concatenate([np.zeros((X, 1), np.float32), v[:, :-1]], axis=1)
        s0 = before + d0
        s1 = s0 + d1
        s = np.stack([s0, s1], axis=2).reshape(X, Q)
        s_exp = np.exp(s)
        wd = dts * np.exp(s[:, -1:] - s)

        # C.B^T: rank r's columns [r wdt, (r + 1) wdt), k order permuted (2t, 2t + 1), each
        # pass in an accumulator of its own, summed at the end
        wdt = Q // m.c
        slices = np.zeros((X, Q, wdt), np.float32)
        for mi, nj in itertools.product(range(4), range(wdt // 8)):
            d = np.zeros((3, X, 32, 4), np.float32)  # the three passes' accumulators
            jrow = m.rank[:, None] * wdt + 8 * nj + GID[None, :]
            for k0 in range(0, npad, 8):
                kc = k0 + 2 * TIG
                a = np.stack([cs[:, 16 * mi + GID, kc], cs[:, 16 * mi + GID + 8, kc],
                              cs[:, 16 * mi + GID, kc + 1], cs[:, 16 * mi + GID + 8, kc + 1]], -1)
                b = np.stack([bs[xi[:, :, 0], jrow, kc[None, :]],
                              bs[xi[:, :, 0], jrow, kc[None, :] + 1]], -1)
                ah, al = _split(a, passes)
                bh, bl = _split(b, passes)
                if passes == 3:
                    d[0] = _mma(d[0], al, bh)
                    d[1] = _mma(d[1], ah, bl)
                d[2] = _mma(d[2], ah, bh)
            slices[:, 16 * mi + _D_RC[0], 8 * nj + _D_RC[1]] = (d[0] + d[1]) + d[2]
        # every CTA reads the slices of its cluster: rank j // wdt holds column j
        base = np.arange(X) - m.rank
        j = np.arange(Q)
        cb = slices[base[:, None] + j[None, :] // wdt, :, j[None, :] % wdt].transpose(0, 2, 1)
        causal = j[None, :] <= j[:, None]
        s2 = s * np.float32(np.log2(np.e))  # the kernel keeps log2 of the decay for exp2f
        decay = np.exp2(np.where(causal, s2[:, :, None] - s2[:, None, :], 0))
        W = np.where(causal, cb * decay * dts[:, None, :], 0).astype(np.float32)

        # C.h over each warp's state columns, every i-tile (the state as A, slots 2t / 2t+1)
        has_state = ch > 0 or init is not None
        inter = np.zeros((X, Wn, 8, 32, 4), np.float32)
        if has_state:
            for u in range(k_tiles):
                if u >= m.ntg:
                    continue
                a = hs[:, :, u][..., [0, 2, 1, 3]]
                n0 = 8 * (m.g * m.ntg + u)  # [warps]
                for it in range(kmax):
                    kc = n0[:, None] + 2 * TIG[None, :]
                    row = 8 * it + GID
                    b = np.stack([cs[:, row[None, :], kc], cs[:, row[None, :], kc + 1]], -1)
                    inter[:, :, it] = _mma3(inter[:, :, it], a, b, passes)

        # W.x for the warp's own i-tiles and the state update, over the steps j
        hs = (hs * s_exp[:, -1][:, None, None, None, None]).astype(np.float32)
        intra = np.zeros((X, Wn, k_own, 32, 4), np.float32)
        for kk in range(kmax):
            j0 = 8 * kk
            xa = np.stack([xs[:, j0 + TIG[None, :], m.pr], xs[:, j0 + TIG[None, :], m.pr + 8],
                           xs[:, j0 + TIG[None, :] + 4, m.pr],
                           xs[:, j0 + TIG[None, :] + 4, m.pr + 8]], -1)  # [X, warps, 32, 4]
            for vv in range(k_own):
                it = m.g + ng * vv  # [warps]
                row = 8 * it[:, None] + GID[None, :]
                b = np.stack([W[:, row, j0 + TIG[None, :]], W[:, row, j0 + TIG[None, :] + 4]], -1)
                take = np.broadcast_to((it >= kk) & (it < kmax), (X, Wn))
                intra[:, :, vv] = _mma3(intra[:, :, vv], xa, b, passes, where=take)
            w0, w1 = wd[:, j0 + TIG], wd[:, j0 + TIG + 4]  # [X, 32]
            xw = np.stack([xa[..., 0] * w0[:, None], xa[..., 1] * w0[:, None],
                           xa[..., 2] * w1[:, None], xa[..., 3] * w1[:, None]], -1)
            for u in range(k_tiles):
                if u >= m.ntg:
                    continue
                col = 8 * (m.g * m.ntg + u)[:, None] + GID[None, :]
                b = np.stack([bs[:, j0 + TIG[None, :], col], bs[:, j0 + TIG[None, :] + 4, col]], -1)
                hs[:, :, u] = _mma3(hs[:, :, u], xw, b, passes)

        # the partials meet in order g = 0, 1, ...; y = intra + exp(s_i) inter + D x
        yi, yp, yit = m.y_rows_cols()
        for vv in range(k_own):
            it = m.g + ng * vv
            tot = np.zeros((X, Wn, 32, 4), np.float32)
            if has_state:  # warp mtw + mt g2 holds group g2's partial of the same rows
                tot = inter[:, m.mtw, it]
                for g2 in range(1, ng):
                    tot = (tot + inter[:, m.mtw + mt * g2, it]).astype(np.float32)
            i = yi[:, :, vv]
            pl = yp[:, :, vv]
            ic = np.minimum(i, Q - 1)
            val = (intra[:, :, vv] + s_exp[xi[..., None], ic] * tot).astype(np.float32)
            val = (val + D[m.h][:, None, None, None].astype(np.float32)
                   * xs[xi[..., None], ic, np.minimum(pl, pc - 1)]).astype(np.float32)
            ok = (i < valid) & (yp[:, :, vv] < P) & (it[None, :, None, None] < kmax)
            bb = np.broadcast_to(m.b[:, None, None, None], ok.shape)
            hh = np.broadcast_to(m.h[:, None, None, None], ok.shape)
            y[bb[ok], t0 + i[ok], hh[ok], yp[:, :, vv][ok]] = val[ok]

    final = np.zeros((Bsz, H, P, N), np.float32)
    ok = owned & (sp_ < P) & (sn < N)
    bb = np.broadcast_to(m.b[:, None, None, None, None], ok.shape)
    hh = np.broadcast_to(m.h[:, None, None, None, None], ok.shape)
    final[bb[ok], hh[ok], sp_[ok], sn[ok]] = hs[ok]
    return y, final


def _case(seed, B, L, H, G, P, N, with_init):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, H))) * 0.5).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    init = rng.normal(size=(B, H, P, N)).astype(np.float32) if with_init else None
    return x, dt, A, Bm, Cm, D, init


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _refs(args):
    x, dt, A, Bm, Cm, D, init = args
    t = [None if a is None else torch.from_numpy(a) for a in args]
    plain = [v.numpy() for v in ssd_chunked_plain(*t)]
    jax_ref = [np.asarray(v) for v in jssm.ssd_chunked(x, dt, A, Bm, Cm, D, init_state=init)]
    return {"plain": plain, "jax": jax_ref}


# ---------------------------------------------------------------------------
# the model's numerics at the flagship widths
# ---------------------------------------------------------------------------

FLAGSHIP = dict(H=64, G=1, P=64, N=128)


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("L", [37, 64, 150])
def test_kernel_model_matches_plain_and_jax(L, with_init):
    """3xTF32 in the kernel's maps: within 1e-4 x max|ref| of the plain version
    and of JAX, for y and the final state, batch 2 at the flagship widths."""
    args = _case(L + 7 * with_init, 2, L, **FLAGSHIP, with_init=with_init)
    plan = ssd_plan(2, L, 64, 1, 64, 128, 132)
    y, s = kernel_model(*args, plan)
    for name, (ref_y, ref_s) in _refs(args).items():
        assert _rel_err(y, ref_y) <= 1e-4, name
        assert _rel_err(s, ref_s) <= 1e-4, name


def test_one_tf32_pass_misses_the_tolerance():
    """Why three passes: one TF32 pass (the same maps) is off by more than
    1e-4 x max|ref| at the flagship widths, where three are well inside it."""
    args = _case(11, 2, 150, **FLAGSHIP, with_init=True)
    plan = ssd_plan(2, 150, 64, 1, 64, 128, 132)
    ref_y, ref_s = _refs(args)["plain"]
    y1, s1 = kernel_model(*args, plan, passes=1)
    y3, s3 = kernel_model(*args, plan, passes=3)
    assert max(_rel_err(y1, ref_y), _rel_err(s1, ref_s)) > 1e-4
    assert max(_rel_err(y3, ref_y), _rel_err(s3, ref_s)) < 2e-5


@pytest.mark.parametrize("P,groups,cluster", [(64, 1, 1), (64, 2, 8), (32, 8, 2), (48, 2, 4)])
def test_kernel_model_other_plans(P, groups, cluster):
    """The maps of other plans (``--sweep``'s): 1 to 8 column groups of warps,
    clusters of 1 to 8, 2 to 4 tiles of P; 8 heads, ragged L."""
    plan = SsdPlan(groups, cluster)
    assert k6_plans.refusal(8, 1, P, 128, plan) is None
    args = _case(P + 10 * groups + cluster, 2, 100, 8, 1, P, 128, True)
    y, s = kernel_model(*args, plan)
    ref_y, ref_s = _refs(args)["plain"]
    assert _rel_err(y, ref_y) <= 1e-4 and _rel_err(s, ref_s) <= 1e-4


@pytest.mark.parametrize("B,L,H,G,P,N", [(2, 70, 4, 2, 16, 16), (2, 65, 4, 2, 20, 12),
                                         (1, 1, 2, 1, 4, 4), (3, 129, 6, 3, 36, 100)])
def test_kernel_model_narrow_widths(B, L, H, G, P, N):
    """Widths that are not tile multiples (zero-padded in shared memory), two
    and three groups, L 1 and past two chunks, with an init state."""
    args = _case(B + L + P + N, B, L, H, G, P, N, True)
    y, s = kernel_model(*args, ssd_plan(B, L, H, G, P, N, 132))
    ref_y, ref_s = _refs(args)["plain"]
    assert _rel_err(y, ref_y) <= 1e-4 and _rel_err(s, ref_s) <= 1e-4


# ---------------------------------------------------------------------------
# the plan over every width kernel_takes accepts
# ---------------------------------------------------------------------------

WIDTHS = [(P, N) for P in range(4, 65, 4) for N in range(4, 129, 4)]
HEADS = [(1, 1), (4, 2), (6, 3), (64, 1), (24, 8)]  # (H, G)
# widths at which every alternative plan is checked too (the default at all of WIDTHS)
SOME_WIDTHS = [(P, N) for P in (4, 20, 48, 64) for N in (4, 12, 64, 100, 128)]


def _takes(B, L, H, G, P, N) -> bool:
    z = torch.empty
    return kernel_takes(z((B, L, H, P)), z((B, L, H)), z((H,)), z((B, L, G, N)),
                        z((B, L, G, N)), z((H,)))


def _plans(H, G, P, N):
    """The default plan and every alternative the kernel takes."""
    return [ssd_plan(2, 64, H, G, P, N, 132)] + k6_plans.plans(H, G, P, N)


def _written_once(B, H, G, P, N, plan) -> bool:
    """Each (row, head, p, n) of the final state, and each (row, i, head, p) of
    a chunk's y at 1, 37 and 64 valid rows, written by exactly one (CTA, warp,
    lane, register)."""
    m = Maps(B, H, G, P, N, plan)
    p, n, owned = m.state_rows_cols()
    ok = owned & (p < P) & (n < N)
    flat = ((m.b[:, None, None, None, None] * H + m.h[:, None, None, None, None]) * P + p) * N + n
    if not (np.bincount(flat[ok], minlength=B * H * P * N) == 1).all():
        return False
    i, yp, _ = m.y_rows_cols()
    yflat = ((m.b[:, None, None, None, None] * Q + i) * H + m.h[:, None, None, None, None]) * P + yp
    for valid in (1, 37, Q):
        ok = (i < valid) & (yp < P)
        count = np.bincount(yflat[ok], minlength=B * Q * H * P).reshape(B, Q, H, P)
        if not ((count[:, :valid] == 1).all() and (count[:, valid:] == 0).all()):
            return False
    return True


@pytest.mark.parametrize("H,G", HEADS)
def test_plan_writes_every_output_once(H, G):
    """Over every (P, N) kernel_takes accepts (the default plan; every plan the
    kernel takes at SOME_WIDTHS), each output is written exactly once."""
    for P, N in WIDTHS:
        assert _takes(2, 64, H, G, P, N)
        plans = _plans(H, G, P, N) if (P, N) in SOME_WIDTHS else [ssd_plan(2, 64, H, G, P, N, 132)]
        for plan in plans:
            assert _written_once(2 if H < 64 else 1, H, G, P, N, plan), (P, N, plan)


@pytest.mark.parametrize("H,G", HEADS)
def test_plan_fits_the_card(H, G):
    """Every plan fits 227 KB of shared memory, 16 warps, and clusters of at
    most 8 CTAs that divide the grid and never straddle a (row, group); the
    default plan is one the kernel takes, the same at every batch, length and
    SM count."""
    for P, N in WIDTHS:
        default = ssd_plan(1, 1, H, G, P, N, 132)
        assert k6_plans.refusal(H, G, P, N, default) is None, (P, N, default)
        plans = _plans(H, G, P, N) if (P, N) in SOME_WIDTHS else [default]
        for B, L, sms in ((2, 55, 132), (16, 1024, 114), (1, 7, 1)):
            assert ssd_plan(B, L, H, G, P, N, sms) == default
        for plan in plans:
            w = k6_plans.warps(P, plan)
            assert k6_plans.smem_bytes(P, N, plan) <= k6_plans.MAX_SMEM
            assert w <= k6_plans.MAX_WARPS and w % 2 == 0 and plan.cluster <= k6_plans.MAX_CLUSTER
            assert k6_plans.m_tiles(P) * 16 >= P > (k6_plans.m_tiles(P) - 1) * 16
            # consecutive CTAs of one (row, group) form whole clusters
            assert (H // G) % plan.cluster == 0 and (2 * H) % plan.cluster == 0


def test_plan_refuses_what_the_kernel_refuses():
    """Plans the kernel would refuse are refused, with the reason; the
    flagship's default plan."""
    refusal = k6_plans.refusal
    assert "cluster" in refusal(6, 2, 64, 128, SsdPlan(4, 2))  # 3 heads a group
    assert "cluster" in refusal(64, 1, 64, 128, SsdPlan(4, 16))  # past the portable limit
    assert "groups" in refusal(64, 1, 64, 16, SsdPlan(4, 1))  # 2 column tiles
    assert "warps" in refusal(64, 1, 48, 128, SsdPlan(1, 1))  # 3 warps
    assert "warps" in refusal(64, 1, 64, 128, SsdPlan(8, 1))  # 32 warps
    assert ssd_plan(2, 64, 64, 1, 64, 128, 132) == (4, 2)  # the flagship's: 16 warps
