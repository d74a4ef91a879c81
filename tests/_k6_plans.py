"""K6's launch plans as its kernel takes them, shared by the CPU model of the
kernel (``test_torch_port_ssd.py``) and the card tests (``test_torch_port_cuda.py``).
The source is ``layout`` and ``config`` in ``zonos_tpu_torch/csrc/ssd_chunked.cu``;
this is a copy for the CPU, which the card test holds against the kernel's own
``zt_ssd_chunked_smem``."""

from __future__ import annotations

import itertools

from zonos_tpu_torch.kernels.ssd import CHUNK, SsdPlan

MAX_SMEM = 232448  # 227 KB, a Hopper block's most (kMaxSmem)
MAX_WARPS, MAX_CLUSTER = 16, 8  # kMaxWarps, and kMaxCluster (the portable limit)


def m_tiles(P: int) -> int:
    """16-row tiles of P: a warp's rows of the state."""
    return -(-P // 16)


def npad(N: int) -> int:
    """N rounded up to 16, as B and C are staged."""
    return -(-N // 16) * 16


def warps(P: int, plan: SsdPlan) -> int:
    return m_tiles(P) * plan.groups


def smem_bytes(P: int, N: int, plan: SsdPlan) -> int:
    """The kernel's dynamic shared memory for this plan (``layout``)."""
    mt, c, w = m_tiles(P), plan.cluster, warps(P, plan)
    sx, sb, wdt = 16 * mt + 8, npad(N) + 8, CHUNK // c
    scb = wdt + 8 if wdt % 16 == 0 else wdt
    bc = max(2 * CHUNK * sb, w * 8 * 128)
    stage = CHUNK * sx + bc
    slices = (2 if c > 1 else 1) * CHUNK * scb
    return 4 * (2 * stage + CHUNK * (CHUNK + 4) + slices + 4 * CHUNK)  # + s, exp(s), wd, dt


def refusal(H: int, G: int, P: int, N: int, plan: SsdPlan) -> str | None:
    """Why the kernel refuses this plan (``config``'s checks), or None."""
    groups, cluster = plan
    if groups not in (1, 2, 4, 8) or (npad(N) // 8) % groups:
        return f"groups {groups} does not divide N's {npad(N) // 8} tiles of 8"
    if cluster not in (1, 2, 4, 8) or (H // G) % cluster:
        return f"cluster {cluster} does not divide the {H // G} heads of a group"
    if warps(P, plan) > MAX_WARPS or warps(P, plan) % 2:
        return f"{warps(P, plan)} warps (an even number up to {MAX_WARPS})"
    if smem_bytes(P, N, plan) > MAX_SMEM:
        return "shared memory"
    return None


def plans(H: int, G: int, P: int, N: int) -> list[SsdPlan]:
    """Every plan the kernel takes at these widths."""
    every = itertools.product((1, 2, 4, 8), (1, 2, 4, 8))
    return [SsdPlan(g, c) for g, c in every if refusal(H, G, P, N, SsdPlan(g, c)) is None]
