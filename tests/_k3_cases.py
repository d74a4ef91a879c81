"""K3's parameter points and operands, shared by the CPU tests of its plain
version and model (``test_torch_port_sampling.py``) and the card tests of its
kernel (``test_torch_port_cuda.py``).  ``chip_smoke.py`` keeps its own copy."""

from __future__ import annotations

import numpy as np

DEFAULT = dict(linear=0.55, conf=0.4, quad=0.0, min_p=0.0, temperature=1.0)
# every branch of K3's function
POINTS = {
    "default": DEFAULT,
    "min_p 0.1": {**DEFAULT, "min_p": 0.1},
    "T 0.7": {**DEFAULT, "temperature": 0.7},
    "quad 0.1": {**DEFAULT, "quad": 0.1},
    "linear 0": {**DEFAULT, "linear": 0.0},
    "linear 0, min_p 0.1": {**DEFAULT, "linear": 0.0, "min_p": 0.1},
    # lin = linear + H conf < 0 on most rows: the warp route's reduction for raw's max (and
    # the reshaping reversed: the known rows' ids no longer hold)
    "conf -1": {**DEFAULT, "conf": -1.0},
}
NEAR_TIE = 1e-4  # ids may differ where the plain version's top two scores lie this close


def operands(seed: int, B: int, V: int, K: int = 9, gumbel=None):
    """Logits [B, K, V] (at V 1152 the decode path's padding from 1025 on),
    Gumbel noise (drawn by numpy unless given), and the rows whose id is known:
    (0, 0) has one finite logit, as in EOS mode; (0, 1) has two equal top
    logits far above the rest, with equal noise, where the lower index wins.
    fp32 numpy arrays and {(b, k): id}."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, K, V)) * 3.0).astype(np.float32)
    valid = 1025 if V == 1152 else V
    logits[..., valid:] = -np.inf
    if gumbel is None:
        u = rng.uniform(size=(B, K, V))  # float64 in [0, 1): finite noise
        gumbel = -np.log(-np.log(np.maximum(u, np.finfo(np.float64).tiny)))
    gumbel = np.array(gumbel, dtype=np.float32)
    eos, lo, hi = valid // 3, 5, valid - 7
    logits[0, 0] = -np.inf
    logits[0, 0, eos] = 0.0
    logits[0, 1, [lo, hi]] = logits[0, 1].max() + 20.0
    gumbel[0, 1, [lo, hi]] = gumbel[0, 1, lo]
    return logits, gumbel, {(0, 0): eos, (0, 1): lo}
