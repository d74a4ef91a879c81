"""Unified-sampler pedagogy tool (the port of zonos_tpu/apps/sampler_explain.py;
the reference's unified_sampler_explain.py surface), host numpy only:

    python -m zonos_tpu_torch.apps.sampler_explain [--linear 0.55] [--sweep]

Shows how the NovelAI unified sampler reshapes a token distribution across
entropy levels for given (linear, conf, quad), using the canonical relation
``quad = 1/3 - linear*4/15`` and ``conf = -quad/2`` as the suggested start.
"""

from __future__ import annotations

import argparse

import numpy as np


def shaping_table(linear: float, conf: float, quad: float) -> str:
    entropies = np.arange(0.5, 5.25, 0.25)
    probs = np.array([0.001, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5])
    logp = np.log(probs)
    header = "entropy | " + " ".join(f"P={p:<7g}" for p in probs)
    lines = [header, "-" * len(header)]
    for H in entropies:
        scale = linear + H * conf - logp * quad
        shaped = np.exp(logp * scale)
        shaped = shaped / shaped.sum()
        cells = " ".join(f"{s:.4f}({s / p * 100:3.0f}%)"[:9].ljust(9) for s, p in zip(shaped, probs))
        lines.append(f"H={H:4.2f}  | {cells}")
    return "\n".join(lines)


def suggested_params(linear: float) -> tuple[float, float]:
    quad = 1.0 / 3.0 - linear * 4.0 / 15.0
    conf = -quad / 2.0
    return conf, quad


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Explain unified sampler shaping.")
    ap.add_argument("--linear", type=float, default=0.55)
    ap.add_argument("--conf", type=float, default=None)
    ap.add_argument("--quad", type=float, default=None)
    ap.add_argument("--sweep", action="store_true", help="Print tables for a linear sweep.")
    args = ap.parse_args(argv)

    sweeps = [0.3, 0.5, 0.7, 0.9] if args.sweep else [args.linear]
    for linear in sweeps:
        conf, quad = args.conf, args.quad
        if conf is None or quad is None:
            s_conf, s_quad = suggested_params(linear)
            conf = s_conf if conf is None else conf
            quad = s_quad if quad is None else quad
        print(f"\nUnified sampler: linear={linear:.2f} conf={conf:.3f} quad={quad:.3f}")
        print("(cells: reshaped probability and % of original)")
        print(shaping_table(linear, conf, quad))


if __name__ == "__main__":
    main()
