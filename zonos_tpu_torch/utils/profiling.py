"""Phase timing and device profiling (zonos_tpu/utils/profiling.py).

- :class:`PhaseTimer`: named wall-clock phases with a printed summary (the
  reference's pytictoc role), as the JAX package has it.
- :func:`device_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``trace.json``, viewable in ``chrome://tracing`` or
  Perfetto) into a directory; used by the CLI's ``--profile``.  JAX's writes
  an XPlane trace through ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("zonos_tpu_torch.profiling")


class PhaseTimer:
    """Accumulates named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("load"): ...
    >>> with t.phase("generate"): ...
    >>> t.report()
    """

    def __init__(self, printer=print):
        self._printer = printer
        self.durations: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            self._printer(f"[t] {name}: {dt:.1f}s")

    def report(self) -> None:
        total = sum(self.durations.values())
        for name, dt in self.durations.items():
            self._printer(f"[t] {name:16s} {dt:8.2f}s  ({dt / total:5.1%})")
        self._printer(f"[t] {'total':16s} {total:8.2f}s")


@contextlib.contextmanager
def device_trace(out_dir: str | None):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where
    there is one) into ``out_dir/trace.json`` (a no-op when ``out_dir`` is
    empty)."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s (view in chrome://tracing or Perfetto)", path)
