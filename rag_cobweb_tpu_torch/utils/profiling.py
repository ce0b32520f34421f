"""Tracing and profiling (port of ``rag_cobweb_tpu/utils/profiling.py``,
on ``torch.profiler`` where the JAX package used ``jax.profiler``):

  * ``PhaseTimer``: accumulating named phases of wall time; on the card
    each phase starts and ends with ``torch.cuda.synchronize(device)``, so
    a phase holds the device work it queued;
  * ``trace(log_dir)``: a ``torch.profiler.profile`` of the host and, on
    the card, the device, exported as a Chrome trace into ``log_dir``;
  * ``annotate(name)``: ``torch.profiler.record_function``, a named range
    in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from rag_cobweb_tpu_torch.device import resolve_device


class PhaseTimer:
    """Accumulating named-phase wall timer.  ``sync``: on a CUDA
    ``device``, synchronize it at each phase's start and end (on the host
    there is nothing to wait for)."""

    def __init__(self, sync: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.sync = sync and self.device.type == "cuda"
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':<28} {'total_s':>9} {'calls':>6} {'mean_ms':>9}"]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<28} {total:>9.3f} {n:>6} {1000 * total / n:>9.3f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: {"total_s": self.totals[name],
                       "calls": self.counts[name]}
                for name in self.totals}


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` (host activity, and the
    device's on a CUDA ``device``) and write its Chrome trace to
    ``log_dir/trace.json``.  Yields the profiler, whose ``key_averages()``
    sum the recorded events by name once the block has ended."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named range visible in the profiler's trace."""
    return torch.profiler.record_function(name)
