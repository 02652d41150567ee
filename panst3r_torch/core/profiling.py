"""Profiling and phase timing (counterpart of panst3r_tpu/core/profiling.py
and tools/xplane_summary.py).

- ``PhaseTimer``: host seconds per named phase; ``phase(name, *block_on)``
  waits for the devices of the tensors it is given before it stops the
  clock, so a phase's card work is inside its time.
- ``trace(log_dir)``: a ``torch.profiler`` Chrome trace of the block (CPU
  activity, and CUDA activity where there is a card), written to
  ``log_dir/trace.json``.
- ``profile_by_kernel(fn, top)``: one traced call of ``fn`` on the card:
  device milliseconds by kernel name (CUPTI through ``torch.profiler``),
  the device's busy time and its idle share of the traced wall time.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *block_on):
        """Time the block; the devices of the tensors in ``block_on`` are
        synchronized before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {t.device for t in block_on}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.summary().items(),
                           key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:32s} {v['total_s']:8.3f}s "
                         f"x{v['count']:<4d} ({v['mean_s'] * 1e3:8.2f} ms)")
        return "\n".join(lines)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` and write the Chrome trace
    (Perfetto, chrome://tracing) to ``log_dir/trace.json``."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_by_kernel(fn, top: int = 15) -> dict:
    """One traced call of ``fn`` on the card: {wall_ms, device_busy_ms
    (the sum of kernel times), device_idle_share (of the traced wall),
    top: [{name, ms, calls}] by device time}.  Raises without a card."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_by_kernel measures the card; there is "
                           "no CUDA device")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):          # the tracer's own start-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "top": [{"name": k[:90], "ms": ms, "calls": n}
                    for k, (ms, n) in rows]}
