"""Profiling / tracing hooks (port of isaacgymenvs_ma_tpu/utils/profiling.py;
the reference only surfaces rl_games step timers — SURVEY.md §5).

``trace`` captures a ``torch.profiler`` session around a code region (the
CPU, and the card's kernels when CUDA is present) and exports it as a
Chrome trace (``logdir/trace.json``, viewable in chrome://tracing or
Perfetto); ``annotate`` names a region in that trace (a
``record_function``) and, on CUDA, in NVTX; ``StepTimer`` is a copy of the
JAX package's play_time/update_time/step_time breakdown
(learning/A2CAgent_MA.py:13-36).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

# the file ``trace`` exports into its logdir
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str = "runs/torch-trace"):
    """Capture a trace: ``with profiling.trace('runs/trace') as prof:
    step()``; on exit ``logdir/trace.json`` holds it (``prof.trace_path``).
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.trace_path = os.path.join(logdir, TRACE_FILE)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in traces: a ``record_function`` and, when
    CUDA is present, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock phase timers (the step/play/update-time breakdown)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {f"{k}_time_ms": 1e3 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}
