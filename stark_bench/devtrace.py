"""The traced run's readings from ``torch.profiler``: device time by prove
phase, the union of device activity, the idle gaps and what the host was
doing in them, and the device operations that took the most time.

A phase ends where the prover's ``timings`` entry is written, after a device
synchronize (``prover/prove.py::phase_timer``): ``PhaseMarks`` puts a
profiler mark there, so every device operation that starts after the
previous mark and before this one belongs to this phase.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MARK = "bench_phase_end:"
TOP = 10


class PhaseMarks(dict):
    """A prove's ``timings``: each phase's seconds, its end marked in the
    profile (when one records) and its name kept in order."""

    def __init__(self):
        super().__init__()
        self.order: List[str] = []

    def __setitem__(self, phase, seconds):
        super().__setitem__(phase, seconds)
        self.order.append(phase)
        with torch.profiler.record_function(f"{MARK}{phase}"):
            pass


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Reading:
    """What one profile of whole proves says (times in seconds)."""

    def __init__(self, prof):
        events = list(prof.events())
        cuda = torch.autograd.DeviceType.CUDA
        # the profile covers the profiled jobs and nothing else: its span is the window
        self.window: Tuple[float, float] = (min(e.time_range.start for e in events),
                                            max(e.time_range.end for e in events))
        marks = sorted((e.time_range.start, e.name[len(MARK):]) for e in events
                       if e.name.startswith(MARK) and e.device_type != cuda)  # a label may show on both sides
        events = [e for e in events if not e.name.startswith(MARK)]
        self._mark_t = [t for t, _ in marks]
        self._mark_p = [p for _, p in marks]
        lo, hi = self.window
        dev = [e for e in events if e.device_type == cuda]
        self.device_by_phase: Dict[str, float] = {}
        by_op: Dict[str, float] = {}
        spans = []
        for e in dev:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            phase = self.phase_at(s)
            self.device_by_phase[phase] = self.device_by_phase.get(phase, 0.0) + (t - s) / 1e6
            by_op[e.name] = by_op.get(e.name, 0.0) + (t - s) / 1e6
        busy = _union(spans)
        self.window_s = (hi - lo) / 1e6
        self.busy_s = sum(min(t, hi) - max(s, lo) for s, t in busy) / 1e6
        self.device_ops = sorted(([k[:120], v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:TOP]
        self.idle_gaps = self._gaps(busy, [e for e in events if e.device_type != cuda])

    def phase_at(self, t: float) -> str:
        """The phase whose end mark is the first at or after ``t``."""
        i = bisect.bisect_left(self._mark_t, t)
        return self._mark_p[i] if i < len(self._mark_p) else "after"

    def _gaps(self, busy, host) -> List[list]:
        """The idle time of the window by what the host was doing at each
        gap's middle (the innermost host operation there, and its phase),
        the largest totals first."""
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
        starts = np.array([e.time_range.start for e in host], dtype=np.float64)
        ends = np.array([e.time_range.end for e in host], dtype=np.float64)
        names = [e.name for e in host]
        total: Dict[str, float] = {}
        for s, e in gaps:
            mid = (s + e) / 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            op: Optional[str] = None
            if inside.size:
                op = names[int(inside[np.argmin(ends[inside] - starts[inside])])]
            key = f"{self.phase_at(mid)}: {op or 'no host op'}"[:120]
            total[key] = total.get(key, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]
