"""What the metric readers (``metrics/<name>.py``) share: a phase's mean
seconds a proof from the prover's own marks, and a phase's roofline share
from the profile and the priced wrapper calls (``roofline/``)."""

from __future__ import annotations

from typing import Optional, Sequence


def phase_seconds(rec, phases: Sequence[str]) -> Optional[float]:
    """Mean seconds a traced proof spends in ``phases`` (the prover's
    ``timings``, a device synchronize at each phase end)."""
    if not rec.phases:
        return None
    return sum(sum(p.get(k, 0.0) for k in phases) for p in rec.phases) / len(rec.phases)


def roofline_pct(rec, phases: Sequence[str]) -> Optional[float]:
    """100 x the summed bounds of the wrapper calls made in ``phases`` over
    those phases' device time (every kernel and copy, plain torch passes
    included), in the profiled proofs; nothing where either is 0."""
    r = rec.reading
    if r is None:
        return None
    device_s = sum(r.device_by_phase.get(k, 0.0) for k in phases)
    bound_s = sum(rec.priced_ms.get(k, 0.0) for k in phases) / 1e3
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
