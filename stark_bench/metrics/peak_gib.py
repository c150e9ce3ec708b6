"""peak_gib: the allocator's peak over the window (reset after set-up), the
resident witnesses included: a prover holds its next job."""

UNIT = "GiB"


def read(rec):
    return rec.window_peak_bytes / 2**30 if rec.window_peak_bytes else None
