"""device_idle_pct: 100 x (1 - the union of device activity over the
profiled proofs' wall clock), from the profile: an upper bound, since the
profiler adds host cost."""

LAYER = "device"
UNIT = "%"
MOVES = "prove_s"


def read(rec):
    r = rec.reading
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
