"""The one traffic generator: a closed loop of proof jobs read from a mix
file (``traffic/<name>.json``).

``witnesses``: how many witnesses set-up makes from the seed; job j proves
witness j mod ``witnesses``.  Every job draws its own zk ``rng_seed`` from
(seed, j), so no two jobs of a run make the same proof.  ``in_flight``: jobs
in flight at once (a closed loop of one: each job starts when the previous
proof's bytes are on the host).
"""

from __future__ import annotations

import hashlib


def mix(seed: int, *tags) -> int:
    """A 63-bit number drawn from the run's seed and ``tags``, the same on
    every machine."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def witness_seed(seed: int, i: int) -> int:
    return mix(seed, "witness", i)


def rng_seed(seed: int, kind: str, j: int) -> int:
    """A job's zk seed, in [1, 2^31): the device rng keys on 32 bits."""
    return 1 + mix(seed, kind, j) % (2**31 - 1)


def check(traffic: dict) -> dict:
    if traffic.get("in_flight", 1) != 1:
        raise ValueError("the closed loop keeps one job in flight")
    if int(traffic["witnesses"]) < 1:
        raise ValueError("a mix needs at least one witness")
    return traffic
