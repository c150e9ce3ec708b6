"""The plain reference: the whole zk proof of a configuration's statement,
made from the protocol in plain torch (``uni_stark.py``) over the AIR the
configuration names (``reference.air``, a module of this package), with the
configuration's FRI parameters.  It imports nothing of ``tpu_stark_torch``
and nothing of JAX, and takes nothing that the program made: the witness and
the zk seed are the benchmark's, and every value it commits it computes
again."""

from __future__ import annotations

import importlib

from . import uni_stark


def proof_bytes(config: dict, trace, public_values, rng_seed: int, device) -> bytes:
    """The serialized proof of ``config``'s statement over ``trace`` (host
    (n, w) canonical u32) with the zk randomness of ``rng_seed``."""
    stack = config["stack"]
    if (stack["hash"], stack["zk"], stack["zk_rng"]) != ("keccak", True, "device"):
        raise ValueError(f"the reference proves the zk Keccak stack with the device rng, not {stack}")
    mod, name = config["reference"]["air"].split(":")
    air = getattr(importlib.import_module(f"{__name__}.{mod}"), name)()
    return uni_stark.prove(config["fri"], air, trace, public_values, rng_seed, device)
