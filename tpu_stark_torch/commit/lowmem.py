"""The low-memory mode's settings (counterpart of ``tpu_stark/commit/lowmem.py``).

Three levers engage at committed heights at or above a threshold, and
change no byte of a proof:

* **lazy salts**: a hiding commit whose rng is counter-based (``DeviceRng``)
  hashes a transient salt matrix and keeps only its draw (``LazyMatrix``);
  the openings draw the opened rows alone;
* **dropped digest layers**: a single-height tree releases its
  ``DROP_LAYERS`` leaf-most digest layers once the root is known; the
  openings rebuild the missing siblings by hashing the 2^K-aligned block of
  leaf rows around each query;
* **released codewords**: after its tree is built, a committed codeword
  is replaced by its h-row coefficients, and every later reader recomputes
  the LDE (``commit/pcs.py::_LazyLde``).

The JAX package reads the threshold from an environment variable and sets
it at 2^24 rows, where retained state starts crowding its 16 GiB chip.
Here the threshold is an argument (``create_config(lowmem_log=)``, carried
by the MMCS instances and the PCS) whose default scales that height with
the card's memory (``default_log``): 2^24 where no card is known (the
CPU), 2^27 on an 80 GB card, where config 2 proves every height below
BabyBear's two-adic limit without the levers.
"""

from __future__ import annotations

import math

import torch

from ..backend.policy import current_policy

LOWMEM_LOG = 24  # the JAX package's threshold: log2 of a committed height; 0 disables the levers
REF_MEMORY = 16 << 30  # bytes of the chip that threshold was set for
DROP_LAYERS = 3  # leaf-most digest layers a tree at or above the threshold releases


def default_log(device) -> int:
    """The threshold for ``device``: ``LOWMEM_LOG`` scaled by the card's
    memory over ``REF_MEMORY`` (the first power-of-two height at or above
    the scaled one); ``LOWMEM_LOG`` on the CPU, and for a CUDA device on a
    machine without a card, where a prove raises at its first launch."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return LOWMEM_LOG
    return scaled_log(current_policy(dev).total_memory)


def scaled_log(total_memory: int) -> int:
    """``LOWMEM_LOG`` scaled by ``total_memory`` bytes over ``REF_MEMORY``,
    rounded up to a whole log2 height."""
    return max(1, LOWMEM_LOG + math.ceil(math.log2(total_memory / REF_MEMORY)))


def lowmem_rows(log: int) -> int:
    """The committed height (rows) at or above which the levers engage for
    a threshold of 2^log; 0 (no height) when ``log`` is 0."""
    log = int(log)
    if log < 0:
        raise ValueError(f"lowmem_log must be 0 (off) or a log2 height, got {log}")
    return 1 << log if log else 0


def engaged(threshold_rows: int, height: int) -> bool:
    """Whether a committed height of ``height`` rows is at or above an
    enabled threshold."""
    return bool(threshold_rows) and height >= threshold_rows
