"""Backend selection, availability probe and error channel (counterpart of
``tpu_stark/backend/registry.py``).

* ``BackendKind`` and its string codec: ``"cuda"`` (the card, the default)
  and ``"cpu"`` (the kernels' plain torch versions);
* a process-global kind, read by ``app/`` and ``bench/`` through
  ``device()``; no other entry point reads it: ``create_config``, ``Dft``
  and the trace generators keep their explicit ``device``;
* ``record_error`` / ``take_last_error``, the polled error channel;
* ``is_cuda_available()``, the probe, which never raises.

The JAX package falls back to the CPU when the accelerator fails and only
records the error.  This module has no such fallback: with the ``cuda``
kind, ``device()`` raises when there is no card, and an error on the card
propagates to the caller.
"""

from __future__ import annotations

import enum
import threading
from typing import Optional

import torch


class BackendKind(enum.Enum):
    CUDA = "cuda"
    CPU = "cpu"

    @classmethod
    def from_str(cls, s: str) -> "BackendKind":
        try:
            return cls(s.strip().lower())
        except ValueError:
            raise ValueError(
                f"unknown backend {s!r}; expected one of {[k.value for k in cls]}"
            ) from None


_lock = threading.Lock()
_backend_kind: BackendKind = BackendKind.CUDA
_last_error: Optional[str] = None


def set_backend(kind: BackendKind | str) -> None:
    """Set the process-global backend."""
    global _backend_kind
    if isinstance(kind, str):
        kind = BackendKind.from_str(kind)
    with _lock:
        _backend_kind = kind


def backend_kind() -> BackendKind:
    with _lock:
        return _backend_kind


def device() -> torch.device:
    """The device of the current backend.  Raises for ``cuda`` when no card
    is present, instead of running elsewhere."""
    kind = backend_kind()
    if kind is BackendKind.CPU:
        return torch.device("cpu")
    if not is_cuda_available():
        raise RuntimeError(
            "the cuda backend needs a CUDA device, and torch.cuda.is_available() is false "
            "(select the cpu backend to run on the CPU)"
        )
    return torch.device("cuda")


def record_error(msg: str) -> None:
    """Stash an error for later polling."""
    global _last_error
    with _lock:
        _last_error = msg


def take_last_error() -> Optional[str]:
    """Pop the stashed error, clearing it."""
    global _last_error
    with _lock:
        err, _last_error = _last_error, None
        return err


def is_cuda_available() -> bool:
    """Whether a CUDA device is present.  Never raises."""
    try:
        return bool(torch.cuda.is_available())
    except Exception:  # noqa: BLE001 — the probe must not propagate
        return False
