"""Witness makers, one module a configuration's ``air``: ``make(rows, seed,
device)`` returns ``(trace, public_values)`` for a trace of ``rows`` rows made
from the whole number ``seed`` alone, the same on every machine."""
