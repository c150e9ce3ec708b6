"""The frozen roofline arithmetic: the H100's peaks and the least work
(bytes and int32 instructions) each of the port's kernel wrappers needs for
one call, priced from the call's operands (``calls.py``).

Copied from ``chip_smoke.py``'s bound functions and ``port_timing.py``'s
``_Bounds`` at the commit that added the benchmark, and owned by the
benchmark from then on: a change to the program does not change how its
work is priced.  Only a PR that changes the benchmark may correct this.
"""
