"""FRI parameters (p3-fri ``FriParameters`` shape; counterpart of
``tpu_stark/fri/config.py``, the same defaults).

``create_test_fri_params(log_blowup=2)``: few queries and one grinding bit,
fast and insecure, for parity and round-trip tests.
``create_benchmark_fri_params(log_blowup=1)``: the production setting,
100 queries and 16 grinding bits.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FriParameters:
    log_blowup: int = 1
    log_final_poly_len: int = 0
    num_queries: int = 100
    proof_of_work_bits: int = 16

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup


def create_test_fri_params(log_blowup: int = 2) -> FriParameters:
    return FriParameters(
        log_blowup=log_blowup,
        log_final_poly_len=0,
        num_queries=2,
        proof_of_work_bits=1,
    )


def create_benchmark_fri_params(log_blowup: int = 1) -> FriParameters:
    return FriParameters(
        log_blowup=log_blowup,
        log_final_poly_len=0,
        num_queries=100,
        proof_of_work_bits=16,
    )
