"""FRI parameters: the JAX package's jax-free ``tpu_stark.fri.config``,
shared as is."""

from tpu_stark.fri.config import (  # noqa: F401
    FriParameters,
    create_benchmark_fri_params,
    create_test_fri_params,
)
