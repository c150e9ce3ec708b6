"""The port's distributed NTT (``tpu_stark_torch/dist/ntt.py``) against the
JAX package's sharded functions (``tpu_stark/dist/ntt.py``) on the
conftest's 8-device virtual CPU mesh.

The port's side runs once: four gloo ranks on the CPU (one torch thread
each) run every case, the 2-rank case on the subgroup of ranks 0 and 1.
Each rank returns its block; the blocks in rank order must equal JAX's
global output exactly.  Every JAX shard_map program costs a compile, so
the shapes are few: (256, 8) at 4 ranks, one of ``tests/test_dist_ntt.py``'s,
and (1024, 2) at 2 ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_stark.dist import ntt as jntt
from tpu_stark.fields import babybear as jbb
from tpu_stark_torch.dist import ntt as dntt
from tpu_stark_torch.dist.dryrun import ntt_rank, run_plan, run_ranks

SHIFT = 7 * jbb.GENERATOR % jbb.P  # a coset shift other than the generator


def _rand(h, w, seed):
    return jbb.np_to_monty(np.random.default_rng(seed).integers(0, jbb.P, size=(h, w)).astype(np.uint32))


X256 = _rand(256, 8, 0)
X1024 = _rand(1024, 2, 1)

# (case id, ranks, dist.ntt function, global input, its further arguments,
#  the JAX output for the global input)
CASES = [
    ("dft_br_4", 4, "dft_br", X256, (8,), lambda m, x: jntt.dft_br_fn(m, 8)(x)),
    ("idft_from_br_4", 4, "idft_from_br", X256, (8,), lambda m, x: jntt.idft_from_br_fn(m, 8)(x)),
    ("bitrev_reshard_4", 4, "bitrev_reshard", X256, (8,), lambda m, x: jntt.bitrev_reshard_fn(m, 8)(x)),
    ("scale_rows_by_powers_4", 4, "scale_rows_by_powers", X256, (8, SHIFT),
     lambda m, x: jntt.scale_rows_by_powers_fn(m, 8, SHIFT)(x)),
    ("coset_lde_br_4_b1", 4, "coset_lde_br", X256, (1, SHIFT), lambda m, x: jntt.coset_lde_br(m, x, 1, SHIFT)),
    ("coset_lde_br_4_b2", 4, "coset_lde_br", X256, (2, SHIFT), lambda m, x: jntt.coset_lde_br(m, x, 2, SHIFT)),
    ("dft_br_2", 2, "dft_br", X1024, (10,), lambda m, x: jntt.dft_br_fn(m, 10)(x)),
]


@pytest.fixture(scope="module")
def blocks():
    """Every case's blocks, by case id: one spawn of four ranks."""
    plan = [(size, [(ntt_rank, ([(name, x, args) for _, s, name, x, args, _ in CASES if s == size],))])
            for size in (4, 2)]
    per_rank = run_ranks(4, run_plan, plan, device="cpu")
    out = {}
    for g, (size, _) in enumerate(plan):
        ids = [cid for cid, s, *_ in CASES if s == size]
        for k, cid in enumerate(ids):
            out[cid] = [per_rank[r][g][0][k] for r in range(size)]
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_ntt_equals_jax(blocks, case):
    cid, size, _name, x, _args, jax_fn = case
    want = np.asarray(jax_fn(jntt.make_row_mesh(size), jnp.asarray(x)))
    got = np.concatenate(blocks[cid], axis=0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bitrev_reshard_needs_n_squared_rows():
    """H < n^2 cannot be resharded by one all-to-all: it raises before any
    collective (a one-rank-of-four mesh object, no process group)."""
    import torch

    from tpu_stark_torch.dist.comm import RowMesh

    mesh = RowMesh(None, 1, 4, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="n\\^2"):
        dntt.bitrev_reshard(mesh, torch.zeros((2, 3), dtype=torch.int32), 3)
