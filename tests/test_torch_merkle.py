"""The port's Keccak Merkle MMCS against the JAX package's, on the same
matrices and the same SmallRng salt stream: roots, digest layers, salts,
openings and path verification, with hiding and mixed-height injection.
Exact comparison."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_stark.commit.merkle import MerkleTreeMmcs as JMmcs
from tpu_stark.compat.smallrng import SmallRng as JRng
from tpu_stark_torch.commit.merkle import BatchOpening, MerkleTreeMmcs
from tpu_stark_torch.compat.smallrng import SmallRng
from tpu_stark_torch.fields import babybear as bb

SHAPES = [(16, 3), (8, 2), (16, 1), (4, 5)]  # two injected heights


def _mats(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, bb.P, size=s, dtype=np.uint32) for s in SHAPES]


def _both(hiding, seed=3):
    mats = _mats(seed)
    jm = JMmcs(hiding=hiding, rng=JRng.seed_from_u64(seed))
    tm = MerkleTreeMmcs(hiding=hiding, rng=SmallRng.seed_from_u64(seed))
    jroot, jdata = jm.commit([jnp.asarray(m) for m in mats])
    troot, tdata = tm.commit([bb.to_tensor(m, "cpu") for m in mats])
    return jm, tm, (jroot, jdata), (troot, tdata)


@pytest.mark.parametrize("hiding", [False, True])
def test_commit_matches_jax(hiding):
    jm, tm, (jroot, jdata), (troot, tdata) = _both(hiding)
    assert troot == jroot
    assert len(tdata.layers) == len(jdata.layers)
    for tl, jl in zip(tdata.layers, jdata.layers):
        assert np.array_equal(bb.to_numpy(tl), np.asarray(jl))
    if hiding:
        for ts, js in zip(tdata.salts, jdata.salts):
            assert np.array_equal(bb.to_numpy(ts), np.asarray(js))
        assert tm._rng.s == jm._rng.s  # the salt stream advanced alike
    else:
        assert tdata.salts is None


@pytest.mark.parametrize("hiding", [False, True])
def test_openings_match_jax_and_verify(hiding):
    jm, tm, (jroot, jdata), (troot, tdata) = _both(hiding, seed=4)
    idx = [0, 5, 15, 6]
    dims = [s for s in SHAPES]
    for to, jo, i in zip(tm.open_batch_many(idx, tdata), jm.open_batch_many(idx, jdata), idx):
        assert to.proof == jo.proof
        for a, b in zip(to.opened_values, jo.opened_values):
            assert np.array_equal(a, np.asarray(b))
        if hiding:
            for a, b in zip(to.opened_salts, jo.opened_salts):
                assert np.array_equal(a, np.asarray(b))
        assert tm.verify_batch(troot, dims, i, to)
        assert jm.verify_batch(jroot, dims, i, to)
        assert not tm.verify_batch(troot, dims, i ^ 1, to)
        bad = [v.copy() for v in to.opened_values]
        bad[1][0] ^= 1
        assert not tm.verify_batch(troot, dims, i, BatchOpening(bad, to.opened_salts, to.proof))


@pytest.mark.parametrize("hiding", [False, True])
def test_open_batch_matches_jax(hiding):
    """``open_batch(index, data)``, p3's single-index opening, equals JAX's
    and the batch opening's entry at every index."""
    jm, tm, (jroot, jdata), (troot, tdata) = _both(hiding, seed=5)
    many = tm.open_batch_many(range(16), tdata)
    for i in range(16):
        to, jo = tm.open_batch(i, tdata), jm.open_batch(i, jdata)
        assert to.proof == jo.proof == many[i].proof
        for a, b, c in zip(to.opened_values, jo.opened_values, many[i].opened_values):
            assert np.array_equal(a, np.asarray(b)) and np.array_equal(a, c)
        if hiding:
            for a, b in zip(to.opened_salts, jo.opened_salts):
                assert np.array_equal(a, np.asarray(b))
        else:
            assert to.opened_salts is None
        assert tm.verify_batch(troot, SHAPES, i, to)


def test_single_row_tree():
    m = np.arange(3, dtype=np.uint32)[None, :]
    troot, tdata = MerkleTreeMmcs().commit([bb.to_tensor(m, "cpu")])
    jroot, _ = JMmcs().commit([jnp.asarray(m)])
    assert troot == jroot and len(tdata.layers) == 1


@pytest.mark.parametrize("hiding", [False, True])
@pytest.mark.parametrize("shapes,runs", [
    (SHAPES, [1, 1, 2]),  # 16 rows, injections at 8 and 4
    ([(64, 2), (8, 3)], [3, 3]),  # one injection three levels up
    ([(32, 4)], [5]),  # no injection: one run to the root
])
def test_compress_layers_runs_between_injections(hiding, shapes, runs, monkeypatch):
    """The tree asks its hash stack for each run of compress layers up to
    the next injection height (``compress_layers``), injects there, and
    gives JAX's layers and root, with hiding too."""
    seen = []
    orig = MerkleTreeMmcs.compress_layers

    def noted(digests, levels):
        seen.append(levels)
        return orig(digests, levels)

    monkeypatch.setattr(MerkleTreeMmcs, "compress_layers", staticmethod(noted))
    rng = np.random.default_rng(7)
    mats = [rng.integers(0, bb.P, size=s, dtype=np.uint32) for s in shapes]
    jroot, jdata = JMmcs(hiding=hiding, rng=JRng.seed_from_u64(7)).commit([jnp.asarray(m) for m in mats])
    troot, tdata = MerkleTreeMmcs(hiding=hiding, rng=SmallRng.seed_from_u64(7)).commit(
        [bb.to_tensor(m, "cpu") for m in mats])
    assert seen == runs
    assert troot == jroot and len(tdata.layers) == len(jdata.layers)
    for tl, jl in zip(tdata.layers, jdata.layers):
        assert np.array_equal(bb.to_numpy(tl), np.asarray(jl))
