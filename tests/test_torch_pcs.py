"""The port's TwoAdicFriPcs against the JAX package's.

``test_jax_commit_port_open``: JAX commits; the committed state crosses
through ``compat.from_jax`` (numpy only) with the rng states; the port opens
and must produce JAX's opened values and FRI proof exactly, and its verifier
must accept.  The other tests compare the port's own commit and domain
evaluations with JAX's, and hold the verifier's per-query reduction to the
field arithmetic and to a tampered opening.  Heights stay at or below 2^6
rows."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_stark.challenger.challenger import Challenger as JChallenger
from tpu_stark.fri.domains import TwoAdicCoset as JCoset
from tpu_stark.prover.config import create_config as j_create_config
from tpu_stark_torch.challenger.challenger import Challenger
from tpu_stark_torch.commit import pcs as pcs_mod
from tpu_stark_torch.compat import from_jax
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fields import ref_field as rf
from tpu_stark_torch.fri.config import create_benchmark_fri_params
from tpu_stark_torch.fri.domains import TwoAdicCoset
from tpu_stark_torch.prover.config import create_config


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


ZETA = (123456, 789, 1011, 1213)


def _evals(seed, log_n, w):
    return np.random.default_rng(seed).integers(0, bb.P, size=(1 << log_n, w), dtype=np.uint32)


def _configs(layout):
    jcfg = j_create_config(zk=True, backend="cpu", zk_rng="smallrng", zk_layout=layout)
    tcfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device="cpu")
    return jcfg.pcs, tcfg.pcs


def _same_opening(t, j):
    assert t.proof == j.proof
    assert len(t.opened_values) == len(j.opened_values)
    for a, b in zip(t.opened_values, j.opened_values):
        assert np.array_equal(a, np.asarray(b))
    assert (t.opened_salts is None) == (j.opened_salts is None)
    if t.opened_salts is not None:
        for a, b in zip(t.opened_salts, j.opened_salts):
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_jax_commit_port_open(layout):
    jpcs, tpcs = _configs(layout)
    log_n = 5
    evals = _evals(1, log_n, 2)
    jroot, jdata = jpcs.commit([(JCoset(log_n, 1), jnp.asarray(evals))])

    # carry the committed state and both rng streams across
    m = jdata.merkle
    tdata = from_jax.prover_data_from_numpy(
        matrices=[np.asarray(x) for x in m.matrices],
        salts=None if m.salts is None else [np.asarray(s) for s in m.salts],
        layers=[np.asarray(l) for l in m.layers],
        root=m.root,
        r_coeffs=[np.asarray(r) for r in jdata.r_coeffs],
        domains=[(d.log_n, d.shift) for d in jdata.domains],
        widths=jdata.widths,
        device="cpu",
    )
    tpcs.rng = from_jax.smallrng_from_state(jpcs.rng.s)
    tpcs.val_mmcs._rng = from_jax.smallrng_from_state(jpcs.val_mmcs._rng.s)

    zeta2 = TwoAdicCoset(log_n, 1).next_point_ext(ZETA)
    jc, tc = JChallenger(), Challenger()
    jc.observe_commitment(jroot)
    tc.observe_commitment(jroot)
    j_opened, j_proof = jpcs.open([(jdata, [[ZETA, zeta2]])], jc)
    t_opened, t_proof = tpcs.open([(tdata, [[ZETA, zeta2]])], tc)

    assert t_opened == [[[list(map(tuple, p)) for p in mp] for mp in r] for r in j_opened]
    assert t_proof.commit_phase_commits == j_proof.commit_phase_commits
    assert t_proof.final_poly == j_proof.final_poly
    assert t_proof.pow_witness == j_proof.pow_witness
    assert t_proof.random_commit == j_proof.random_commit
    assert len(t_proof.query_proofs) == len(j_proof.query_proofs)
    for tq, jq in zip(t_proof.query_proofs, j_proof.query_proofs):
        for a, b in zip(tq.input_openings, jq.input_openings):
            _same_opening(a, b)
        for a, b in zip(tq.commit_phase_openings, jq.commit_phase_openings):
            _same_opening(a.opening, b.opening)
    assert tc.sample_u32() == jc.sample_u32()  # transcripts end in one state

    # the port's verifier accepts the port's proof
    vc = Challenger()
    vc.observe_commitment(jroot)
    _, vpcs = _configs(layout)
    rounds = [(jroot, [(TwoAdicCoset(log_n, 1), [(ZETA, t_opened[0][0][0]), (zeta2, t_opened[0][0][1])])])]
    assert vpcs.verify(rounds, t_proof, vc)


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_commit_matches_jax(layout):
    jpcs, tpcs = _configs(layout)
    # two matrices on one height and one on another: grouped transforms and
    # different coset shifts (as the quotient chunks are)
    items = [(4, 1, 3), (4, 7, 2), (3, 1, 4)]
    jitems, titems = [], []
    for i, (log_n, shift, w) in enumerate(items):
        e = _evals(10 + i, log_n, w)
        jitems.append((JCoset(log_n, shift), jnp.asarray(e)))
        titems.append((TwoAdicCoset(log_n, shift), bb.to_tensor(e, "cpu")))
    jroot, jdata = jpcs.commit(jitems)
    troot, tdata = tpcs.commit(titems)
    assert troot == jroot
    for a, b in zip(tdata.r_coeffs, jdata.r_coeffs):
        assert np.array_equal(bb.to_numpy(a), np.asarray(b))
    for a, b in zip(tdata.merkle.matrices, jdata.merkle.matrices):
        assert np.array_equal(bb.to_numpy(a), np.asarray(b))
    assert tpcs.rng.s == jpcs.rng.s


def test_evaluations_on_domain_match_jax():
    jpcs, tpcs = _configs("tpu")
    e = _evals(20, 4, 2)
    _, jdata = jpcs.commit([(JCoset(4, 1), jnp.asarray(e))])
    _, tdata = tpcs.commit([(TwoAdicCoset(4, 1), bb.to_tensor(e, "cpu"))])
    for log_m in (4, 5, 6):
        jd = JCoset(4, 1).create_disjoint_domain(1 << log_m)
        td = TwoAdicCoset(4, 1).create_disjoint_domain(1 << log_m)
        want = np.asarray(jpcs.get_evaluations_on_domain(jdata, 0, jd))
        assert np.array_equal(bb.to_numpy(tpcs.get_evaluations_on_domain(tdata, 0, td)), want)


def _field_fold(apows, vals, ext_vals):
    """sum_k apows[k] * vals[k], one ext product and add per column."""
    acc = (0, 0, 0, 0)
    for k in range(len(apows)):
        v = tuple(int(c) for c in vals[k]) if ext_vals else rf.efrom_base(int(vals[k]))
        acc = rf.eadd(acc, rf.emul(tuple(int(c) for c in apows[k]), v))
    return acc


@pytest.mark.parametrize("ext_vals", [False, True])
@pytest.mark.parametrize("fill", ["random", "p_minus_1"])
def test_dot_ext_matches_the_field_fold(ext_vals, fill):
    """The verifier's per-query reduction (int64 numpy) is exact at a
    keccak-air row's width, also with every operand at p - 1."""
    w = 3608
    rng = np.random.default_rng(7)
    shape = (w, 4) if ext_vals else (w,)
    if fill == "random":
        apows = rng.integers(0, bb.P, size=(w, 4), dtype=np.int64)
        vals = rng.integers(0, bb.P, size=shape, dtype=np.int64)
    else:
        apows = np.full((w, 4), bb.P - 1, dtype=np.int64)
        vals = np.full(shape, bb.P - 1, dtype=np.int64)
    assert pcs_mod._dot_ext(apows, vals) == _field_fold(apows, vals, ext_vals)


def test_verifier_rejects_a_tampered_opened_value(monkeypatch):
    """With the transcript's multi-value observations switched off on both
    sides, the opened values no longer steer alpha, the betas, the PoW or
    the query indices: a proof with one opened value off by one then passes
    every Merkle and PoW check, and only the per-query reduced openings
    (``pcs._dot_ext`` against the claimed values) can reject it.  They must;
    the untouched proof is accepted."""
    log_n = 5
    cfg = create_config(create_benchmark_fri_params(1), zk=False, hash="poseidon2", device="cpu")
    monkeypatch.setattr(type(cfg.challenger()), "observe_u32s", lambda self, values: None)
    pcs = cfg.pcs
    dom = TwoAdicCoset(log_n, 1)
    root, data = pcs.commit([(dom, bb.to_tensor(_evals(30, log_n, 3), "cpu"))])
    zeta2 = dom.next_point_ext(ZETA)
    opened, proof = pcs.open([(data, [[ZETA, zeta2]])], cfg.challenger())
    at_zeta, at_zeta2 = opened[0][0]

    def verify(values_at_zeta):
        rounds = [(root, [(dom, [(ZETA, values_at_zeta), (zeta2, at_zeta2)])])]
        return pcs.verify(rounds, proof, cfg.challenger())

    assert verify(at_zeta)
    tampered = list(at_zeta)
    tampered[1] = ((tampered[1][0] + 1) % bb.P,) + tuple(tampered[1][1:])
    assert not verify(tampered)
