"""Proof container + deterministic byte serialization (counterpart of
``tpu_stark/prover/proof.py``; the same canonical little-endian format: u32
field elements, u64 digest words, u32 lengths), so proofs are byte-stable
across runs, devices and the two packages.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Tuple

import numpy as np

from ..commit.merkle import BatchOpening, Digest
from ..commit.pcs import CommitPhaseStep, FriProof, QueryProof

ExtVal = Tuple[int, int, int, int]


@dataclasses.dataclass
class Commitments:
    trace: Digest
    quotient_chunks: Digest


@dataclasses.dataclass
class OpenedValues:
    trace_local: List[ExtVal]
    trace_next: List[ExtVal]
    quotient_chunks: List[List[ExtVal]]  # [chunk][ext-coeff column]


@dataclasses.dataclass
class Proof:
    commitments: Commitments
    opened_values: OpenedValues
    opening_proof: FriProof
    degree_bits: int
    log_quotient_degree: int


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------
def _w_u32(b, v):
    b.write(struct.pack("<I", int(v)))


def _w_u64(b, v):
    b.write(struct.pack("<Q", int(v)))


def _w_digest(b, d: Digest):
    # length-prefixed: supports 4xu64 Keccak digests and 8-field Poseidon2
    _w_u32(b, len(d))
    for w in d:
        _w_u64(b, w)


def _w_ext(b, e: ExtVal):
    for c in e:
        _w_u32(b, c)


def _w_opening(b, op: BatchOpening):
    _w_u32(b, len(op.opened_values))
    for row in op.opened_values:
        _w_u32(b, len(row))
        for v in row:
            _w_u32(b, v)
    _w_u32(b, 0 if op.opened_salts is None else 1)
    if op.opened_salts is not None:
        _w_u32(b, len(op.opened_salts))
        for row in op.opened_salts:
            _w_u32(b, len(row))
            for v in row:
                _w_u32(b, v)
    _w_u32(b, len(op.proof))
    for d in op.proof:
        _w_digest(b, d)


def serialize_proof(p: Proof) -> bytes:
    b = io.BytesIO()
    _w_u32(b, p.degree_bits)
    _w_u32(b, p.log_quotient_degree)
    _w_digest(b, p.commitments.trace)
    _w_digest(b, p.commitments.quotient_chunks)
    ov = p.opened_values
    _w_u32(b, len(ov.trace_local))
    for e in ov.trace_local:
        _w_ext(b, e)
    for e in ov.trace_next:
        _w_ext(b, e)
    _w_u32(b, len(ov.quotient_chunks))
    for chunk in ov.quotient_chunks:
        _w_u32(b, len(chunk))
        for e in chunk:
            _w_ext(b, e)
    fp = p.opening_proof
    _w_u32(b, 1 if fp.random_commit is not None else 0)
    if fp.random_commit is not None:
        _w_digest(b, fp.random_commit)
    _w_u32(b, len(fp.commit_phase_commits))
    for d in fp.commit_phase_commits:
        _w_digest(b, d)
    _w_u32(b, len(fp.final_poly))
    for e in fp.final_poly:
        _w_ext(b, e)
    _w_u32(b, fp.pow_witness)
    _w_u32(b, len(fp.query_proofs))
    for qp in fp.query_proofs:
        _w_u32(b, len(qp.input_openings))
        for op in qp.input_openings:
            _w_opening(b, op)
        _w_u32(b, len(qp.commit_phase_openings))
        for step in qp.commit_phase_openings:
            _w_opening(b, step.opening)
    return b.getvalue()


class _Reader:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)

    def u32(self) -> int:
        return struct.unpack("<I", self.b.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.b.read(8))[0]

    def digest(self) -> Digest:
        n = self.u32()
        return tuple(self.u64() for _ in range(n))  # type: ignore[return-value]

    def ext(self) -> ExtVal:
        return tuple(self.u32() for _ in range(4))  # type: ignore[return-value]

    def opening(self) -> BatchOpening:
        n = self.u32()
        vals = []
        for _ in range(n):
            k = self.u32()
            vals.append(np.array([self.u32() for _ in range(k)], dtype=np.uint32))
        salts = None
        if self.u32():
            ns = self.u32()
            salts = []
            for _ in range(ns):
                k = self.u32()
                salts.append(np.array([self.u32() for _ in range(k)], dtype=np.uint32))
        np_proof = [self.digest() for _ in range(self.u32())]
        return BatchOpening(vals, salts, np_proof)


def deserialize_proof(data: bytes) -> Proof:
    r = _Reader(data)
    degree_bits = r.u32()
    log_qd = r.u32()
    commitments = Commitments(r.digest(), r.digest())
    w = r.u32()
    local = [r.ext() for _ in range(w)]
    nxt = [r.ext() for _ in range(w)]
    qn = r.u32()
    chunks = [[r.ext() for _ in range(r.u32())] for _ in range(qn)]
    random_commit = r.digest() if r.u32() else None
    cpc = [r.digest() for _ in range(r.u32())]
    final_poly = [r.ext() for _ in range(r.u32())]
    pow_witness = r.u32()
    qps = []
    for _ in range(r.u32()):
        inputs = [r.opening() for _ in range(r.u32())]
        steps = [CommitPhaseStep(r.opening()) for _ in range(r.u32())]
        qps.append(QueryProof(inputs, steps))
    return Proof(
        commitments,
        OpenedValues(local, nxt, chunks),
        FriProof(cpc, qps, final_poly, pow_witness, random_commit),
        degree_bits,
        log_qd,
    )
