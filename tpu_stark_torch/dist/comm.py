"""The row mesh and its collectives (the runtime side of ``tpu_stark/dist``).

JAX builds its sharded prover on a ``jax.sharding.Mesh`` and gets its
collectives from XLA (``ppermute``, ``all_to_all``, GSPMD's reshards).  The
port runs one process per rank over ``torch.distributed``: every rank runs
the same ``prove()``, holds one contiguous row block of every large matrix
on its device, and calls the few collectives below.

``RowMesh`` is the process group, the rank, the world size, the rank's
device and the transport, which follows from the group's backend:

* ``"nccl"``: device tensors go straight to the collective;
* ``"gloo"`` with CPU tensors: the same;
* ``"gloo-host"``: gloo with CUDA tensors (gloo moves only host memory), so
  each operand is copied to host memory, sent, and copied back.  This is
  how one card runs a multi-rank schedule with the real kernels.

The transport is never switched silently: a group whose backend cannot
carry the device's tensors raises.  ``sent`` counts the payload this rank
sends to other ranks, by collective (a collective's logical payload: an
all-gather sends the rank's block to every other rank, an all-reduce its
operand to every other rank), ``staged`` the bytes copied between the
device and host memory, ``seconds`` the wall time spent in each collective
(the host staging included; on ``"gloo-host"`` the card is synchronized
first, so that queued kernels do not count; on NCCL it is the time to
enqueue the collective), and ``largest_gather`` the most rows an
all-gather gave this rank.  A collective that fails raises in its rank.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..fields import babybear as bb


class RowMesh:
    """A ``torch.distributed`` group whose ranks each hold one contiguous
    row block; rank r of n holds rows [r * H / n, (r + 1) * H / n) of every
    sharded matrix of height H."""

    def __init__(self, group, rank: int, size: int, device: torch.device, transport: str):
        if size & (size - 1):
            raise ValueError(f"the row mesh needs a power-of-two world size, got {size}")
        self.group = group
        self.rank = rank
        self.size = size
        self.log_size = size.bit_length() - 1
        self.device = device
        self.transport = transport
        self.reset_counts()

    def __repr__(self) -> str:
        return f"RowMesh(rank {self.rank} of {self.size}, {self.device}, {self.transport})"

    def reset_counts(self) -> None:
        self.sent: Dict[str, int] = collections.Counter()
        self.staged = 0
        self.seconds: Dict[str, float] = collections.Counter()
        self.largest_gather = 0

    # -- transport ------------------------------------------------------------
    def _host(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.transport == "gloo-host":
            self.staged += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _dev(self, x: torch.Tensor) -> torch.Tensor:
        if self.transport == "gloo-host":
            self.staged += x.numel() * x.element_size()
            return x.to(self.device)
        return x

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="cpu" if self.transport == "gloo-host" else self.device)

    def _count(self, name: str, nbytes: int) -> None:
        self.sent[name] += int(nbytes)

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.transport == "gloo-host":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

    # -- collectives ------------------------------------------------------------
    def exchange(self, x: torch.Tensor, partner: int, name: str = "exchange") -> torch.Tensor:
        """Send ``x`` to ``partner`` and receive its tensor of the same shape
        (the XOR-stride pair exchange of the NTT, JAX's ``ppermute``)."""
        if partner == self.rank:
            return x.clone()
        return self._sendrecv(x, partner, partner, name)

    def _sendrecv(self, x: torch.Tensor, dst: int, src: int, name: str) -> torch.Tensor:
        with self._timed(name):
            send = self._host(x)
            recv = self._empty(tuple(send.shape), send.dtype)
            ops = [dist.P2POp(dist.isend, send, self._global(dst), self.group),
                   dist.P2POp(dist.irecv, recv, self._global(src), self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self._count(name, send.numel() * send.element_size())
            return self._dev(recv)

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def next_halo(self, head: torch.Tensor) -> torch.Tensor:
        """Send ``head`` to the previous rank and receive the next rank's
        (wrapping from the last rank to rank 0): the rows after this rank's
        block, for the quotient's next-row access."""
        if self.size == 1:
            return head.clone()
        return self._sendrecv(head, (self.rank - 1) % self.size, (self.rank + 1) % self.size, "halo")

    def all_to_all_rows(self, parts: Sequence[torch.Tensor], recv_rows: Sequence[int],
                        name: str = "all_to_all") -> List[torch.Tensor]:
        """Send ``parts[j]`` (rows of one width) to rank j; receive
        ``recv_rows[j]`` rows of that width from rank j, in rank order."""
        with self._timed(name):
            w = int(parts[0].shape[1])
            send = self._host(torch.cat([p.reshape(-1, w) for p in parts], dim=0))
            recv = self._empty((sum(recv_rows), w), send.dtype)
            dist.all_to_all_single(recv, send, [int(r) for r in recv_rows],
                                   [int(p.shape[0]) for p in parts], group=self.group)
            self._count(name, sum(p.numel() for j, p in enumerate(parts) if j != self.rank) * send.element_size())
            return list(torch.split(self._dev(recv), [int(r) for r in recv_rows], dim=0))

    def all_gather(self, x: torch.Tensor, name: str = "all_gather") -> torch.Tensor:
        """Every rank's ``x`` (one shape on all ranks) concatenated along
        dim 0 in rank order."""
        with self._timed(name):
            send = self._host(x)
            out = [self._empty(tuple(send.shape), send.dtype) for _ in range(self.size)]
            dist.all_gather(out, send, group=self.group)
            self._count(name, send.numel() * send.element_size() * (self.size - 1))
            self.largest_gather = max(self.largest_gather, int(send.shape[0]) * self.size)
            return self._dev(torch.cat(out, dim=0))

    def all_reduce_sum(self, x: torch.Tensor, name: str = "all_reduce") -> torch.Tensor:
        """The elementwise sum of every rank's int64 ``x``."""
        if x.dtype != torch.int64:
            raise TypeError("all_reduce_sum takes int64 tensors")
        with self._timed(name):
            buf = self._host(x.clone())
            dist.all_reduce(buf, group=self.group)
            self._count(name, buf.numel() * buf.element_size() * (self.size - 1))
            return self._dev(buf)

    def all_reduce_mod_p(self, x: torch.Tensor, name: str = "all_reduce") -> torch.Tensor:
        """The sum mod p of every rank's reduced field elements (int32 or
        int64, each below p), as int32: the int64 sum of fewer than 2^32
        residues is exact."""
        return (self.all_reduce_sum(x.to(torch.int64), name) % bb.P).to(torch.int32)


def make_row_mesh(group=None, device="cuda") -> RowMesh:
    """The row mesh over ``group`` (the default group when None), on
    ``device``: a CUDA device without an index takes ``LOCAL_RANK`` (as
    ``torchrun`` sets it), so N ranks on N cards each take their own."""
    if not dist.is_initialized():
        raise RuntimeError("make_row_mesh needs an initialized process group (init_process_group)")
    g = group if group is not None else dist.group.WORLD
    backend = dist.get_backend(g)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group carries CUDA tensors only")
        transport = "nccl"
    elif backend == "gloo":
        transport = "gloo-host" if device.type == "cuda" else "gloo"
    else:
        raise ValueError(f"unsupported process-group backend {backend!r}")
    return RowMesh(group, dist.get_rank(g), dist.get_world_size(g), device, transport)


def block(mesh: RowMesh, h: int):
    """(first row, rows) of this rank's block of a height-h matrix."""
    if h % mesh.size:
        raise ValueError(f"height {h} does not split over {mesh.size} ranks")
    rows = h // mesh.size
    return mesh.rank * rows, rows
