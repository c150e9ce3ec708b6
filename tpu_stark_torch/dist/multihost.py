"""Multi-host process groups (counterpart of ``tpu_stark/dist/multihost.py``):
BASELINE config 5's "N >= 2 hosts" axis.

JAX's scaling story is ``jax.distributed`` and one global mesh, ICI inside
a host's slice and DCN between hosts.  The port's is one process a card,
started by ``torchrun`` (``--nnodes``, ``--nproc-per-node``), in one
``torch.distributed`` group: NVLink inside a host, the inter-node network
between hosts.

Why a flat row mesh is already hierarchical
-------------------------------------------
The distributed NTT's only collectives are XOR-stride pair exchanges (rank
d with d ^ stride, ``dist/ntt.py``) and one all-to-all for the bit-reversal
reshard.  With ranks ordered host-major (rank = host * per_host + local,
as ``torchrun`` numbers them), a stride exchange leaves the host iff
stride >= per_host:

* the DIF exchange stages run stride n/2, n/4, ..., 1: exactly
  log2(n_hosts) of them cross hosts, each once a transform, and the small
  strides stay inside a host;
* the Merkle tree needs no collective until its top log2(n) levels (a
  contiguous block is a complete subtree), and those are gathered.

So multi-host support is the flat row mesh over the global group in
host-major order; ``make_pod_mesh`` checks that order, and
``dcn_crossing_stages`` says which exchanges cross hosts.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .comm import RowMesh, make_row_mesh


def initialize_multihost(backend: str = "nccl", init_method: Optional[str] = None,
                         world_size: Optional[int] = None, rank: Optional[int] = None) -> None:
    """``init_process_group`` from ``torchrun``'s environment (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) unless the arguments say
    otherwise; a second call does nothing.  The caller names the backend:
    ``"nccl"`` on cards, ``"gloo"`` on CPUs or for host-staged transfers."""
    if dist.is_initialized():
        return
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://", **kwargs)


def check_host_major(hosts: Sequence[str]) -> None:
    """Raise unless each host's ranks are one contiguous run."""
    seen: List[str] = []
    for h in hosts:
        if seen and seen[-1] == h:
            continue
        if h in seen:
            raise ValueError(f"ranks are not host-major: {list(hosts)}")
        seen.append(h)


def make_pod_mesh(group=None, device="cuda", host: Optional[str] = None) -> RowMesh:
    """The flat row mesh over every host's ranks, after checking from an
    all-gather of host names (``host``, this host's by default) that the
    rank order is host-major."""
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs an initialized process group (initialize_multihost)")
    name = host if host is not None else socket.gethostname()
    hosts: List[str] = [""] * dist.get_world_size(group)
    dist.all_gather_object(hosts, name, group=group)
    check_host_major(hosts)
    return make_row_mesh(group, device)


def simulate_pod_mesh(n_hosts: int, per_host: int, group=None, device="cuda") -> RowMesh:
    """A pod of ``n_hosts`` hosts of ``per_host`` ranks on one machine: each
    rank names its host by rank // per_host, host-major by construction."""
    world = dist.get_world_size(group)
    if world != n_hosts * per_host:
        raise ValueError(f"a {n_hosts} x {per_host} pod needs {n_hosts * per_host} ranks, have {world}")
    return make_pod_mesh(group, device, host=f"host{dist.get_rank(group) // per_host}")


def dcn_crossing_stages(log_h: int, n_hosts: int, per_host: int) -> Tuple[List[int], List[int]]:
    """Which distributed-NTT exchange strides stay inside a host and which
    cross hosts for a host-major mesh of ``n_hosts * per_host`` ranks
    (see the module doc), for one transform of 2^log_h rows: (inside,
    crossing).  The names follow the JAX package (ICI inside a TPU host's
    slice, DCN between hosts); on GPUs the crossing stages ride the
    inter-node network and the others NVLink."""
    n_dev = n_hosts * per_host
    log_nd = int(np.log2(n_dev))
    assert 1 << log_nd == n_dev, "device count must be a power of two"
    ici, dcn = [], []
    for s in range(log_nd):
        stride = 1 << (log_nd - s - 1)
        (dcn if stride >= per_host else ici).append(stride)
    return ici, dcn
