"""Multi-host (pod-scale) execution seams over torch.distributed.

Counterpart of bulletproofs_plus_tpu/parallel/multihost.py.  BASELINE.md's
pod-scale configuration is a 64k-proof stream verified across hosts.  The
design is the JAX package's, with one process (rank) a card in place of one
controller a host:

  * every rank calls `initialize_distributed()` once (the torch.distributed
    rendezvous; `torchrun` sets its variables), then builds ONE 1-D "dp"
    mesh over all ranks (`global_dp_mesh`);
  * every rank is fed the same stream and packs only the proofs of its own
    shard (`host_shard`), so proof bytes never cross the network;
  * per-batch verification is the sharded verifier (parallel/verify.py):
    one all-reduce of the static scalar accumulators and one gather of a
    point a rank;
  * the stream runs through `RangeProof.verify_batches_pipelined`, and
    every rank returns the whole stream's verdicts.

A single process is a degenerate but real case (a world of one), which is
what runs without a cluster.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import rank_and_size, world_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (idempotent; nothing to do for a world of one).

    Every rank runs the same program with MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK set (as `torchrun` sets them), or passes them here
    (`coordinator_address` as "host:port").  The backend is NCCL where
    there is a card, else gloo; with a card, the rank takes LOCAL_RANK's
    card as its current device."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def global_dp_mesh(device_type=None):
    """One 1-D "dp" mesh over every rank of every host, on `device_type`
    ("cuda" unless given)."""
    return world_mesh(device_type, "dp")


def host_shard(n_items: int, mesh=None) -> slice:
    """The contiguous slice of a dp-sharded batch this rank packs: ranks
    take equal runs in rank order.  slice(0, n_items) without a process
    group."""
    if mesh is not None:
        rank, world = rank_and_size(mesh)
    elif dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        return slice(0, n_items)
    if n_items % world:
        raise ValueError("batch must divide evenly across hosts")
    per = n_items // world
    return slice(rank * per, (rank + 1) * per)


def verify_stream_pod(batches, action, mesh=None) -> List[list]:
    """Verify a (potentially 64k-proof) stream of batches across all ranks.

    `batches` yields (transcripts, statements, proofs) like
    `RangeProof.verify_batches_pipelined`; a single-shape batch whose size
    divides by the mesh's is sharded, any other runs whole on every rank.
    Every rank feeds the same stream and gets every batch's result."""
    from ..models.range_proof import RangeProof

    mesh = mesh if mesh is not None else global_dp_mesh()
    return RangeProof.verify_batches_pipelined(batches, action, device=mesh.device_type, mesh=mesh)


def make_pod_stream(
    statements: Sequence,
    proofs: Sequence,
    transcript_label: bytes,
    batch_size: int = 256,
) -> List[Tuple[list, list, list]]:
    """Slice a flat proof list into MAX-sized batches for the pod stream:
    the 64k-proof configuration is `make_pod_stream(..., batch_size=256)`
    (256 batches of 256), fed to `verify_stream_pod`."""
    from ..utils.merlin import Transcript

    out = []
    for lo in range(0, len(proofs), batch_size):
        chunk_s = list(statements[lo : lo + batch_size])
        chunk_p = list(proofs[lo : lo + batch_size])
        out.append(([Transcript(transcript_label) for _ in chunk_p], chunk_s, chunk_p))
    return out
