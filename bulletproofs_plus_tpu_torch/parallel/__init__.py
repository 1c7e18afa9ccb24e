"""Multi-card parallelism over torch.distributed: process meshes, the
sharded MSM, and the multi-host seams.

Counterpart of bulletproofs_plus_tpu/parallel/.  One process (rank) drives
one card, SPMD: a 1-D `torch.distributed.device_mesh.DeviceMesh` takes the
place of JAX's mesh, and the collectives run through its process group
(NCCL across cards, gloo where ranks share a card or run on the CPU).
"""

from .multihost import (
    global_dp_mesh,
    host_shard,
    initialize_distributed,
    make_pod_stream,
    verify_stream_pod,
)
from .sharded_msm import make_mesh, pad_for_mesh, sharded_msm_fn

__all__ = [
    "make_mesh",
    "pad_for_mesh",
    "sharded_msm_fn",
    "initialize_distributed",
    "global_dp_mesh",
    "host_shard",
    "make_pod_stream",
    "verify_stream_pod",
]
