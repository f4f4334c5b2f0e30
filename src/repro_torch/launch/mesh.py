"""Production mesh construction: `repro.launch.mesh` on torch.distributed.

Called as a FUNCTION so importing this module never touches a process
group.  Single pod = 256 devices (16, 16) ("data", "model"); multi-pod
adds a leading "pod" axis (outer data parallelism).  A mesh needs a
process group of exactly its size: NCCL or gloo ranks, or the fake group
of the dry-run (`launch/dryrun.py`).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.hardware import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """(world // model, model) ("data", "model") mesh over the ranks of
    the process group that is running."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM, per device: the roofline denominators
PEAK_FLOPS_BF16 = BF16_FLOPS_PER_S      # FLOP/s, dense tensor-core bf16
HBM_BW = HBM_BYTES_PER_S                # bytes/s
# NVLink 4: 900 GB/s bidirectional per H100 SXM (NVIDIA's H100 data
# sheet), 450 GB/s each way
LINK_BW = 450e9                         # bytes/s per direction
HBM_BYTES = 80e9                        # capacity
