"""Device meshes (the JAX package's ``launch/mesh.py``), as
``torch.distributed`` ``DeviceMesh``es.

Defined as functions (never module-level constants) so importing this
module never touches the process group.  The reference's production target
is a 16 x 16 pod ("data" x "model"), and 2 pods for the multi-pod
configuration with a leading "pod" dim (outer data parallelism / FSDP;
gradients reduce over ("pod", "data")).  A mesh spans the ranks of the
default process group, which the caller starts (``init_process_group``:
NCCL on the card, gloo on the CPU); without one, a group of this process
alone is started on a ``file://`` rendezvous under a fresh directory.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def backend_for(device) -> str:
    """The process-group backend of a device: NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_process_group(device="cuda", timeout_s: float = 60.0):
    """The default process group, started if none is (the backend by the
    device): from the environment where a launcher such as ``torchrun`` set
    ``RANK`` and ``WORLD_SIZE`` (each rank on card ``LOCAL_RANK``), else as
    a group of this process alone.  Returns (rank, world size)."""
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=timeout_s)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if torch.device(device).type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend_for(device), init_method="env://", timeout=timeout)
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
            dist.init_process_group(backend_for(device), init_method=f"file://{path}", rank=0,
                                    world_size=1, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def _device_type(device):
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, device="cuda"):
    """Mesh over whatever ranks exist (tests / reduced-config runs):
    (n // model, model) over ("data", "model"), of the caller's device type."""
    _, n = ensure_process_group(device)
    if n % model:
        raise ValueError(f"{n} ranks do not divide into a model dim of {model}")
    return init_device_mesh(_device_type(device), (n // model, model),
                            mesh_dim_names=("data", "model"))
