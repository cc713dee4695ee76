"""Multi-process bootstrap and per-process frame feeding (counterpart of
``fealess_tpu.parallel.multihost``).

The reference is strictly single-process (CadReco/obj_reco_lmicp.cpp:
86-204 runs one core).  Scaling Recognition past one process runs the
same program in every process: :func:`initialize` joins them into one
``torch.distributed`` group, a mesh spans every process's device, each
process feeds only its own frames, and the bank, model depths and
tables are replicated from process 0.  Batch Recognition is then pure
data parallelism (no collective per frame).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fealess_tpu_torch.parallel import mesh as mesh_mod


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout: Optional[datetime.timedelta] = None
               ) -> torch.device:
    """Join this process into the group and return its device.

    Arguments default to ``FEALESS_COORDINATOR`` (``host:port``; TCP
    rendezvous, process 0 listens), ``FEALESS_NUM_PROCESSES`` and
    ``FEALESS_PROCESS_ID``; without a coordinator the group reads
    torchrun's ``env://`` variables.  ``device`` is ``cuda`` unless the
    caller names another; a bare ``cuda`` is card ``LOCAL_RANK`` (or the
    process id modulo the cards).  The backend follows the device (NCCL
    for ``cuda``, gloo for ``cpu``) unless ``backend`` names one; NCCL
    joins eagerly, so a failed init raises here.  ``timeout`` bounds
    every collective (torch's default if None)."""
    coordinator_address = coordinator_address or os.environ.get(
        "FEALESS_COORDINATOR")
    if num_processes is None and "FEALESS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FEALESS_NUM_PROCESSES"])
    if process_id is None and "FEALESS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FEALESS_PROCESS_ID"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None else
                           (process_id or 0) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if coordinator_address:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout is not None:
        kwargs["timeout"] = timeout
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, **kwargs)
    return dev


def global_mesh(axis: str = "d", device_type: str = "cuda") -> DeviceMesh:
    """One-axis mesh over every process (the frame/data axis)."""
    return mesh_mod.make_mesh([(axis, dist.get_world_size())], device_type)


def feed_local_batch(mesh: DeviceMesh, local_arrays, axis: str = "d"):
    """This process's own frames on its device: (the pytree of numpy
    arrays ``local_arrays`` as tensors, the global index of its first
    frame).  Every process feeds the same number of frames, so the global
    batch is the processes' batches in rank order."""
    i, _ = mesh_mod.axis_index(mesh, axis)
    dev = mesh_mod.mesh_device(mesh)
    tensors = mesh_mod.tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
        local_arrays)
    return tensors, i * mesh_mod.tree_leaves(tensors)[0].shape[0]


def replicate(mesh: DeviceMesh, tree):
    """Process 0's pytree (bank, model depths, tables; numpy arrays or
    tensors) on every process's device, in one broadcast.  Every process
    passes a tree of the same structure, shapes and dtypes."""
    dev = mesh_mod.mesh_device(mesh)
    tensors = mesh_mod.tree_map(lambda a: torch.as_tensor(a).to(dev), tree)
    return mesh_mod.broadcast_tree(tensors, mesh_mod.replicated(mesh))
