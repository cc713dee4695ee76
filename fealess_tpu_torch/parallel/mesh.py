"""Process meshes and the layer's collectives (counterpart of
``fealess_tpu.parallel.mesh``).

Each process owns one device, and a mesh names its processes' axes:

- ``t``: template-bank sharding (the matchClass template loop,
  linemod/linemod.cpp:1458, split by slot); the shards' top-K lists are
  all-gathered and merged (``sharded_match``);
- ``d``: data parallelism over frames (``batch_recon``);
- ``p``: point sharding inside ICP's sums (``sharded_icp``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
process of the default group, which the caller initialises first
(``multihost.initialize``, torchrun, or ``init_process_group``).  The
collectives run on whatever backend that group has: NCCL on the card,
gloo on the CPU.  Results travel as pytrees of tensors (dataclasses,
dicts, tuples) packed into one byte buffer, so a gather or a broadcast is
one collective whatever the fields' dtypes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axes: Sequence[Tuple[str, int]],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh from (axis_name, size) pairs, e.g. [("d", 2), ("t", 2)],
    ranks laid out row-major.  The sizes must multiply to the world size
    (one -1 is inferred)."""
    names = tuple(a for a, _ in axes)
    sizes = [s for _, s in axes]
    world = dist.get_world_size()
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {list(zip(names, sizes))} != {world} "
                         f"processes")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def template_mesh(n: int | None = None,
                  device_type: str = "cuda") -> DeviceMesh:
    """1-D template-sharding mesh over every process (``n``, if given,
    must be the world size)."""
    return make_mesh([("t", dist.get_world_size() if n is None else n)],
                     device_type)


def axis_index(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(this process's coordinate on ``axis``, the axis size)."""
    return (mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def shard_bank(bank, mesh: DeviceMesh, axis: str = "t", tables=None):
    """This process's contiguous slice of a TemplateBank on ``axis``:
    (bank slice, the score tables' slice or None, slot offset).  The
    capacity must divide by the axis size (pad the bank accordingly)."""
    i, n = axis_index(mesh, axis)
    if bank.capacity % n:
        raise ValueError(f"bank capacity {bank.capacity} does not divide "
                         f"into {n} shards on axis {axis!r}")
    size = bank.capacity // n
    lo = i * size
    if tables is not None:
        tables = tuple(None if tab is None
                       else {k: v[lo:lo + size] for k, v in tab.items()}
                       for tab in tables)
    return bank.slots(lo, lo + size), tables, lo


def replicated(mesh: DeviceMesh):
    """The process group a replicated value lives on: every process of
    the mesh, which :func:`make_mesh` makes the whole default group."""
    del mesh
    return dist.group.WORLD


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor (or numpy) leaves of dataclasses, dicts,
    tuples and lists, zipped with ``rest``'s; other leaves (class names,
    ints) are kept."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def tree_leaves(tree):
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def stack_tree(trees):
    """One tree whose leaves stack ``trees``' leaves on a new first
    axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _pack(leaves, lead: int) -> torch.Tensor:
    """(lead, bytes) u8: each leaf's rows as raw bytes, side by side."""
    return torch.cat([x.reshape(lead, -1).contiguous().view(torch.uint8)
                      for x in leaves], dim=1)


def _unpack(buf: torch.Tensor, like, lead: int):
    """Inverse of :func:`_pack` for ``buf.shape[0]`` rows of leaves shaped
    as ``like`` (whose first axis is ``lead``)."""
    out, at = [], 0
    for x in like:
        width = x.numel() // lead * x.element_size()
        out.append(buf[:, at:at + width].contiguous().view(x.dtype)
                   .reshape((buf.shape[0],) + tuple(x.shape[1:])))
        at += width
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def all_gather_tree(tree, group):
    """Every process's ``tree`` (leaves with one shared first axis)
    concatenated on that axis in rank order, on every process of
    ``group``: one all-gather of a byte buffer."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[0]
    buf = _pack(leaves, lead)
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return _rebuild(tree, _unpack(torch.cat(parts), leaves, lead))


def broadcast_tree(tree, group, src: int = 0):
    """``tree`` as the process of global rank ``src`` holds it, on every
    process of ``group``: one broadcast of a byte buffer.  Each process
    passes a tree of the same structure, shapes and dtypes."""
    leaves = [x.reshape(1, -1) for x in tree_leaves(tree)]
    buf = _pack(leaves, 1)
    dist.broadcast(buf, src=src, group=group)
    got = _unpack(buf, leaves, 1)
    return _rebuild(tree, [g.reshape(x.shape)
                           for g, x in zip(got, tree_leaves(tree))])
