"""Device meshes over ``torch.distributed`` process groups.

Counterpart of ``manual_yolo_tpu/parallel/mesh.py``. One process per
device; a ``Mesh`` lays the ranks of the default process group out as an
array of ``shape`` (row-major, the first axis slowest, as JAX reshapes its
device list) and holds one process group per axis and per set of axes:
the ranks that differ only along those axes. ``make_mesh`` keeps JAX's
shape rule (one axis: all ranks; two axes: ``_largest_divisor_leq(n,
sqrt(n))`` on the second, so (2, 2) for 4 and (4, 2) for 8).

JAX's shardings become rank-local helpers: ``replicated`` / ``shard_params``
broadcast from rank 0 of the mesh; ``shard_batch`` and ``shard_spatial``
take this rank's slice of a batch (dim 0) or of the rows (dim 1 of NHWC).

``init_process_group`` joins the default group through a ``FileStore``
(a file both processes name; no TCP port, so runs side by side cannot
collide): ``nccl`` on the card, ``gloo`` when the caller asks for the CPU.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_process_group(rank: int, world_size: int, store_path: str,
                       device: str = "cuda") -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path``: ``nccl`` for the card (the default), ``gloo`` when the
    caller passes ``device="cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo group")
    backend = {"cuda": "nccl", "cpu": "gloo"}[kind]
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(max(k, 1), 0, -1):
        if n % d == 0:
            return d
    return 1


class Mesh:
    """The default group's ranks as an array of ``shape`` named by ``axes``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, (int(s) for s in shape)))
        self.size = int(np.prod(shape))
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh shape {tuple(shape)} != {dist.get_world_size()} ranks")
        self.rank = dist.get_rank()
        ranks = np.arange(self.size).reshape(tuple(shape))
        self.coords = dict(zip(self.axes, (int(c) for c in np.unravel_index(self.rank, ranks.shape))))
        # every process creates every group, in the same order (new_group's rule)
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        for r in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(self.axes, r):
                moved = [self.axes.index(a) for a in sub]
                kept = [i for i in range(len(self.axes)) if i not in moved]
                members = np.moveaxis(ranks, moved + kept, list(range(len(self.axes))))
                members = members.reshape(int(np.prod([ranks.shape[i] for i in moved])), -1).T
                mine = None
                for m in members:
                    g = dist.new_group([int(v) for v in m]) if len(sub) < len(self.axes) else None
                    if self.rank in m:
                        mine = g
                self._groups[sub] = mine if len(sub) < len(self.axes) else dist.group.WORLD

    def group(self, *axes: str) -> dist.ProcessGroup:
        """The group of the ranks that differ from this one only along ``axes``."""
        key = tuple(a for a in self.axes if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"{axes} not all in the mesh axes {self.axes}")
        return self._groups[key]

    def coord(self, axis: str) -> int:
        return self.coords[axis]


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """A mesh over the default group (which must hold ``n_devices`` ranks)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            # favour the data axis; spatial/model axis gets the remainder
            d = _largest_divisor_leq(n, int(np.sqrt(n)))
            shape = (n // d, d)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(shape, axes)


def replicated(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` as rank 0 holds it, on every rank (in place)."""
    dist.broadcast(tensor, src=0)
    return tensor


@torch.no_grad()
def shard_params(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Replicate a module's parameters and buffers from rank 0 (in place)."""
    for t in list(module.parameters()) + list(module.buffers()):
        replicated(mesh, t.data)
    return module


def _slice(x, dim: int, n: int, i: int):
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    step = x.shape[dim] // n
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(i * step, (i + 1) * step)
    return x[tuple(idx)]


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's slice of ``batch`` (an array, or a tuple of arrays) along
    dim 0 over ``axis``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b, axis) for b in batch)
    return _slice(batch, 0, mesh.shape[axis], mesh.coord(axis))


def shard_spatial(mesh: Mesh, x, axis: str = "spatial"):
    """This rank's rows of an (N, H, W, C) array over ``axis``."""
    return _slice(x, 1, mesh.shape[axis], mesh.coord(axis))
