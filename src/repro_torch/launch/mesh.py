"""Meshes of the port (the reference's ``repro.launch.mesh``): named axes
with their sizes, and, for a mesh of local ranks, one device per rank.

``Mesh.shape`` maps each axis name to its size, as the reference's
``jax.sharding.Mesh.shape`` does, so the sharding rules read it alike.
The production meshes keep the reference's (16, 16) and (2, 16, 16)
shapes, so that dry-run cells compare one to one; they hold no devices (the
dry run is a ``meta`` pass).  Rank r of a local mesh sits at the
row-major position of r in the axes' grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along each axis (row-major)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}

    def group(self, rank: int, axis: str) -> Tuple[int, ...]:
        """The ranks that differ from ``rank`` along ``axis`` alone, in the
        order of their index on it: a collective's group along one axis."""
        c = self.coords(rank)
        out = []
        for i in range(self.shape[axis]):
            c[axis] = i
            r = 0
            for a, n in zip(self.axis_names, self.sizes):
                r = r * n + c[a]
            out.append(r)
        return tuple(out)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips (data, model); multi-pod: 2 x 16 x
    16 = 512 (pod, data, model).  No devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1, data: int = 0, device=None) -> Mesh:
    """A (data, model) mesh over the visible cards: ``data`` 0 takes every
    card left after ``model``.  CPU ranks only when asked: ``device="cpu"``
    puts every rank on the CPU; a single ``"cuda:i"`` puts every rank on
    that card (ranks sharing it).  Raises where the cards do not suffice."""
    if device is not None and torch.device(device).type == "cpu":
        n = model * data if data else model
        return Mesh(("data", "model"), (n // model, model),
                    tuple([torch.device("cpu")] * n))
    if not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh: CUDA is not available; pass "
                           "device='cpu' for CPU ranks")
    if device is not None:
        if not data:
            raise ValueError("ranks sharing one card need data > 0")
        return Mesh(("data", "model"), (data, model),
                    tuple([torch.device(device)] * (data * model)))
    n = torch.cuda.device_count()
    data = data or n // model
    if data * model > n or data < 1:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"cards, have {n}")
    return Mesh(("data", "model"), (data, model),
                tuple(torch.device("cuda", i) for i in range(data * model)))
