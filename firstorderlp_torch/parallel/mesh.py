"""Solver meshes for multi-device solves, the port's counterpart of the
JAX package's ``parallel/mesh.py``.

A mesh has two logical axes:
- "dual":   partitions the rows of A (constraint-indexed),
- "primal": partitions the columns of A (variable-indexed).

The constraint matrix is cut into a (D, P) grid of blocks, block (d, p)
on the mesh's device (d, p) (ops/routed_sharded.py). The JAX package
lets GSPMD shard every vector as well; the port keeps the vectors whole
on each process's home device, so only the operator's products touch
more than one device.

Under a torch.distributed process group (parallel/distributed.py) every
rank owns one cell, rank = d * P + p, and holds only that block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """A ("dual", "primal") grid of devices.

    devices: the (D, P) grid; a device may appear in several cells.
    rank: None in a single process, which owns every cell; under a
    process group, this process's rank, which owns cell
    (rank // P, rank % P) only."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    rank: Optional[int] = None

    axis_names = ("dual", "primal")

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.devices), len(self.devices[0]))

    @property
    def n_dual(self) -> int:
        return self.shape[0]

    @property
    def n_primal(self) -> int:
        return self.shape[1]

    def owner(self, d: int, p: int) -> int:
        """The rank that owns cell (d, p) under a process group."""
        return d * self.n_primal + p

    def owns(self, d: int, p: int) -> bool:
        return self.rank is None or self.owner(d, p) == self.rank

    @property
    def home_device(self) -> torch.device:
        """Where this process keeps the solver's vectors: its own cell's
        device under a process group, else cell (0, 0)'s."""
        if self.rank is None:
            return self.devices[0][0]
        return self.devices[self.rank // self.n_primal][
            self.rank % self.n_primal
        ]


def _grid(devices: Sequence[torch.device], n_dual: int, n_primal: int):
    return tuple(
        tuple(torch.device(devices[d * n_primal + p])
              for p in range(n_primal))
        for d in range(n_dual)
    )


def visible_cuda_devices() -> Tuple[torch.device, ...]:
    """The distinct visible CUDA devices; raises when there is no GPU."""
    resolve_device(None)
    return tuple(
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
    )


def solver_mesh(
    n_dual: int,
    n_primal: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> SolverMesh:
    """A (n_dual, n_primal) mesh over the first n_dual * n_primal of
    `devices`, row-major. `devices=None`: the distinct visible CUDA
    devices (raises without a GPU). An explicit list may repeat a device,
    for several cells on one device."""
    if devices is None:
        devices = visible_cuda_devices()
    need = n_dual * n_primal
    if n_dual < 1 or n_primal < 1:
        raise ValueError(f"a mesh needs positive axes, got {n_dual}x{n_primal}")
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a {n_dual}x{n_primal} mesh, have "
            f"{len(devices)}"
        )
    return SolverMesh(devices=_grid(devices, n_dual, n_primal))


def default_solver_mesh(devices=None) -> SolverMesh:
    """All devices on the "dual" (row) axis, the right default for LPs,
    which typically have more constraints than one device wants."""
    if devices is None:
        devices = visible_cuda_devices()
    return solver_mesh(len(devices), 1, devices)
