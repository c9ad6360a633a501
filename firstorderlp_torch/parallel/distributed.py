"""Multi-process solves over torch.distributed, the port's counterpart
of the JAX package's ``parallel/distributed.py`` (jax.distributed + a
global mesh).

Every process runs the same program on the same problem. `initialize`
joins the process group, `global_solver_mesh` gives each rank one cell
of the (D, P) mesh (rank = d * P + p), and `sharded_optimize` builds
only that rank's block of A. Each product then gathers the ranks'
equal-sized partials with `gather_in_rank_order` and every rank sums
them in one fixed order, so the iterates are bitwise equal on every
rank and to the single-process mesh of the same shape. An all_reduce
has no fixed order, and ranks whose iterates differ take different
host decisions and deadlock.

Lockstep: every host decision of the solver follows from those
iterates but the time limit, since each rank reads its own clock. The
solvers use rank 0's reading on every rank (`broadcast_seconds`, one
scalar a dispatch of evaluations).

Typical launch, the same command on every process:

    torchrun --nproc-per-node=N -m mymodule   # mymodule calls:
    from firstorderlp_torch.parallel import distributed as D
    out = D.distributed_optimize(params, problem)  # initialize() reads
                                                   # torchrun's environment

Transport: NCCL when each rank has a CUDA device of its own; gloo
otherwise (the CPU, or several ranks on one card, which NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.device import resolve_device
from .mesh import SolverMesh, solver_mesh, visible_cuda_devices


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Joins this process to the default process group (idempotent).

    coordinator_address: "host:port" of rank 0 (tcp://); with no
    arguments the group comes from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), and with neither, this
    is a single process and nothing is done.
    local_device_ids: the CUDA device of this process (its first entry;
    default LOCAL_RANK modulo the visible devices).
    The backend is NCCL when CUDA is available and every process of this
    host has a device of its own, else gloo."""
    if dist.is_initialized():
        return
    if (coordinator_address is None and num_processes is None
            and "WORLD_SIZE" not in os.environ):
        return  # a single process: the global mesh is the local one
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = "gloo"
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        local = (local_device_ids[0] if local_device_ids
                 else _env_int("LOCAL_RANK", rank) % count)
        torch.cuda.set_device(local)
        if count >= _env_int("LOCAL_WORLD_SIZE", world):
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank
    )


def global_solver_mesh(
    n_dual: Optional[int] = None, n_primal: int = 1, device=None
) -> SolverMesh:
    """A ("dual", "primal") mesh over every rank of the process group,
    one cell a rank (rank = d * P + p); `n_dual` defaults to the world
    size over `n_primal`. `device`: this rank's device (default its
    current CUDA device; raises without a GPU).

    With no process group this is the local mesh: every cell on
    `device` when one is named, else on the visible CUDA devices."""
    if not dist.is_initialized():
        if device is not None:
            cells = (n_dual or 1) * n_primal
            return solver_mesh(n_dual or 1, n_primal,
                               [torch.device(device)] * cells)
        devices = visible_cuda_devices()
        if n_dual is None:
            n_dual = len(devices) // n_primal
        return solver_mesh(n_dual, n_primal, devices)
    world = dist.get_world_size()
    if n_dual is None:
        n_dual = world // n_primal
    if n_dual * n_primal != world:
        raise ValueError(
            f"a {n_dual}x{n_primal} mesh needs {n_dual * n_primal} ranks, "
            f"the process group has {world}"
        )
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", torch.cuda.current_device())
    names = [None] * world
    dist.all_gather_object(names, str(torch.device(device)))
    mesh = solver_mesh(n_dual, n_primal, [torch.device(s) for s in names])
    return dataclasses.replace(mesh, rank=dist.get_rank())


def distributed_optimize(
    params,
    problem,
    n_dual: Optional[int] = None,
    n_primal: int = 1,
    device=None,
):
    """initialize() + global mesh + sharded_optimize in one call.

    Every process calls this with the SAME problem and parameters; each
    gets the whole solution."""
    from .sharded import sharded_optimize

    initialize()
    mesh = global_solver_mesh(n_dual, n_primal, device)
    return sharded_optimize(params, problem, mesh)


def gather_in_rank_order(part: torch.Tensor) -> torch.Tensor:
    """(world, *part.shape): every rank's `part`, all of one shape, in
    rank order, on `part`'s device. NCCL gathers device memory. Gloo
    moves host memory only, so a CUDA `part` goes through pinned host
    buffers: copied out (the copy waits for the kernels that made it),
    gathered, and copied back to the device."""
    world = dist.get_world_size()
    shape = (world,) + tuple(part.shape)
    part = part.contiguous()
    if dist.get_backend() == "nccl":
        out = torch.empty(shape, dtype=part.dtype, device=part.device)
        dist.all_gather_into_tensor(out, part)
        return out
    staged = part.is_cuda
    host = part
    if staged:
        host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        host.copy_(part)
    out = torch.empty(shape, dtype=part.dtype, pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), host)
    return out.to(part.device) if staged else out


def broadcast_seconds(seconds: float, device: torch.device) -> float:
    """Rank 0's `seconds` on every rank."""
    where = device if dist.get_backend() == "nccl" else "cpu"
    value = torch.tensor([seconds], dtype=torch.float64, device=where)
    dist.broadcast(value, src=0)
    return float(value.item())


# ---------------------------------------------------------------------------
# Ordered reductions over row blocks (parallel/shard_ingest.py)
# ---------------------------------------------------------------------------


def allmax_int(vec: np.ndarray, device=None) -> np.ndarray:
    """Element-wise max of a small int64 vector over the ranks (the
    vector itself with no process group). `device`: where the gather
    runs under NCCL (this rank's CUDA device); gloo gathers host
    memory."""
    vec = np.asarray(vec, dtype=np.int64)
    if not dist.is_initialized():
        return vec
    where = device if dist.get_backend() == "nccl" else "cpu"
    part = torch.as_tensor(vec, device=where)
    return gather_in_rank_order(part).amax(dim=0).cpu().numpy()


def _row_block_parts(parts: Mapping[int, torch.Tensor],
                     mesh: SolverMesh) -> List[torch.Tensor]:
    """Row block d's tensor for every d of the mesh, in d order, on the
    mesh's home device. `parts` maps a row block to its tensor: every
    block in a single process; under a process group this rank's own
    block, whose pieces are gathered from all ranks and only those of
    the ranks (d, 0) kept (the ranks (d, p) all hold row block d)."""
    home = mesh.home_device
    if mesh.rank is None:
        return [parts[d].to(home) for d in range(mesh.n_dual)]
    (own,) = parts.values()
    gathered = gather_in_rank_order(own.to(home))
    return [gathered[mesh.owner(d, 0)] for d in range(mesh.n_dual)]


def reduce_row_blocks(parts: Mapping[int, torch.Tensor], mesh: SolverMesh,
                      op: str) -> torch.Tensor:
    """The element-wise "max" or "sum" of the row blocks' tensors (for
    example each block's column sums), folded in d order on the home
    device: the same bits on every rank and in the single-process mesh
    of the same shape. No all_reduce: its order is not fixed."""
    if op not in ("max", "sum"):
        raise ValueError(f"unknown reduction {op!r}")
    pieces = _row_block_parts(parts, mesh)
    total = pieces[0]
    for piece in pieces[1:]:
        total = torch.maximum(total, piece) if op == "max" else total + piece
    return total


def concat_row_blocks(parts: Mapping[int, torch.Tensor],
                      mesh: SolverMesh) -> torch.Tensor:
    """The row blocks' equal-length tensors (for example each block's
    row scaling) concatenated in d order on the home device."""
    return torch.cat(_row_block_parts(parts, mesh))
