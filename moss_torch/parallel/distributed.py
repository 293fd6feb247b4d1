"""Multi-process bootstrap and the ('data', 'tile') mesh (port of
moss_tpu/parallel/distributed.py).

Every rank runs the same driver. initialize_distributed joins them in one
torch.distributed process group; global_mesh lays the ranks out as an
n_data x n_tile grid (rank = data_index * n_tile + tile_index) and builds
the two kinds of subgroup the sharded step reduces over: a tile group per
data row (the ranks that render one frame's pixel bands) and a data group
per tile column (the ranks that hold band t of different frames).

The backend is NCCL where CUDA is available and gloo on the CPU, unless the
caller names one. NCCL takes one rank a device; two ranks on one device need
gloo, which takes CUDA tensors for all_reduce and broadcast, the only
collectives the mesh uses.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")  # what torchrun sets


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group; True if this call (or an earlier one) did.

    With a coordinator ("host:port", the drivers' --coordinator) it joins
    over tcp://coordinator as rank process_id of num_processes. Without one
    it joins only where the torch launcher's environment (MASTER_ADDR, RANK,
    WORLD_SIZE) is set, else does nothing, so a single-process run needs no
    flags. Under NCCL each rank takes the device LOCAL_RANK (else its rank
    modulo the devices) as its current one."""
    if dist.is_available() and dist.is_initialized():
        return True
    explicit = coordinator is not None
    if not explicit and not all(k in os.environ for k in LAUNCHER_ENV):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current GPU
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_uniform_across_processes(value: int, what: str = "value") -> None:
    """Raise on every rank if `value` differs across the ranks (a no-op for
    one process). Trainer.resume_latest checks the step it resumed: only
    rank 0 writes checkpoints, so a per-host output directory would resume
    the ranks at different steps, and their collectives would no longer
    pair up."""
    if process_count() <= 1:
        return
    t = torch.tensor([int(value), -int(value)], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(
            f"{what} differs across processes: between {lo} and {hi}; every process "
            f"must see the same files (shared storage; only process 0 writes)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_tile grid of ranks and the
    subgroups it reduces over (None where the group is this rank alone).
    `device` is where the step and its collectives' tensors live."""

    n_data: int
    n_tile: int
    rank: int
    data_index: int
    tile_index: int
    tile_group: object  # the ranks of this data row: one frame's bands
    data_group: object  # the ranks of this tile column: band t of each frame
    device: torch.device

    @property
    def shape(self):
        return {"data": self.n_data, "tile": self.n_tile}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """SUM all-reduce of t in place over the 'tile' or 'data' axis."""
        group, n = ((self.tile_group, self.n_tile) if axis == "tile"
                    else (self.data_group, self.n_data))
        if n > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


def make_mesh(n_data: int, n_tile: int, ranks: Optional[Sequence[int]] = None,
              device=None) -> Optional[Mesh]:
    """An n_data x n_tile mesh over `ranks` (default the first n_data *
    n_tile ranks of the group). Every rank of the process group must call
    it, in the same order (subgroup creation is collective); a rank outside
    the mesh gets None. device: default the GPU, raising where there is none."""
    device = resolve_device(device)
    ranks = list(range(n_data * n_tile)) if ranks is None else list(ranks)
    world = process_count()
    if len(ranks) != n_data * n_tile or max(ranks) >= world:
        raise ValueError(f"a {n_data}x{n_tile} mesh needs {n_data * n_tile} of the {world} "
                         f"ranks, got {ranks}")
    me = process_index()
    tile_group = data_group = None
    grid = [[ranks[d * n_tile + t] for t in range(n_tile)] for d in range(n_data)]
    if world > 1:
        rows = [dist.new_group(row) if n_tile > 1 else None for row in grid]
        cols = [dist.new_group([grid[d][t] for d in range(n_data)]) if n_data > 1 else None
                for t in range(n_tile)]
    if me not in ranks:
        return None
    i = ranks.index(me)
    d, t = divmod(i, n_tile)
    if world > 1:
        tile_group, data_group = rows[d], cols[t]
    return Mesh(n_data, n_tile, me, d, t, tile_group, data_group, device)


def global_mesh(n_data: int = 0, n_tile: int = 0, device=None) -> Mesh:
    """A mesh over every rank of the process group (a 1 x 1 mesh without
    one). n_data = n_tile = 0 factors automatically as moss_tpu does: tile
    takes up to 4 ranks (only the band gather rides it), data the rest; one
    of them 0 takes what the other leaves."""
    device = resolve_device(device)
    n = process_count()
    if n_data == 0 and n_tile == 0:
        n_tile = next(t for t in (4, 2, 1) if n % t == 0 and t <= n)
        n_data = n // n_tile
    elif n_tile == 0:
        n_tile = n // n_data
    elif n_data == 0:
        n_data = n // n_tile
    if n_data * n_tile != n:
        raise ValueError(f"mesh {n_data}x{n_tile} does not cover the {n} processes")
    return make_mesh(n_data, n_tile, device=device)
