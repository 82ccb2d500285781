"""Mesh construction: a (dp, shard) grid of torch devices.

Counterpart of picovdb_tpu/parallel/mesh.py. `shard` splits the corpus
rows, `dp` the query batch. PyTorch has no virtual devices, so a grid may
name one device more than once: `[torch.device("cpu")] * 8` is how the CPU
tests hold an eight-shard mesh, and `[cuda:0] * 4` is a four-shard mesh on
one card (its shards run one after another on that card's stream). Shards
on distinct cards run at the same time.

A mesh may span processes (`multihost.pod_mesh`): it then names every
rank's devices, carries the process group, this process's `rank` and the
`world_size`, and which rank owns each shard column (`owners`); a rank
touches only its own columns (`local_shards`). A mesh built by
`make_mesh` is one process's: every column is local.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A (dp, shard) grid of `torch.device`s with named axes.

    `devices` is a numpy object array of shape (dp, shards); `shape` maps
    each axis name to its size (`mesh.shape["shard"]`, as in JAX).
    Across processes, `owners[s]` is the rank that holds shard column s
    (in every row), `group` the process group the collectives run in
    (whose ranks `rank` and `owners` count)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 owners: Optional[Sequence[int]] = None, rank: int = 0,
                 world_size: int = 1, group=None) -> None:
        grid = np.asarray(
            [[torch.device(d) for d in row] for row in devices], dtype=object)
        if grid.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D (dp, shard) grid of devices")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: grid.shape[0],
                      axis_names[1]: grid.shape[1]}
        self.owners = (np.zeros(grid.shape[1], dtype=np.int64)
                       if owners is None else np.asarray(owners, np.int64))
        if self.owners.shape != (grid.shape[1],):
            raise ValueError(f"{self.owners.shape[0]} owners for "
                             f"{grid.shape[1]} shard columns")
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.group = group
        self.local_shards = [int(s) for s in
                             np.nonzero(self.owners == self.rank)[0]]
        if not self.local_shards:
            raise ValueError(f"rank {rank} owns no shard column")

    @property
    def multiprocess(self) -> bool:
        return self.world_size > 1

    @property
    def host_staged(self) -> bool:
        """Whether the collectives stage tensors through host memory
        (every backend of `group` but NCCL: gloo's CUDA collectives are
        partial) rather than carry them on the card."""
        if self.group is None:
            return True
        import torch.distributed as dist

        return dist.get_backend(self.group) != "nccl"

    def is_local(self, s: int) -> bool:
        return int(self.owners[s]) == self.rank

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def row(self, r: int = 0) -> list:
        """The devices of mesh row `r`, one per shard."""
        return list(self.devices[r])

    def local_row(self, r: int = 0) -> list:
        """The devices of mesh row `r`, None where another rank owns the
        column."""
        return [d if self.is_local(s) else None
                for s, d in enumerate(self.devices[r])]

    @property
    def first(self) -> torch.device:
        """Where merged results and replicated state live: this rank's
        first device of row 0."""
        return self.devices[0, self.local_shards[0]]


def make_mesh(
    n_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = "shard",
    dp: int = 1,
    dp_axis: str = "dp",
) -> Mesh:
    """A (dp, shard) mesh over the given devices, or over every CUDA
    device (`cuda:0 ... cuda:{n-1}`). Without a card and without
    `devices` this raises: a mesh never falls back to the CPU. Devices may
    repeat (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [torch.device('cpu')] * 8) to build a host mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if dp < 1:
        raise ValueError(f"dp must be >= 1; got {dp}")
    if n_shards is None:
        n_shards = len(devices) // dp
    if n_shards < 1 or dp * n_shards > len(devices):
        raise ValueError(
            f"a {dp} x {n_shards} mesh needs {dp * n_shards} devices; "
            f"got {len(devices)}")
    use = devices[: dp * n_shards]
    return Mesh([use[r * n_shards:(r + 1) * n_shards] for r in range(dp)],
                (dp_axis, axis_name))


def default_mesh(axis_name: str = "shard") -> Mesh:
    """Every CUDA device on one corpus-shard axis."""
    return make_mesh(axis_name=axis_name)
