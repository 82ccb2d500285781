"""Mesh construction: a (dp, shard) grid of torch devices.

Counterpart of picovdb_tpu/parallel/mesh.py. `shard` splits the corpus
rows, `dp` the query batch. PyTorch has no virtual devices, so a grid may
name one device more than once: `[torch.device("cpu")] * 8` is how the CPU
tests hold an eight-shard mesh, and `[cuda:0] * 4` is a four-shard mesh on
one card (its shards run one after another on that card's stream). Shards
on distinct cards run at the same time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A (dp, shard) grid of `torch.device`s with named axes.

    `devices` is a numpy object array of shape (dp, shards); `shape` maps
    each axis name to its size (`mesh.shape["shard"]`, as in JAX)."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        grid = np.asarray(
            [[torch.device(d) for d in row] for row in devices], dtype=object)
        if grid.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D (dp, shard) grid of devices")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: grid.shape[0],
                      axis_names[1]: grid.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def row(self, r: int = 0) -> list:
        """The devices of mesh row `r`, one per shard."""
        return list(self.devices[r])

    @property
    def first(self) -> torch.device:
        """Where merged results and replicated state live."""
        return self.devices[0, 0]


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
