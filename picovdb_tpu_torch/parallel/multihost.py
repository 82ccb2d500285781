"""Multi-process stores: bootstrap, the pod mesh, per-rank shard loading,
and the collectives the mesh routes run across processes.

Counterpart of picovdb_tpu/parallel/multihost.py on `torch.distributed`:

  * `init_distributed()` wraps `torch.distributed.init_process_group`,
    with an explicit address or the `env://` launcher variables
    (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, as torchrun sets
    them), to be called once per process before building a mesh.
  * `pod_mesh()` is a (dp, shard) mesh over every rank's local devices
    (one card a rank by default, `cuda:LOCAL_RANK`): each rank owns the
    shard columns of its devices and holds only their rows.
  * `load_host_shard()` reads only this rank's file of a
    `save(shards=world)` checkpoint.

One process (rank) per card is the deployment: each holds its corpus
shards, a query runs the local shards' kernels and merges the (Q, k)
slabs of every rank through the process group, so every rank returns the
same answer. Every rank must issue the same calls in the same order (the
SPMD contract): the collectives below pair up across ranks by order.

Under NCCL the tensors a collective carries stay on the card; under gloo
they are staged through host memory (`Mesh.host_staged`), because gloo's
CUDA collectives are partial (no point-to-point). The backend is the
caller's choice and is never switched after a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import persistence
from ..utils import round_up
from .mesh import Mesh


def _dist():
    import torch.distributed as dist

    return dist


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: str = "nccl",
                     timeout_s: Optional[float] = None) -> None:
    """Initialise the default process group (no-op if already up, and
    without an address or the `env://` variables).

    `init_method` (e.g. "tcp://host:port") with `world_size` and `rank`,
    or, when it is None, `env://` whenever `MASTER_ADDR` and
    `MASTER_PORT` are set (rank and world size then come from `RANK` /
    `WORLD_SIZE` unless given). Under NCCL the process binds its card,
    `cuda:LOCAL_RANK`, first. Only the already-initialised case is
    swallowed: a connect failure raises here."""
    dist = _dist()
    if init_method is None:
        if not (os.getenv("MASTER_ADDR") and os.getenv("MASTER_PORT")):
            # no address anywhere: a single-process caller keeps working
            return
        init_method = "env://"
    if dist.is_initialized():
        return
    if world_size is None and os.getenv("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.getenv("RANK"):
        rank = int(os.environ["RANK"])
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(_local_rank(rank))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    try:
        dist.init_process_group(
            backend=backend, init_method=init_method,
            world_size=-1 if world_size is None else int(world_size),
            rank=-1 if rank is None else int(rank), **kw)
    except (RuntimeError, ValueError) as e:
        if "twice" not in str(e) and "already" not in str(e).lower():
            raise


def _local_rank(rank: Optional[int]) -> int:
    """This process's card index: LOCAL_RANK, else the rank modulo the
    card count."""
    if os.getenv("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    count = max(1, torch.cuda.device_count())
    return (rank or 0) % count


def pod_mesh(dp: int = 1, devices: Optional[Sequence] = None,
             shard_axis: str = "shard", dp_axis: str = "dp") -> Mesh:
    """(dp, shard) mesh over every rank's local devices.

    The local devices are `devices`, else `cuda:LOCAL_RANK` (raises
    without a card: a mesh never falls back to the CPU). Every rank must
    bring the same number of devices, a multiple of dp: each rank's
    devices split into dp rows, so rank p owns shard columns [p * c,
    (p + 1) * c), c = local devices / dp, in every row, and a dp row's
    copy of a shard stays on the rank that owns it. The mesh's group is
    the default process group; without one (or with one process) this is
    `make_mesh` over the local devices."""
    dist = _dist()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pod_mesh: no CUDA device is available; pass devices= "
                "(e.g. [torch.device('cpu')]) to build a host mesh")
        rank = dist.get_rank() if dist.is_initialized() else 0
        devices = [torch.device("cuda", _local_rank(rank))]
    local = [torch.device(d) for d in devices]
    if dp < 1 or len(local) % dp:
        raise ValueError(
            f"{len(local)} local devices do not split into dp={dp} rows")
    if not dist.is_initialized() or dist.get_world_size() == 1:
        c = len(local) // dp
        return Mesh([local[r * c:(r + 1) * c] for r in range(dp)],
                    (dp_axis, shard_axis))
    world = dist.get_world_size()
    rank = dist.get_rank()
    every = [None] * world
    dist.all_gather_object(every, [str(d) for d in local])
    if len({len(x) for x in every}) != 1:
        raise ValueError(
            f"ranks bring unequal device counts {[len(x) for x in every]}")
    c = len(local) // dp
    grid = [[torch.device(every[p][r * c + j]) for p in range(world)
             for j in range(c)] for r in range(dp)]
    owners = [p for p in range(world) for _ in range(c)]
    return Mesh(grid, (dp_axis, shard_axis), owners=owners, rank=rank,
                world_size=world, group=dist.group.WORLD)


def load_host_shard(base: str, dim: int, mesh: Mesh,
                    shard_axis: str = "shard"):
    """This rank's rows of a `save(shards=world)` checkpoint, on its
    devices: (blocks, global rows).

    Reads only this rank's file. Every block is padded to the same row
    count B, so the shard-axis device j (over all ranks) holds global rows
    [j * B, (j + 1) * B) and the global row count is B x shard devices
    (the padding rows are zeros; the engine marks them inactive).
    `blocks` lists this rank's blocks in shard order, each a (B, dim)
    float32 tensor on its device."""
    paths = persistence.validated_shards(base)
    if not paths:
        raise FileNotFoundError(f"no shard files for {base}")
    nproc, pid = mesh.world_size, mesh.rank
    if len(paths) != nproc:
        raise ValueError(f"{len(paths)} shard files but {nproc} processes")
    shapes = [np.load(p, mmap_mode="r").shape for p in paths]  # header-only
    for p, s in zip(paths, shapes):
        if len(s) != 2 or s[1] != dim:
            raise ValueError(f"shard {p} has shape {s}")
    # the writer's split is fixed-per (persistence.shard_split_rows): `per`
    # rows up to a cut, at most one short shard at the cut, empties after;
    # padding short or empty blocks up to `per` keeps shard i's rows at
    # global positions i * per + j
    per = shapes[0][0]
    rows_seq = [s[0] for s in shapes]
    cut = next((i for i, r in enumerate(rows_seq) if r != per),
               len(rows_seq))
    ok = (per > 0
          and all(r == per for r in rows_seq[:cut])
          and (cut >= len(rows_seq) or rows_seq[cut] < per)
          and all(r == 0 for r in rows_seq[cut + 1:]))
    if not ok:
        raise ValueError(
            f"unexpected shard row layout {rows_seq} for {base!r}; "
            "expected the fixed-per split (persistence.shard_split_rows:"
            " equal rows, at most one short shard, empties after)"
        )
    nsh = mesh.shape[shard_axis]
    if nsh % nproc:
        raise ValueError(
            f"shard axis has {nsh} devices over {nproc} processes; "
            "devices must distribute evenly"
        )
    ldc = nsh // nproc
    if nproc > 1 and per % ldc:
        raise ValueError(
            f"non-last shards hold {per} rows, not divisible by the "
            f"{ldc} local devices on the shard axis; re-save with the "
            "current writer (persistence.SHARD_ROW_ALIGN) or use a "
            "host/device topology whose local device count divides "
            f"{per}"
        )
    per_eff = per if nproc > 1 else round_up(max(per, 1), ldc)
    b = per_eff // ldc
    local = np.load(paths[pid], mmap_mode="r")
    blocks = []
    for j, s in enumerate(mesh.local_shards):
        dev = mesh.row(0)[s]
        t = torch.zeros((b, dim), dtype=torch.float32, device=dev)
        lo, hi = j * b, min(local.shape[0], (j + 1) * b)
        for a in range(lo, hi, 262_144):
            e = min(hi, a + 262_144)
            t[a - lo:e - lo] = torch.from_numpy(
                np.array(local[a:e], dtype=np.float32)).to(dev)
        blocks.append(t)
    return blocks, b * nsh


# -- collectives over a mesh's process group ---------------------------------


def _wire_device(mesh: Mesh) -> torch.device:
    """Where the tensors a collective carries live: host memory under
    gloo, this rank's first card under NCCL (its communicator's)."""
    return torch.device("cpu") if mesh.host_staged else mesh.first


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` as a collective carries it (see `_wire_device`)."""
    return t.to(_wire_device(mesh)).contiguous()


def gather_slabs(mesh: Mesh, slab: torch.Tensor) -> torch.Tensor:
    """Every rank's (Q, c) slab side by side, in rank order, on `slab`'s
    device: (Q, world * c). One all_gather."""
    w = _wire(mesh, slab)
    parts = [torch.empty_like(w) for _ in range(mesh.world_size)]
    _dist().all_gather(parts, w, group=mesh.group)
    return torch.cat(parts, dim=1).to(slab.device, non_blocking=True)


def broadcast_from(mesh: Mesh, src: int, t: Optional[torch.Tensor],
                   shape, dtype, device) -> torch.Tensor:
    """Rank `src`'s tensor `t` on every rank (others pass None and the
    shape / dtype it has), on `device`."""
    if mesh.rank == src:
        w = _wire(mesh, t)
    else:
        w = torch.empty(shape, dtype=dtype, device=_wire_device(mesh))
    _dist().broadcast(w, src=src, group=mesh.group)
    return w.to(device)


def agree_max(mesh: Mesh, value: int) -> int:
    """The largest of every rank's `value` (e.g. a failure code), so all
    ranks take the same branch."""
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_wire_device(mesh))
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def barrier(mesh: Mesh) -> None:
    if mesh.host_staged:
        _dist().barrier(group=mesh.group)
    else:  # NCCL's barrier needs the card it serves
        _dist().barrier(group=mesh.group,
                        device_ids=[mesh.first.index or 0])


def move_rows(mesh: Mesh, total: int, src_rows: int, src_owner: Callable,
              read: Callable, dst_rows: int, n_dst: int,
              dst_owner: Callable, write: Callable, tail: tuple,
              dtype: torch.dtype, chunk: int,
              remote_only: bool = False) -> None:
    """Move the global rows [0, total) from one row-partitioned layout to
    another across ranks.

    Source part o holds rows [o * src_rows, (o + 1) * src_rows) on rank
    src_owner(o); destination part s rows [s * dst_rows, ...) on rank
    dst_owner(s), s < n_dst. `read(o, a, b)` returns rows [a, b) of part
    o (called on its owner), `write(s, a, b, rows)` stores them in part s
    (called on its owner). Rows travel in `chunk`-row pieces, point to
    point, in one order every rank walks, so the sends and receives pair
    up without a deadlock; `remote_only` skips the pieces whose two parts
    share a rank. No rank ever holds more than its parts plus a piece."""
    dist = _dist()
    me = mesh.rank
    for s in range(n_dst):
        lo, hi = s * dst_rows, min(total, (s + 1) * dst_rows)
        do = dst_owner(s)
        for o in range(lo // src_rows, -(-hi // src_rows) if hi > lo else 0):
            so = src_owner(o)
            if me not in (so, do) or (remote_only and so == do):
                continue
            a0, b0 = max(lo, o * src_rows), min(hi, (o + 1) * src_rows)
            for a in range(a0, b0, chunk):
                b = min(b0, a + chunk)
                if so == do:
                    write(s, a, b, read(o, a, b))
                elif so == me:
                    dist.send(_wire(mesh, read(o, a, b)), dst=do,
                              group=mesh.group)
                else:
                    buf = torch.empty((b - a,) + tuple(tail), dtype=dtype,
                                      device=_wire_device(mesh))
                    dist.recv(buf, src=so, group=mesh.group)
                    write(s, a, b, buf)
