"""Row-sharded exact query with a cross-device top-k merge.

Counterpart of picovdb_tpu/parallel/sharded_query.py. Each corpus shard
computes a local masked top-k on its own device: the plain exact scan
(`exact_topk`), or, with `use_pallas`, K4 `fused_topk` over float32 /
bfloat16 rows, K3 `fused_topk_i8` over int8 storage rows and K6
`fused_topk_i4` over packed int4 rows, each with a +4 guard and an exact
(dequantizing) rescore before the cut, so selection noise never reaches
the merge. Local rows become global slots (`shard * rows_local`), the
(Q, k) slabs of every shard move to the mesh row's first device, and one
selection over the (Q, shards * k) slab keeps the k best, ties to the
lower global slot: the order JAX's stable `lax.top_k` gives over its
shard-ordered slab.

Every shard's work is enqueued before anything is read back to the host,
and the queries are copied to every shard's card before any shard's scan
is enqueued (a cross-card copy runs on the source card's stream), so
shards on distinct cards run at the same time.

Across processes (a `multihost.pod_mesh`) each rank runs only its own
shards, merges their slabs as above, and then one `all_gather` of the
merged (Q, k) scores and global slots and the same selection over the
ranks' slabs give every rank the same answer (`merge_ranks`); the
planes hold None at the shards of other ranks. With a `dp` axis the
query batch splits into dp contiguous parts, mesh row r serves part r from
the planes given for row r, and the parts concatenate in order on the
mesh's first device.

Nothing is compiled, so unlike JAX there is no build cache to bound: the
returned function holds only the mesh and its parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.exact import exact_topk, exact_topk_i4r, exact_topk_i8r
from ..ops.exact import normalize_on_device
from ..ops.scan import (
    _to_sortable,
    fused_topk_i4,
    fused_topk_i8,
    make_fused_topk,
    quantize_rows_i8,
    rescore_exact_i4r,
    rescore_exact_i8r,
)

SHARD_GUARD = 4  # the kernel routes' selection band beyond k_local


def merge_topk(vals: Sequence[torch.Tensor], slots: Sequence[torch.Tensor],
               k: int, device: torch.device):
    """Exact merge of per-shard (Q, k_s) candidate slabs on `device`:
    the top min(k, sum k_s) by score, ties to the lower slot (a slot < 0,
    a missing candidate, ranks after every real one). Returns ((Q, k)
    float32 scores, (Q, k) int32 slots)."""
    v = torch.cat([t.to(device, non_blocking=True) for t in vals], dim=1)
    s = torch.cat([t.to(device, non_blocking=True) for t in slots], dim=1)
    hi = _to_sortable(v.float().contiguous().view(torch.int32)).to(torch.int64)
    lo = 0xFFFFFFFF - (s.to(torch.int64) & 0xFFFFFFFF)
    k_final = min(k, v.shape[1])
    pos = torch.topk((hi << 32) | lo, k_final, dim=1).indices
    return v.gather(1, pos), s.gather(1, pos).to(torch.int32)


def merge_ranks(mesh, vals: torch.Tensor, slots: torch.Tensor, k: int):
    """Merge every rank's (Q, c) candidate slab through the mesh's process
    group: one all_gather of the scores (bitcast) and slots side by side,
    then `merge_topk` over the (Q, world * c) slab on `vals`' device, so
    ties still go to the lower global slot."""
    from .multihost import gather_slabs

    nq, c = vals.shape
    packed = torch.cat([vals.float().contiguous().view(torch.int32),
                        slots.to(torch.int32)], dim=1)
    every = gather_slabs(mesh, packed).view(nq, mesh.world_size, 2, c)
    v = every[:, :, 0].reshape(nq, -1).contiguous().view(torch.float32)
    s = every[:, :, 1].reshape(nq, -1)
    return merge_topk([v], [s], k, vals.device)


def _local_float(q, v, m, k, use_pallas, compute_dtype_name):
    rows_local = v.shape[0]
    k_local = min(k, rows_local)
    if use_pallas:
        k_sel = min(k_local + SHARD_GUARD, rows_local)
        fn = make_fused_topk(k_local, compute_dtype_name, normalize=False,
                             guard=k_sel - k_local)
        return fn(q, v, m)
    return exact_topk(q, v, m, k_local, compute_dtype_name)


def _local_quant(q, q_i8, vq, vs, m, k, use_pallas, i4):
    rows_local = vq.shape[0]
    k_local = min(k, rows_local)
    if use_pallas:
        k_sel = min(k_local + SHARD_GUARD, rows_local)
        select = fused_topk_i4 if i4 else fused_topk_i8
        rescore = rescore_exact_i4r if i4 else rescore_exact_i8r
        vals, idx = select(q_i8, vq, vs, m, k_sel)
        vals, idx = rescore(q, vq, vs, vals, idx)
        return vals[:, :k_local], idx[:, :k_local]
    exact = exact_topk_i4r if i4 else exact_topk_i8r
    return exact(q, vq, vs, m, k_local)


def make_sharded_topk(mesh, shard_axis: str, k: int,
                      compute_dtype_name: Optional[str] = None,
                      dp_axis: str = "dp", use_pallas: bool = False,
                      normalize: bool = True, storage_i8: bool = False,
                      storage_i4: bool = False):
    """The sharded masked top-k for a fixed k.

    fn(queries (Q, dim), vectors, mask) -> (values (Q, k') float32,
    indices (Q, k') int32 global slots), k' = min(k, shards * rows_local),
    on the mesh's first device. `vectors` and `mask` hold one list per
    mesh row of one tensor per shard ((rows_local, dim) and (rows_local,)
    bool, on that shard's device): `[plane]` on a one-row mesh, and on a
    dp mesh the planes each row serves from (`DeviceIndex.mesh_planes`).

    `storage_i8` / `storage_i4` serve int8 / packed int4 STORAGE: fn then
    takes the per-shard row scales after `vectors`, fn(queries, vectors,
    vscale, mask); each shard selects over its quantized rows with the
    int8-quantized queries and rescores the winners dequantized, so the
    merged scores carry storage precision as on one device."""
    quant = storage_i8 or storage_i4
    dp = mesh.shape.get(dp_axis, 1)

    def stage(r, q):
        """Row r's queries (and their int8 form for the quantized kernels)
        on each of this rank's shard devices. A copy across cards runs on
        the source card's stream, behind whatever that stream already
        holds, so every copy is enqueued before any shard's scan: made
        after shard 0's scan, the copy to shard 1 would wait for it."""
        devices = mesh.row(r)
        q_i8 = quantize_rows_i8(q)[0] if quant and use_pallas else None
        return [(s, q.to(devices[s], non_blocking=True),
                 None if q_i8 is None
                 else q_i8.to(devices[s], non_blocking=True))
                for s in mesh.local_shards]

    def serve_row(r, staged, planes):
        per = [p[r] for p in planes]
        vals, slots = [], []
        for s, qs, qi in staged:
            if quant:
                vq, vs, m = per[0][s], per[1][s], per[2][s]
                v_s, i_s = _local_quant(qs, qi, vq, vs, m, k, use_pallas,
                                        storage_i4)
            else:
                v, m = per[0][s], per[1][s]
                v_s, i_s = _local_float(qs, v, m, k, use_pallas,
                                        compute_dtype_name)
            vals.append(v_s)
            slots.append(i_s + s * per[0][s].shape[0])
        top = merge_topk(vals, slots, k, mesh.row(r)[mesh.local_shards[0]])
        return merge_ranks(mesh, *top, k) if mesh.multiprocess else top

    def fn(q, *planes):
        q = q.to(mesh.first, dtype=torch.float32)
        if normalize:
            q = normalize_on_device(q)
        parts = ([(0, q)] if dp == 1 else
                 [(r, p) for r, p in enumerate(torch.tensor_split(q, dp))
                  if p.shape[0]])
        staged = [(r, stage(r, p)) for r, p in parts]
        outs = [serve_row(r, st, planes) for r, st in staged]
        if dp == 1:
            return outs[0]
        return (torch.cat([o[0].to(mesh.first) for o in outs]),
                torch.cat([o[1].to(mesh.first) for o in outs]))

    return fn
