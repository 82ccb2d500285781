"""Sharded IVF tier: shared centroids, per-shard postings, one merge.

Counterpart of picovdb_tpu/parallel/ivf_mesh.py (its single-process part):

  * **One shared centroid table**, trained once by k-means on a sample of
    the whole corpus (`ops/ivf.py::_kmeans` / `_assign` on the mesh's first
    device) and copied to every shard's device, so probing does not
    depend on the shard count.
  * **Per-shard postings**: each shard holds a cluster-contiguous reorder
    of the rows it owns (`seg_starts`, `cluster2tile`, `slots`, `active`,
    and the storage-dtype `vectors` or, in the int8-only layout, only the
    column-scaled `vectors_i8c` with per-shard column scales). The classic
    layout splits the active rows equally; the int8-only layout places
    each row on its OWNING corpus shard (slot // corpus rows a shard), so
    its exact rescore reads the engine's shard on the same device. Each
    shard keeps 4 % (at least 64 rows) of slack beyond its built rows:
    the overflow region `update` appends to (cluster id nlist, always
    probed).
  * **Search**: the queries go to every shard; each shard runs the probe
    preamble and K7 (`ops/ivf.py::probe_scan_local`) over its own hot
    tiles with the birthday-bound `g_tiles`, rescores its `k + guard`
    band exactly and returns its top k (exact score, global slot); the
    k x shards candidates merge as in parallel/sharded_query.py. Every
    shard's work is enqueued before any host read.

Across processes (a `multihost.pod_mesh`) every rank builds from the
whole host matrix, as picovdb_tpu's processes do: rank 0's centroids
are broadcast so all ranks probe the same table, the host bookkeeping
(placement, overflow fill, the int8-only layout's column scales) is the
same on every rank, and each rank uploads and searches only its own
shards; the searches' slabs merge through the process group
(`sharded_query.merge_ranks`). The classic layout's opt-in int8 mirror
then has no host copy of the other ranks' column scales, so its update
re-derives each shard's mirror instead of requantizing (as picovdb_tpu
does when the scales are not addressable).

Sidecars keep the single-device schema (`to_blob` / `from_blob`), so an
`index="ivf"` store moves between mesh and single-device processes, and
between this package and picovdb_tpu. picovdb_tpu's `warm_update_path`
(pre-compiling the update scatters) has no counterpart: eager PyTorch
compiles nothing. A dp axis is not used here: the queries go to the
mesh's first row.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import Float
from ..ops.exact import normalize_on_device
from ..ops.ivf import (
    IVF_BN,
    _assign,
    _i8_clip_max,
    _i8_requantize,
    _ivf_guard,
    _ivf_i8_mirror,
    _kmeans,
    default_nlist,
    ef_to_nprobe,
    probe_scan_local,
)
from ..ops.scan import quantize_cols_i8
from ..utils import next_pow2, round_up
from .sharded_query import merge_ranks, merge_topk


def _up(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


class ShardedIVF:
    """Shared-centroid IVF with per-shard postings over a mesh's devices.
    Every device array is a list with one tensor per shard."""

    def __init__(self, centroids, vectors, slots, active, seg_starts,
                 cluster2tile, nlist: int, n_tiles: int, cap_shard: int,
                 dim: int, mesh, shard_axis: str, vectors_i8c=None,
                 cscale=None, corpus_cap: Optional[int] = None) -> None:
        self.centroids = centroids  # (nlist_pad, dim) f32, one per shard
        self.vectors = vectors  # (cap_shard, dim) storage dtype, or None
        # (cap_shard,) int64. Classic layout: GLOBAL engine slots.
        # int8-only layout: LOCAL rows of the owning corpus shard.
        self.slots = slots
        self.active = active  # (cap_shard,) bool
        self.seg_starts = seg_starts  # (nlist + 2,) int64
        self.cluster2tile = cluster2tile  # (nlist_pad, n_tiles) f32 0/1
        self.nlist = nlist
        self.n_tiles = n_tiles  # per shard
        self.cap_shard = cap_shard
        self.dim = dim
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.devices = mesh.local_row(0)  # None at another rank's shard
        self.nshards = len(self.devices)
        # int8-only layout: the corpus capacity the owner placement was
        # laid out against (a re-padded corpus moved rows between shards)
        self.corpus_cap = corpus_cap
        self._host_blob: Optional[dict] = None
        # host bookkeeping of in-place updates (set by `build`): global
        # slot -> stacked postings row (shard * cap_shard + local row),
        # rows used per shard, rows at build, each stacked row's cluster
        self._slot2row: Optional[np.ndarray] = None
        self._n_used: Optional[np.ndarray] = None
        self._n_build: int = 0
        self._row_cluster_np: Optional[np.ndarray] = None
        self._blob_stale = False
        # frozen per-shard column scales (nshards, dim) for
        # requantize-on-append, and the corpus rows a shard the owner
        # placement used (int8-only layout)
        self._cscale_np: Optional[np.ndarray] = None
        self._shard_rows_corpus: int = 0
        self.last_update_clip_fraction: Optional[float] = None
        # per-shard column-scaled int8 postings: the int8-only layout's only
        # postings, or the classic layout's opt-in selection mirror
        self.vectors_i8c = vectors_i8c
        self.cscale = cscale
        if vectors is not None and _ivf_i8_mirror(dim):
            self._derive_mirror()

    def _derive_mirror(self) -> None:
        """(Re)derive the classic layout's per-shard int8 mirror, each
        shard with its own column scales, and freeze them on the host."""
        pairs = [(None, None) if v is None else quantize_cols_i8(v)
                 for v in self.vectors]
        self.vectors_i8c = [p[0] for p in pairs]
        self.cscale = [p[1] for p in pairs]
        self._cscale_np = (None if self.mesh.multiprocess else np.stack(
            [c.cpu().numpy() for c in self.cscale]))

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, host_vectors: np.ndarray, active_mask: np.ndarray, mesh,
              shard_axis: str = "shard", nlist: Optional[int] = None,
              dim: Optional[int] = None, iters: int = 8, seed: int = 0,
              warm_centroids: Optional[np.ndarray] = None,
              storage_dtype: Optional[str] = None, i8_only: bool = False,
              corpus_cap: Optional[int] = None) -> "ShardedIVF":
        """Train the shared centroids, lay out per-shard postings on the
        host and upload each shard to its device. The build is fed from
        the host corpus, as picovdb_tpu's; k-means and the assignment run
        on the mesh's first device.

        `i8_only=True` (int8 / int4 storage, or a float store whose
        classic postings would not fit): the postings are column-scaled
        int8 only, rows placed on their owning corpus shard (`corpus_cap`,
        a multiple of the shard count, gives the corpus rows a shard), and
        the search rescores them from the engine's corpus by slot."""
        dim = int(dim if dim is not None else host_vectors.shape[1])
        devices = mesh.local_row(0)
        nshards = len(devices)
        first = mesh.first
        size = host_vectors.shape[0]
        act_rows = np.nonzero(active_mask[:size])[0]
        n_active = act_rows.shape[0]
        if n_active == 0:
            raise ValueError("cannot build IVF over an empty corpus")
        nlist = int(nlist) if nlist else default_nlist(n_active)
        nlist = min(nlist, n_active)

        def rows_f32(sel):
            return np.ascontiguousarray(host_vectors[sel], dtype=Float)

        rng = np.random.default_rng(seed)
        if warm_centroids is not None and warm_centroids.shape == (nlist, dim):
            init = _up(np.asarray(warm_centroids, dtype=Float), first)
            train_iters = max(0, min(iters, 2))
        else:
            pick = act_rows[rng.choice(n_active, size=nlist, replace=False)]
            init = _up(rows_f32(pick), first)
            train_iters = iters
        if mesh.multiprocess and mesh.rank != 0:
            centroids = None  # rank 0 trains; its table arrives below
        elif train_iters:
            n_train = min(n_active, max(nlist * 50, 10_000))
            tr = (act_rows if n_train >= n_active else act_rows[
                np.sort(rng.choice(n_active, size=n_train, replace=False))])
            centroids = _kmeans(_up(rows_f32(tr), first), init, nlist,
                                train_iters)
        else:
            centroids = init
        if mesh.multiprocess:  # every rank probes rank 0's table
            from .multihost import broadcast_from

            centroids = broadcast_from(
                mesh, 0, None if centroids is None else centroids.contiguous(),
                (nlist, dim), torch.float32, first)
        assign = np.empty(n_active, dtype=np.int64)
        a_chunk = 131_072
        for s in range(0, n_active, a_chunk):
            e = min(n_active, s + a_chunk)
            assign[s:e] = _assign(_up(rows_f32(act_rows[s:e]), first),
                                  centroids).cpu().numpy()

        # classic layout: a contiguous equal split of the active rows;
        # int8-only: each row on its owning corpus shard
        if i8_only:
            if not corpus_cap or corpus_cap % nshards:
                raise ValueError(
                    f"i8_only mesh IVF needs the corpus capacity (multiple "
                    f"of {nshards}); got {corpus_cap}")
            shard_rows_corpus = corpus_cap // nshards
            owner = act_rows // shard_rows_corpus
            shard_sel = [np.nonzero(owner == s)[0] for s in range(nshards)]
            per = max((int(x.shape[0]) for x in shard_sel), default=1)
        else:
            per = -(-n_active // nshards)
            shard_sel = [np.arange(s * per, min((s + 1) * per, n_active))
                         for s in range(nshards)]
        slack = max(64, int(0.04 * max(per, 1)))
        cap_shard = round_up(max(per, 1) + slack, IVF_BN)
        n_tiles = cap_shard // IVF_BN
        nlist_pad = round_up(nlist + 1, 8)
        store_dt = (torch.bfloat16 if storage_dtype == "bfloat16"
                    else torch.float32)

        cent_np = np.zeros((nlist_pad, dim), dtype=Float)
        cent_np[:nlist] = centroids.cpu().numpy()
        # shards with no built rows keep the quantizer's zero-column floor
        # as their scales: an append routed there clips ~100 % and the
        # clip guard sends it to a rebuild (see picovdb_tpu)
        cs_np = np.full((nshards, dim), np.float32(1e-30 / 127.0),
                        dtype=np.float32)
        row_cluster_np = np.full(nshards * cap_shard, nlist, dtype=np.int32)
        n_used = np.zeros(nshards, dtype=np.int64)
        s2r = np.full(int(act_rows.max()) + 1, -1, dtype=np.int64)
        lists = {name: [] for name in ("cent", "vec", "slots", "act", "segs",
                                       "c2t", "i8", "cs")}
        for s, dev in enumerate(devices):
            sel_s = shard_sel[s]
            local_rows = act_rows[sel_s]
            order = np.argsort(assign[sel_s], kind="stable")
            sorted_clusters = assign[sel_s][order]
            n_local = local_rows.shape[0]
            gsel = local_rows[order]
            base = s * cap_shard
            row_cluster_np[base:base + n_local] = sorted_clusters
            n_used[s] = n_local
            s2r[gsel] = base + np.arange(n_local)
            # the int8-only layout's scales are every rank's host state
            # (update's clip guard decides alike on all of them)
            rows = (rows_f32(gsel) if dev is not None or (i8_only and n_local)
                    else None)
            if i8_only and n_local:
                cs_np[s] = np.maximum(np.abs(rows).max(axis=0), 1e-30) / 127.0
            if dev is None:  # another rank's shard
                for name in lists:
                    lists[name].append(None)
                continue
            slots_np = np.full(cap_shard, -1, dtype=np.int64)
            act_np = np.zeros(cap_shard, dtype=bool)
            act_np[:n_local] = True
            if i8_only:
                post = np.zeros((cap_shard, dim), dtype=np.int8)
                if n_local:
                    post[:n_local] = np.clip(np.rint(rows / cs_np[s]), -127,
                                             127).astype(np.int8)
                slots_np[:n_local] = gsel - s * shard_rows_corpus
                lists["i8"].append(_up(post, dev))
                lists["cs"].append(_up(cs_np[s], dev))
            else:
                vec = torch.zeros((cap_shard, dim), dtype=store_dt, device=dev)
                vec[:n_local] = _up(rows, dev, store_dt)
                slots_np[:n_local] = gsel
                lists["vec"].append(vec)
            del rows
            starts = np.searchsorted(sorted_clusters, np.arange(nlist + 1))
            segs = np.concatenate([starts, [cap_shard]]).astype(np.int64)
            local_cluster = np.full(cap_shard, nlist, dtype=np.int64)
            local_cluster[:n_local] = sorted_clusters
            c2t = np.zeros((nlist_pad, n_tiles), dtype=Float)
            c2t[local_cluster, np.arange(cap_shard) // IVF_BN] = 1.0
            c2t[nlist] = 0.0  # the overflow bucket probes nothing yet
            lists["cent"].append(_up(cent_np, dev))
            lists["slots"].append(_up(slots_np, dev))
            lists["act"].append(_up(act_np, dev))
            lists["segs"].append(_up(segs, dev))
            lists["c2t"].append(_up(c2t, dev))

        idx = cls(centroids=lists["cent"],
                  vectors=None if i8_only else lists["vec"],
                  slots=lists["slots"], active=lists["act"],
                  seg_starts=lists["segs"], cluster2tile=lists["c2t"],
                  nlist=nlist, n_tiles=n_tiles, cap_shard=cap_shard, dim=dim,
                  mesh=mesh, shard_axis=shard_axis,
                  vectors_i8c=lists["i8"] if i8_only else None,
                  cscale=lists["cs"] if i8_only else None,
                  corpus_cap=corpus_cap if i8_only else None)
        idx._host_blob = {
            "centroids": cent_np[:nlist],
            "assign_rows": act_rows.astype(np.int64),
            "assign_cluster": assign.astype(np.int32),
            "nlist": np.asarray(nlist),
        }
        idx._slot2row = s2r
        idx._n_used = n_used
        idx._n_build = int(n_used.sum())
        idx._row_cluster_np = row_cluster_np
        if i8_only:
            idx._cscale_np = cs_np
            idx._shard_rows_corpus = shard_rows_corpus
        return idx

    # -- incremental maintenance ---------------------------------------------

    @property
    def overflow_fraction(self) -> float:
        """Fraction of rows appended to the per-shard overflow regions
        since the last full build (dead holes count too); 1.0 without the
        bookkeeping (the caller rebuilds)."""
        if self._n_used is None:
            return 1.0
        used = max(1, int(self._n_used.sum()))
        return float(int(self._n_used.sum()) - self._n_build) / used

    def update(self, changed_slots, rows, active_flags) -> bool:
        """Apply a small mutation set in place; False = the caller must
        rebuild (nothing was changed then).

        Deleted / updated slots deactivate their old postings row; new
        and updated rows append to a shard's overflow region (cluster
        nlist, probed by every query on that shard). Classic layout: any
        shard takes them, the emptiest first. int8-only layout: the
        owning corpus shard takes each row, requantized against that
        shard's frozen build-time column scales; False when an owner's
        overflow is full, a slot lies past the corpus capacity of the
        build, or the rows clip more than PICOVDB_IVF_I8_CLIP_MAX of
        their components. The classic layout's int8 mirror requantizes
        the same way and re-derives itself on a guard trip."""
        if self._n_used is None:
            return False
        i8_only = self.vectors is None
        changed_slots = np.asarray(changed_slots, dtype=np.int64)
        active_flags = np.asarray(active_flags, dtype=bool)
        n_new = int(active_flags.sum())
        nshards = self.nshards
        free = self.cap_shard - self._n_used
        new_slots = changed_slots[active_flags]

        # placement, checked before anything changes
        new_rows = np.empty(n_new, dtype=np.int64)
        new_shard = np.empty(n_new, dtype=np.int64)
        take = np.zeros(nshards, dtype=np.int64)
        q8_new = None
        if i8_only:
            if n_new:
                new_shard[:] = new_slots // self._shard_rows_corpus
                if (new_shard >= nshards).any():
                    return False
                counts = np.bincount(new_shard, minlength=nshards)
                if (counts > free).any():
                    return False
                q8_new, clipped = _i8_requantize(
                    np.asarray(rows[active_flags], dtype=np.float32),
                    self._cscale_np[new_shard])
                self.last_update_clip_fraction = clipped
                if clipped > _i8_clip_max():
                    return False
                fill = self._n_used.copy()
                for j in range(n_new):
                    s = int(new_shard[j])
                    new_rows[j] = s * self.cap_shard + int(fill[s])
                    fill[s] += 1
                take = counts.astype(np.int64)
        elif n_new:
            if n_new > int(free.sum()):
                return False
            remaining = n_new
            while remaining:
                s = np.argsort(-(free - take), kind="stable")[0]
                grab = min(remaining, int(free[s] - take[s]))
                take[s] += grab
                remaining -= grab
            pos = 0
            for s in range(nshards):
                if not take[s]:
                    continue
                start = s * self.cap_shard + int(self._n_used[s])
                cnt = int(take[s])
                new_rows[pos:pos + cnt] = np.arange(start, start + cnt)
                new_shard[pos:pos + cnt] = s
                pos += cnt
        self._n_used += take

        max_slot = int(changed_slots.max()) if changed_slots.size else 0
        if max_slot >= self._slot2row.shape[0]:
            grown = np.full(max_slot + 1, -1, dtype=np.int64)
            grown[: self._slot2row.shape[0]] = self._slot2row
            self._slot2row = grown
        old_rows = self._slot2row[changed_slots]
        old_rows = old_rows[old_rows >= 0]
        self._slot2row[changed_slots] = -1
        self._slot2row[new_slots] = new_rows
        self._blob_stale = True

        for s in np.unique(old_rows // self.cap_shard).tolist():
            if self.devices[s] is None:
                continue
            local = old_rows[old_rows // self.cap_shard == s] % self.cap_shard
            self.active[s].index_fill_(0, _up(local, self.devices[s]), False)
        if not n_new:
            return True
        new_f = np.asarray(rows[active_flags], dtype=Float)
        slot_vals = (new_slots - new_shard * self._shard_rows_corpus
                     if i8_only else new_slots)
        self._row_cluster_np[new_rows] = self.nlist
        mirror_q8 = None
        if (not i8_only and self.vectors_i8c is not None
                and self._cscale_np is not None):
            q8, clipped = _i8_requantize(new_f, self._cscale_np[new_shard])
            self.last_update_clip_fraction = clipped
            mirror_q8 = None if clipped > _i8_clip_max() else q8
        for s in np.unique(new_shard).tolist():
            dev = self.devices[s]
            if dev is None:
                continue
            sel = np.nonzero(new_shard == s)[0]
            local = _up(new_rows[sel] % self.cap_shard, dev)
            if i8_only:
                self.vectors_i8c[s].index_copy_(0, local, _up(q8_new[sel], dev))
            else:
                self.vectors[s].index_copy_(
                    0, local, _up(new_f[sel], dev, self.vectors[s].dtype))
                if mirror_q8 is not None:
                    self.vectors_i8c[s].index_copy_(0, local,
                                                    _up(mirror_q8[sel], dev))
            self.slots[s].index_copy_(0, local, _up(slot_vals[sel], dev))
            self.active[s].index_fill_(0, local, True)
            tiles = np.unique(new_rows[sel] % self.cap_shard // IVF_BN)
            self.cluster2tile[s][self.nlist].index_fill_(0, _up(tiles, dev),
                                                         1.0)
        if (not i8_only and self.vectors_i8c is not None
                and mirror_q8 is None):
            self._derive_mirror()  # drifted appends: fresh scales
        return True

    # -- persistence -----------------------------------------------------------

    def to_blob(self) -> Optional[dict]:
        """The single-device sidecar schema; after in-place updates the
        row / cluster lists refresh from the live bookkeeping."""
        if self._host_blob is not None and self._blob_stale:
            live_slots = np.nonzero(self._slot2row >= 0)[0].astype(np.int64)
            self._host_blob = {
                "centroids": self._host_blob["centroids"],
                "assign_rows": live_slots,
                "assign_cluster": self._row_cluster_np[
                    self._slot2row[live_slots]].astype(np.int32),
                "nlist": np.asarray(self.nlist),
            }
            self._blob_stale = False
        return self._host_blob

    @classmethod
    def from_blob(cls, blob: dict, host_vectors: np.ndarray,
                  active_mask: np.ndarray, dim: int, mesh=None,
                  shard_axis: str = "shard",
                  storage_dtype: Optional[str] = None, i8_only: bool = False,
                  corpus_cap: Optional[int] = None) -> Optional["ShardedIVF"]:
        """Lay out from a sidecar without retraining k-means (warm
        centroids, zero iterations); None when it no longer matches the
        active rows or the dim (the caller retrains)."""
        try:
            cent = np.asarray(blob["centroids"], dtype=Float)
            if cent.ndim != 2 or cent.shape[1] != dim:
                return None
            act_rows = np.nonzero(active_mask[:host_vectors.shape[0]])[0]
            saved = np.asarray(blob["assign_rows"])
            if act_rows.shape != saved.shape or not np.array_equal(
                    act_rows, saved):
                return None
            nlist = int(blob["nlist"])
        except (KeyError, TypeError, ValueError):
            return None
        return cls.build(host_vectors, active_mask, mesh,
                         shard_axis=shard_axis, nlist=nlist, dim=dim,
                         warm_centroids=cent, iters=0,
                         storage_dtype=storage_dtype, i8_only=i8_only,
                         corpus_cap=corpus_cap)

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, ef: int, dev,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Probed sharded top-k; host (vals, GLOBAL slot ids) of (Q, k).
        Served by the exact sharded scan of `dev` instead when every
        probed cluster was empty, or when an int8-only layout no longer
        matches the corpus capacity."""
        num_q = queries.shape[0]
        if self.vectors is None and dev.cap != self.corpus_cap:
            return dev.query(queries[:num_q], k, None)
        vals, slot_ids, num_q = self.search_async(queries, k, ef, dev, nprobe)
        vals_np = vals.cpu().numpy()[:num_q, :k]
        slots_np = slot_ids.cpu().numpy()[:num_q, :k]
        if not np.isfinite(vals_np).any():
            return dev.query(queries[:num_q], k, None)
        return vals_np, slots_np

    def g_tiles(self, num_q: int, nprobe: int) -> int:
        """The per-shard hot-tile grid bound: picovdb_tpu's birthday bound
        over the batch padded to max(8, next_pow2(Q)), in 64-tile
        buckets (see ops/ivf.py::IVFIndex.search_async)."""
        q_pad = max(8, next_pow2(num_q))
        p_cluster = min(1.0, nprobe / self.nlist)
        uniq = self.nlist * (1.0 - (1.0 - p_cluster) ** q_pad) + 1
        span = self.n_tiles / self.nlist + 1.0
        e_hot = self.n_tiles * (1.0 - math.exp(-uniq * span / self.n_tiles))
        return min(self.n_tiles, round_up(int(1.35 * e_hot) + 16, 64))

    def search_async(self, queries, k: int, ef: int, dev,
                     nprobe: Optional[int] = None):
        """Dispatch without waiting: (vals (Q, k), global slots (Q, k),
        num_q) as tensors on the mesh's first device."""
        if nprobe is None:
            nprobe = ef_to_nprobe(ef, self.nlist)
        nprobe = int(max(1, min(self.nlist, nprobe)))
        num_q = queries.shape[0]
        g_tiles = self.g_tiles(num_q, nprobe)
        if isinstance(queries, np.ndarray):
            queries = torch.from_numpy(np.ascontiguousarray(queries))
        q = normalize_on_device(queries.to(self.mesh.first,
                                           dtype=torch.float32))
        i8_only = self.vectors is None
        k_sel = k + _ivf_guard(i8_only or self.vectors_i8c is not None,
                               self.dim)
        if i8_only:
            if dev is None or dev.vectors is None:
                raise RuntimeError(
                    "int8-only IVF needs the engine's device corpus for the "
                    "exact rescore")
            corpus_scale = dev.vstore_scale
            packed_i4 = dev.storage_dtype == "int4"
        vals, slots = [], []
        # every copy before any shard's scan (see sharded_query.stage)
        staged = [(s, q.to(self.devices[s], non_blocking=True))
                  for s in self.mesh.local_shards]
        for s, qs in staged:
            extra = dict(
                k=k, k_sel=k_sel, nprobe=nprobe, nlist=self.nlist,
                g_tiles=g_tiles,
                vectors_i8=None if self.vectors_i8c is None
                else self.vectors_i8c[s],
                cscale=None if self.cscale is None else self.cscale[s])
            if i8_only:
                v, local = probe_scan_local(
                    qs, self.centroids[s], dev.vectors[s], self.slots[s],
                    self.seg_starts[s], self.active[s], self.cluster2tile[s],
                    rescore_by_slot=True,
                    rescore_scale=(None if corpus_scale is None
                                   else corpus_scale[s]),
                    rescore_packed_i4=packed_i4, **extra)
                base = s * dev.vectors[s].shape[0]
                sl = torch.where(local >= 0, local + base, -1)
            else:
                v, sl = probe_scan_local(
                    qs, self.centroids[s], self.vectors[s], self.slots[s],
                    self.seg_starts[s], self.active[s], self.cluster2tile[s],
                    **extra)
            vals.append(v)
            slots.append(sl)
        top_v, top_s = merge_topk(vals, slots, k, self.mesh.first)
        if self.mesh.multiprocess:
            top_v, top_s = merge_ranks(self.mesh, top_v, top_s, k)
        return top_v, top_s, num_q
