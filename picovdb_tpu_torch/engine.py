"""PicoVectorDB — the public engine, on PyTorch.

Counterpart of picovdb_tpu/engine.py for the exact scan over a
single-device float32 store: the same API, record keys, md5 content IDs,
insert/update report, ValueError texts, DeprecationWarnings, PICOVDB_*
knobs and on-disk format (a store saved by either package loads in the
other).

Host state (ids, docs, id -> slot map, free slots) is authoritative and
guarded by a reader-writer lock; the corpus is mirrored on the device
(`device.DeviceIndex`) and queried through routed masked top-k kernels.
Mutations mark the mirror dirty; the next query synchronizes it lazily —
scatter for small change sets, full re-upload past
`faiss_incremental_threshold_ratio`.

Not in this slice, and raising NotImplementedError with the ROADMAP item
that brings them: `mesh=` and multi-process loads, `index="ivf"`, storage
dtypes other than float32 (and the quantized checkpoint format),
`ingest_device`, `scan_mode="approx"`, the opt-in int8 tiers, and the
`query_wire="int8_rescore"` lane. `index="auto"` serves the exact scan
until the IVF tier is ported.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import warnings
from typing import Any, Callable, Literal, Optional, Union

import numpy as np
import torch

from . import persistence
from .constants import (
    ADAPTIVE_BUFFER,
    ENV_ADAPTIVE_BUFFER,
    ENV_COMPUTE_DTYPE,
    ENV_QUERY_WIRE,
    ENV_RESCORE,
    ENV_USE_PALLAS,
    ENV_WRITER_PRIORITY,
    K_ID,
    K_METRICS,
    K_VECTOR,
    QUERY_WIRE,
    QUERY_WIRE_MIN_Q,
    Float,
)
from .device import DeviceIndex, _not_in_slice
from .filters import TagIndex, compile_where_mask
from .locking import RWLock
from .utils import hash_vec, normalize_batch, timed, to_c_f32

logger = logging.getLogger("picovdb_tpu_torch")

WhereArg = Optional[Union[dict, Callable[[dict], bool]]]


class PicoVectorDB:
    """Cosine-only vector DB with metadata persistence, on PyTorch.

    Saves a quick-load ids file and a full metadata file
    (`<base>.ids.json` + `<base>.meta.json`) beside the float32 matrix
    (`<base>.vecs.npy`), and keeps the matrix device-resident for the
    routed exact scan.
    """

    def __init__(
        self,
        embedding_dim: int = 1024,
        metric: Literal["cosine"] = "cosine",
        storage_file: str = "picovdb",
        use_memmap: bool = False,
        capacity: Optional[int] = None,
        no_faiss: bool = False,
        faiss_threads: Optional[int] = None,
        hnsw_m: Optional[int] = None,
        hnsw_ef_construction: Optional[int] = None,
        ef_search_default: Optional[int] = None,
        hnsw_ef_search_default: Optional[int] = None,
        faiss_incremental_threshold_ratio: float = 0.2,
        adaptive_buffer: Optional[int] = None,
        argsort_threshold: Optional[float] = None,
        device=None,
        mesh=None,
        shard_axis: str = "shard",
        compute_dtype: Optional[str] = None,
        storage_dtype: Optional[str] = None,
        use_pallas: Optional[bool] = None,
        scan_mode: Literal["auto", "mixed", "fused", "approx", "xla"] = "auto",
        mixed_precision: Optional[bool] = None,
        int8_tier: Optional[bool] = None,
        index: Literal["auto", "exact", "ivf"] = "auto",
        ivf_nlist: Optional[int] = None,
        ivf_nprobe: Optional[int] = None,
        writer_priority: Optional[bool] = None,
        rescore: Optional[Literal["auto", "host", "device"]] = None,
        query_wire: Optional[
            Literal["auto", "float32", "float16", "bfloat16"]
        ] = None,
    ) -> None:
        if index == "ivf" and not no_faiss:
            raise _not_in_slice('index="ivf"', "item 7, IVF tier")
        if writer_priority is None:
            wp_env = os.getenv(ENV_WRITER_PRIORITY)
            writer_priority = wp_env not in (None, "0", "false", "False", "")
        self._rwlock = RWLock(writer_priority=bool(writer_priority))
        self.dim = int(embedding_dim)
        self.metric = metric
        self._path = storage_file
        self._use_memmap = bool(use_memmap)
        self._capacity = capacity

        # host-authoritative parallel state ----------------------------------
        self._host_vectors: np.ndarray = np.empty((0, self.dim), dtype=Float)
        self._ids: list[Optional[str]] = []
        self._docs: list[Optional[dict]] = []
        self._free: list[int] = []
        # id -> active slot map; None = not built yet (bulk lanes skip it,
        # the first point lookup builds it from `_active_indices`)
        self._id2idx_store: Optional[dict[str, int]] = {}
        self._additional: dict[str, Any] = {}
        self._active_indices: np.ndarray = np.empty(0, dtype=np.int64)
        self._active_mask: np.ndarray = np.empty(0, dtype=bool)
        self._tag_index = TagIndex()
        self._ids_np: Optional[np.ndarray] = None  # cache for query_columnar
        # mutation counter keying the device filter-mask cache
        self._filter_epoch: int = 0
        # identity-keyed LRU for `ids=` prefilters (see picovdb_tpu)
        self._ids_mask_cache: list[dict] = []
        self._ids_mask_token_counter = itertools.count()

        # knob resolution: kwarg -> env -> constant ---------------------------
        ab_env = os.getenv(ENV_ADAPTIVE_BUFFER)
        self._adaptive_buffer: int = (
            int(adaptive_buffer)
            if adaptive_buffer is not None
            else (int(ab_env) if ab_env is not None else ADAPTIVE_BUFFER)
        )
        up_env = os.getenv(ENV_USE_PALLAS)
        if use_pallas is None and up_env is not None:
            use_pallas = up_env not in ("0", "false", "False", "")
        cd_env = os.getenv(ENV_COMPUTE_DTYPE)
        if compute_dtype is None and cd_env:
            compute_dtype = cd_env

        # ANN and argsort knobs of the reference are accepted for API
        # parity and have no effect until the IVF tier is ported
        _ = (faiss_threads, ivf_nlist, ivf_nprobe, hnsw_m,
             hnsw_ef_construction, ef_search_default, hnsw_ef_search_default,
             argsort_threshold)
        self._incr_threshold_ratio = float(faiss_incremental_threshold_ratio)
        # "auto" serves the exact scan until the IVF tier is ported
        self._index_kind = "exact" if no_faiss or index == "exact" else index

        if rescore is None:
            rescore = os.getenv(ENV_RESCORE) or "auto"
        if rescore not in ("auto", "host", "device"):
            raise ValueError(
                f"rescore must be 'auto', 'host' or 'device'; got {rescore!r}"
            )
        # (the host-f64 rescore serves lossy storage dtypes only, so on a
        # float32 store every valid mode behaves the same)

        if query_wire is None:
            query_wire = os.getenv(ENV_QUERY_WIRE) or QUERY_WIRE
        query_wire = {
            "f32": "float32", "off": "float32", "f16": "float16",
            "bf16": "bfloat16", "i8": "int8", "i16": "int16",
            "i8r": "int8_rescore",
        }.get(query_wire, query_wire)
        if query_wire not in (
            "auto", "float32", "int16", "float16", "bfloat16", "int8",
            "int8_rescore",
        ):
            raise ValueError(
                "query_wire must be 'auto', 'float32', 'int16', "
                "'float16', 'bfloat16', 'int8' or 'int8_rescore'; "
                f"got {query_wire!r}"
            )
        if query_wire == "int8_rescore":
            raise _not_in_slice('query_wire="int8_rescore"',
                                "item 6, storage tiers and serving extras")
        self._query_wire: str = query_wire

        self._dev = DeviceIndex(
            self.dim,
            device=device,
            mesh=mesh,
            shard_axis=shard_axis,
            compute_dtype=compute_dtype,
            use_pallas=use_pallas,
            storage_dtype=storage_dtype,
            scan_mode=scan_mode,
            mixed_precision=mixed_precision,
            int8_tier=int8_tier,
        )

        self._dirty: bool = False
        self._pending_add: set[int] = set()
        self._pending_remove: set[int] = set()
        self._pending_full: bool = False  # force a full mirror re-upload

        self._last_topk_strategy: Optional[str] = None
        self._last_k_eff: Optional[int] = None
        # exact re-serves triggered by segmax underfill or the crowding mark
        self._exact_retries: int = 0
        self._last_sync_mode: Optional[str] = None

        self._load_or_init()

    # ------------------------------------------------------------------
    # id -> slot map (lazy)
    # ------------------------------------------------------------------

    @property
    def _id2idx(self) -> dict[str, int]:
        m = self._id2idx_store
        if m is None:
            ids = self._ids
            m = {ids[i]: i for i in self._active_indices.tolist()}
            self._id2idx_store = m
        return m

    @_id2idx.setter
    def _id2idx(self, value: Optional[dict[str, int]]) -> None:
        self._id2idx_store = value

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    @timed("load")
    def _load_or_init(self) -> None:
        if not persistence.exists(self._path):
            self._init_fresh()
            return
        if persistence.has_quantized(self._path):
            raise _not_in_slice("loading a quantized checkpoint",
                                "item 6, storage tiers")
        logger.info("Loading existing DB …")
        self._ids = persistence.load_ids(self._path)
        count = len(self._ids)
        self._host_vectors = persistence.load_vectors(
            self._path, count, self.dim, self._use_memmap
        )
        if self._host_vectors.ndim != 2 or self._host_vectors.shape[1] != self.dim:
            raise ValueError(
                f"stored vectors have shape {self._host_vectors.shape}; "
                f"expected (*, {self.dim}) — wrong embedding_dim for this "
                f"store?"
            )
        self._docs, self._additional = persistence.load_meta(self._path, count)
        if len(self._docs) < count:
            self._docs = list(self._docs) + [None] * (count - len(self._docs))
        actives: list[int] = []
        for i, (_id, doc) in enumerate(zip(self._ids, self._docs)):
            if doc is None:
                self._free.append(i)
            elif _id is not None:
                actives.append(i)
        self._id2idx = None  # built on first point lookup
        self._active_mask = np.zeros(count, dtype=bool)
        self._active_indices = np.asarray(actives, dtype=np.int64)
        self._active_mask[self._active_indices] = True
        self._tag_index.resize(count)
        if self._active_indices.size:
            self._dev.full_upload(self._host_vectors, self._active_mask)
            self._last_sync_mode = "full"
        self._dirty = False
        logger.info("Loaded %d active / %d total vectors",
                    int(self._active_indices.size), count)

    def _init_fresh(self) -> None:
        if self._capacity is not None:
            cap = int(self._capacity)
            if self._use_memmap:
                self._host_vectors = persistence.create_memmap(
                    self._path, cap, self.dim)
            else:
                self._host_vectors = np.zeros((cap, self.dim), dtype=Float)
            self._ids = [None] * cap
            self._docs = [None] * cap
            self._free = list(range(cap))
            self._active_mask = np.zeros(cap, dtype=bool)
            self._tag_index.resize(cap)
        logger.info("No persisted data – fresh DB")
        self._dirty = False

    def size(self) -> int:
        """Deprecated: returns total slots (including deleted placeholders)."""
        warnings.warn(
            "size() is deprecated: use count() for active items; "
            "capacity() returns total slots.",
            DeprecationWarning,
            stacklevel=2,
        )
        with self._rwlock.read_lock():
            return len(self._ids)

    def capacity(self) -> int:
        """Total slots including deleted placeholders (`count()` for active)."""
        with self._rwlock.read_lock():
            return len(self._ids)

    def count(self) -> int:
        """Number of active (non-deleted) items."""
        with self._rwlock.read_lock():
            return int(self._active_indices.size)

    def __len__(self) -> int:
        with self._rwlock.read_lock():
            return int(self._active_indices.size)

    @timed("save")
    def save(self, shards: Optional[int] = None,
             quantized: Optional[bool] = None) -> None:
        """Persist atomically (tmp files + os.replace), overwriting existing.

        `shards=N` writes the matrix as N row-contiguous files; the default
        is the reference's single-file format. Loading auto-detects either.
        `quantized=True` needs a quantized storage dtype, which this port
        does not have yet.
        """
        if quantized:
            raise _not_in_slice("save(quantized=True)", "item 6, storage tiers")
        with self._rwlock.write_lock():
            if self._dirty:
                self._sync_device_locked()
            if (shards is not None and shards > 1
                    and isinstance(self._host_vectors, np.memmap)):
                # a sharded save replaces the single-file matrix; memmap
                # mode ends for this instance (documented deviation)
                logger.warning(
                    "Sharded save converts a memmapped store to an in-memory "
                    "array; memmap mode ends for this instance."
                )
                self._host_vectors = np.array(self._host_vectors)
                self._use_memmap = False
            persistence.save_atomic(
                self._path, self._ids, self._docs, self._additional,
                self._host_vectors, self.dim, n_shards=shards,
            )

    def flush(self) -> None:
        """If using memmap, flush changes to disk. No-op otherwise."""
        with self._rwlock.read_lock():
            if self._use_memmap and isinstance(self._host_vectors, np.memmap):
                self._host_vectors.flush()

    # ------------------------------------------------------------------
    # Mutators
    # ------------------------------------------------------------------

    def upsert(self, items: list[dict[str, Any]]) -> dict[str, list[str]]:
        """Insert or update items; returns {"update": [...], "insert": [...]}.

        Each item carries `_vector_` (1-D, length dim) plus arbitrary
        metadata; `_id_` defaults to the md5 of the normalized vector bytes.
        """
        with self._rwlock.write_lock():
            report: dict[str, list[str]] = {"update": [], "insert": []}
            if not items:
                return report
            buf = np.empty((len(items), self.dim), dtype=Float)
            for j, item in enumerate(items):
                vec_raw = np.asarray(item[K_VECTOR], dtype=Float)
                if vec_raw.ndim != 1:
                    raise ValueError(
                        f"upsert vector must be 1D with length {self.dim}; "
                        f"got shape {tuple(vec_raw.shape)}"
                    )
                if vec_raw.shape[0] != self.dim:
                    raise ValueError(
                        f"upsert vector dim mismatch: expected {self.dim}, "
                        f"got {vec_raw.shape[0]}"
                    )
                buf[j] = vec_raw
            norm = normalize_batch(buf)
            item_ids: list[str] = []
            metas: list[dict] = []
            for j, item in enumerate(items):
                meta = {k: v for k, v in item.items() if k != K_VECTOR}
                iid = meta.get(K_ID)
                iid = iid if iid is not None else hash_vec(norm[j])
                meta[K_ID] = iid
                item_ids.append(iid)
                metas.append(meta)
            return self._upsert_rows(norm, item_ids, metas)

    def upsert_columnar(
        self,
        vectors: np.ndarray,
        ids: Optional[list[str]] = None,
        metadata: Optional[list[Optional[dict]]] = None,
        copy: bool = True,
    ) -> dict[str, list[str]]:
        """Bulk upsert from one (n, dim) matrix + optional parallel `ids` /
        `metadata` lists; the semantics of `upsert` without per-item dicts.

        `copy=False` normalizes the caller's matrix in place when it is
        already C-contiguous float32, and a fresh store adopts it as the
        backing array. The caller must not mutate the matrix afterwards.
        """
        mat = np.asarray(vectors)
        if mat.ndim != 2 or mat.shape[1] != self.dim:
            raise ValueError(
                f"upsert_columnar expects a 2D array with last dim "
                f"{self.dim}; got shape {tuple(mat.shape)}"
            )
        n = mat.shape[0]
        if ids is not None and len(ids) != n:
            raise ValueError(f"ids length {len(ids)} != number of vectors {n}")
        if metadata is not None and len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != number of vectors {n}"
            )
        if n == 0:
            return {"update": [], "insert": []}
        if copy:
            mat = np.array(mat, dtype=Float, order="C")
        norm = normalize_batch(mat, inplace=True)
        if ids is None:
            from .utils import hash_rows

            ids = hash_rows(norm)

        with self._rwlock.write_lock():
            report: dict[str, list[str]] = {"update": [], "insert": []}
            # fresh-store fast lane: adopt the columns wholesale
            if (
                not self._ids
                and not self._free
                and self._capacity is None
                and len(set(ids)) == n
            ):
                self._host_vectors = norm
                self._ids = list(ids)
                if metadata is None:
                    self._docs = [{K_ID: _id} for _id in ids]
                else:
                    self._docs = [
                        {**(m or {}), K_ID: _id}
                        for m, _id in zip(metadata, ids)
                    ]
                self._id2idx = None
                self._active_indices = np.arange(n, dtype=np.int64)
                self._active_mask = np.ones(n, dtype=bool)
                self._tag_index.resize(n)
                report["insert"] = list(ids)
                self._ids_np = None
                self._pending_full = True
                self._filter_epoch += 1
                self._dirty = True
                return report
            if metadata is None:
                metas = [{K_ID: i} for i in ids]
            else:
                metas = [{**(m or {}), K_ID: i} for m, i in zip(metadata, ids)]
            return self._upsert_rows(norm, list(ids), metas)

    def _upsert_rows(
        self, norm: np.ndarray, item_ids: list[str], metas: list[dict]
    ) -> dict[str, list[str]]:
        """The insert/update state machine shared by `upsert` and
        `upsert_columnar` (caller holds the write lock, rows normalized):
        update in place for known ids, free-slot reuse, bulk append
        otherwise; in-batch duplicates redirect the pending row (last
        wins). Capacity is checked before any mutation."""
        report: dict[str, list[str]] = {"update": [], "insert": []}
        n = len(item_ids)
        id2idx = self._id2idx
        if self._capacity is not None:
            fresh = {i for i in item_ids if i not in id2idx}
            if len(fresh) > len(self._free):
                raise ValueError("Database capacity exceeded")
        new_rows: list[int] = []
        new_ids: list[str] = []
        new_docs: list[dict] = []
        new_active: list[int] = []
        touched_idx: list[int] = []
        touched_docs: list[dict] = []
        pending_pos: dict[str, int] = {}
        n_slots = len(self._ids)
        for j in range(n):
            item_id = item_ids[j]
            meta = metas[j]
            idx = id2idx.get(item_id)
            if idx is not None:
                if idx >= n_slots:
                    pos = pending_pos[item_id]
                    new_rows[pos] = j
                    new_docs[pos] = meta
                else:
                    self._host_vectors[idx] = norm[j]
                    self._docs[idx] = meta
                    self._pending_add.add(idx)
                    touched_idx.append(idx)
                    touched_docs.append(meta)
                report["update"].append(item_id)
            else:
                if self._free:
                    idx = self._free.pop()
                    self._host_vectors[idx] = norm[j]
                    self._ids[idx] = item_id
                    self._docs[idx] = meta
                    new_active.append(idx)
                    self._pending_add.add(idx)
                    touched_idx.append(idx)
                    touched_docs.append(meta)
                else:
                    pending_pos[item_id] = len(new_rows)
                    new_rows.append(j)
                    new_ids.append(item_id)
                    new_docs.append(meta)
                    idx = n_slots + len(new_ids) - 1
                    new_active.append(idx)
                id2idx[item_id] = idx
                report["insert"].append(item_id)
        if new_rows:
            stacked = norm[new_rows] if len(new_rows) != n else norm
            if not n_slots:
                self._host_vectors = to_c_f32(stacked)
            else:
                if self._use_memmap and isinstance(self._host_vectors, np.memmap):
                    logger.warning(
                        "Appending to a memmapped file converts it to an "
                        "in-memory numpy array, doubling memory usage. For "
                        "large datasets, consider pre-allocating capacity "
                        "or using a different growth strategy."
                    )
                self._host_vectors = to_c_f32(
                    np.vstack([self._host_vectors, stacked])
                )
            start = n_slots
            self._ids.extend(new_ids)
            self._docs.extend(new_docs)
            self._active_mask = np.concatenate(
                [self._active_mask, np.zeros(len(new_ids), dtype=bool)]
            )
            self._tag_index.resize(len(self._ids))
            touched_idx.extend(range(start, len(self._ids)))
            touched_docs.extend(new_docs)
            self._pending_add.update(range(start, len(self._ids)))
        if new_active:
            na = np.asarray(new_active, dtype=np.int64)
            self._active_indices = (
                np.append(self._active_indices, na)
                if self._active_indices.size else na
            )
            self._active_mask[na] = True
        if touched_idx:
            self._tag_index.update_rows(touched_idx, touched_docs)
        self._ids_np = None
        self._filter_epoch += 1
        self._dirty = True
        return report

    def ingest_device(self, *args, **kwargs):
        """Device-born bulk load: not in this slice."""
        raise _not_in_slice("ingest_device", "item 6, storage tiers and "
                            "serving extras")

    def delete(self, ids: list[str]) -> list[str]:
        """Soft-delete vectors by ID; returns the IDs actually deleted."""
        with self._rwlock.write_lock():
            removed: list[str] = []
            removed_idxs: list[int] = []
            for _id in ids:
                idx = self._id2idx.pop(_id, None)
                if idx is not None:
                    self._docs[idx] = None
                    self._host_vectors[idx].fill(0)
                    self._free.append(idx)
                    removed_idxs.append(idx)
                    removed.append(_id)
            if removed_idxs:
                to_remove = np.asarray(removed_idxs, dtype=np.int64)
                if self._active_indices.size:
                    keep = ~np.isin(self._active_indices, to_remove)
                    self._active_indices = self._active_indices[keep]
                self._active_mask[to_remove] = False
                self._tag_index.clear_rows(removed_idxs)
                for idx in removed_idxs:
                    self._pending_remove.add(idx)
                    self._pending_add.discard(idx)
                self._filter_epoch += 1
                self._dirty = True
            return removed

    def store_additional_data(self, **kwargs) -> None:
        """Store non-searchable auxiliary data persisted in the meta file."""
        with self._rwlock.write_lock():
            self._additional.update(kwargs)

    def get_additional_data(self) -> dict[str, Any]:
        """Auxiliary data previously stored via `store_additional_data`."""
        with self._rwlock.read_lock():
            return self._additional

    def vacuum(self) -> None:
        """Compact the store: drop deleted slots, rebuild maps and the mirror.

        Fixed-capacity stores compact in place: actives move to the front
        of the pre-allocated buffer and the tail returns to the free list.
        """
        with self._rwlock.write_lock():
            if not self._free:
                return
            # compaction remaps slots: every cached filter mask misses
            self._filter_epoch += 1
            active = np.sort(self._active_indices).tolist()
            n = len(active)
            if self._capacity is not None:
                cap = len(self._ids)
                hv = self._host_vectors
                hv[:n] = np.asarray(hv)[active]  # fancy index copies first
                hv[n:cap] = 0
                self._ids = [self._ids[i] for i in active] + [None] * (cap - n)
                self._docs = [self._docs[i] for i in active] + [None] * (cap - n)
                self._active_mask = np.zeros(cap, dtype=bool)
                self._active_mask[:n] = True
                self._free = list(range(n, cap))
                self._tag_index.reset()
                self._tag_index.resize(cap)
            else:
                self._host_vectors = to_c_f32(
                    np.asarray(self._host_vectors)[active])
                self._ids = [self._ids[i] for i in active]
                self._docs = [self._docs[i] for i in active]
                self._active_mask = np.ones(n, dtype=bool)
                self._free = []
                self._tag_index.reset()
                self._tag_index.resize(n)
            self._id2idx = None
            self._ids_np = None
            self._active_indices = np.arange(n, dtype=np.int64)
            self._pending_add.clear()
            self._pending_remove.clear()
            if n:
                self._pending_full = False
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
                self._dirty = False
            else:
                # zero actives: the device mask may still mark old rows
                # active; the next query's sync re-uploads the cleared mask
                self._pending_full = self._dev.vectors is not None
                self._dirty = self._pending_full

    def rebuild_index(self) -> None:
        """Force a full device mirror refresh immediately."""
        with self._rwlock.write_lock():
            if len(self._ids):
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
            self._pending_add.clear()
            self._pending_remove.clear()
            self._pending_full = False
            self._dirty = False

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    @timed("query")
    def query(
        self,
        query_vecs: np.ndarray,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> Union[list[list[dict[str, Any]]], list[dict[str, Any]]]:
        """Cosine top-k query (single vector or batch).

        Filters compile to a boolean slot mask applied inside the scan.
        `ef_search` / `hnsw_ef_search` are accepted for API parity; the
        exact scan ignores them.
        """
        raw = np.ascontiguousarray(query_vecs, dtype=Float)
        if raw.ndim == 1:
            if raw.shape[0] != self.dim:
                raise ValueError(
                    f"query vector dim mismatch: expected {self.dim}, "
                    f"got {raw.shape[0]}"
                )
            is_single = True
            vecs = raw[None, :]
        elif raw.ndim == 2:
            if raw.shape[1] != self.dim:
                raise ValueError(
                    f"query vectors dim mismatch: expected last dim {self.dim}, "
                    f"got {raw.shape[1]}"
                )
            is_single = False
            vecs = raw
        else:
            raise ValueError(
                f"query expects 1D or 2D array with last dim {self.dim}; "
                f"got shape {tuple(raw.shape)}"
            )
        num_q = vecs.shape[0]
        with self._synced_read():
            if not self._active_indices.size:
                return [[] for _ in range(num_q)]
            filter_mask: Optional[np.ndarray] = None
            if ids is not None or where is not None:
                filter_mask = self._build_filter_mask(where, ids)
                n_cand = int(filter_mask.sum())
                if n_cand == 0:
                    return [[] for _ in range(num_q)]
            else:
                n_cand = int(self._active_indices.size)
            # a callable `where` is re-applied in assembly, so over-fetch
            base = top_k + self._adaptive_buffer if callable(where) else top_k
            k_eff = min(base, n_cand)
            self._last_k_eff = int(k_eff)
            vals, idxs = self._dispatch_query(
                vecs, k_eff, filter_mask, mask_key=self._mask_key(where, ids))
            if num_q * k_eff <= 4096:
                # small result sets assemble inside the read lock against
                # the live docs list (no O(corpus) snapshot per call)
                results = self._assemble(vals, idxs, self._docs, top_k,
                                         better_than, where)
                return results[0] if is_single else results
            docs_ref = list(self._docs)
        results = self._assemble(vals, idxs, docs_ref, top_k, better_than, where)
        return results[0] if is_single else results

    def _assemble(
        self, vals, idxs, docs_ref, top_k, better_than, where
    ) -> list[list[dict[str, Any]]]:
        """Materialize result dicts from (scores, slot ids); the native C++
        loop (native/hostops.cpp) serves whenever no callable `where`
        needs re-applying."""
        where_callable = callable(where)
        if not where_callable:
            from . import hostops

            ext = hostops.get()
            if ext is not None:
                return ext.assemble(
                    np.ascontiguousarray(vals, dtype=np.float32),
                    np.ascontiguousarray(idxs, dtype=np.int32),
                    docs_ref,
                    K_METRICS,
                    int(top_k),
                    float(better_than) if better_than is not None else None,
                )
        results_batch: list[list[dict[str, Any]]] = []
        n_slots = len(docs_ref)
        neg_inf = float("-inf")
        for qi in range(vals.shape[0]):
            results: list[dict[str, Any]] = []
            for idx, score in zip(idxs[qi].tolist(), vals[qi].tolist()):
                if idx < 0 or idx >= n_slots:
                    continue
                if score == neg_inf or score != score:  # -inf or NaN
                    continue
                doc = docs_ref[idx]
                if doc is None:
                    continue
                if better_than is not None and score < better_than:
                    continue
                if where_callable and not where(doc):
                    continue
                results.append({**doc, K_METRICS: score})
                if len(results) == top_k:
                    break
            results_batch.append(results)
        return results_batch

    def query_one(
        self,
        query_vec: np.ndarray,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> list[dict[str, Any]]:
        """Convenience method for single-vector queries."""
        return self.query(  # type: ignore[return-value]
            query_vec, top_k=top_k, better_than=better_than, where=where,
            ids=ids, ef_search=ef_search, hnsw_ef_search=hnsw_ef_search,
        )

    def query_serial_loop(self, query_vecs: np.ndarray, top_k: int = 10):
        """M independent Q=1 queries through the small-batch route, one
        after another (see DeviceIndex.query_serial_loop). Returns ((M, k)
        exact scores, (M, k) slot indices) — slot-level, no id mapping."""
        vecs = np.ascontiguousarray(query_vecs, dtype=Float)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"query_serial_loop expects (M, {self.dim}); got "
                f"{tuple(vecs.shape)}"
            )
        with self._synced_read():
            if not self._active_indices.size:
                raise ValueError("query_serial_loop on an empty store")
            return self._dev.query_serial_loop(vecs, top_k)

    def _as_query_batch(self, query_vecs, what: str):
        """(Q, dim) host float32 array, or a torch tensor left in place (a
        CUDA tensor is the device-resident serving input)."""
        if isinstance(query_vecs, torch.Tensor):
            vecs = query_vecs
        else:
            vecs = np.ascontiguousarray(query_vecs, dtype=Float)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"{what} expects a 2D array with last dim {self.dim}; "
                f"got shape {tuple(vecs.shape)}"
            )
        return vecs

    def _serve_chunks(self, vecs, k_eff, filter_mask, mask_key, batch_size):
        """Dispatch every chunk, then fetch each one, re-serving exactly
        the chunks whose route may carry a retry mark and did (-inf).
        Caller holds the read lock for the whole call: the mirror mutates
        in place, so the retry must see the dispatch-time state."""
        num_q = vecs.shape[0]
        wvecs = self._wire_encode(vecs, num_q)
        pending = []
        for start in range(0, num_q, batch_size):
            chunk = wvecs[start:start + batch_size]
            vd, xd, nq, ke = self._dev.query_async(
                chunk, k_eff, filter_mask, mask_key=mask_key)
            # a small tail chunk may route differently: record each one's
            pending.append((chunk, vd, xd, nq, ke,
                            _needs_exact_retry(self._dev.last_strategy)))
        self._last_topk_strategy = self._dev.last_strategy
        snap = self._dev.snapshot()
        for chunk, vd, xd, nq, ke, retryable in pending:
            vals = vd.cpu().numpy()[:nq, :ke]
            idxs = xd.cpu().numpy()[:nq, :ke]
            if retryable and np.isneginf(vals).any():
                vals, idxs = self._dev.query_exact_snapshot(snap, chunk, k_eff)
                self._exact_retries += 1
            yield vals, idxs

    def query_batched(
        self,
        query_vecs,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        batch_size: int = 1024,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> list[list[dict[str, Any]]]:
        """Throughput-mode batch query: splits a (Q, dim) batch into
        device-sized chunks, dispatches them all, then assembles. Same
        result contract as `query` with a 2-D input. `query_vecs` may be a
        tensor already on the device."""
        vecs = self._as_query_batch(query_vecs, "query_batched")
        num_q = vecs.shape[0]
        out: list[list[dict[str, Any]]] = []
        with self._synced_read():
            if not self._active_indices.size:
                return [[] for _ in range(num_q)]
            filter_mask = (self._build_filter_mask(where, ids)
                           if ids is not None or where is not None else None)
            n_cand = (int(filter_mask.sum()) if filter_mask is not None
                      else int(self._active_indices.size))
            if n_cand == 0:
                return [[] for _ in range(num_q)]
            base = top_k + self._adaptive_buffer if callable(where) else top_k
            k_eff = min(base, n_cand)
            self._last_k_eff = int(k_eff)
            results = list(self._serve_chunks(
                vecs, k_eff, filter_mask, self._mask_key(where, ids),
                batch_size))
            docs_ref = list(self._docs)
        for vals, idxs in results:
            out.extend(self._assemble(vals, idxs, docs_ref, top_k,
                                      better_than, where))
        return out

    def query_columnar(
        self,
        query_vecs,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        batch_size: int = 2048,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ):
        """Serving-mode batch query returning columnar results.

        Returns `(ids, scores)`: an (Q, top_k) object array of string IDs
        (None marks missing/filtered positions) and an (Q, top_k) float32
        score matrix; no per-hit dicts. `query_vecs` may be a tensor
        already on the device."""
        vecs = self._as_query_batch(query_vecs, "query_columnar")
        num_q = vecs.shape[0]
        out_ids = np.full((num_q, top_k), None, dtype=object)
        out_scores = np.full((num_q, top_k), -np.inf, dtype=np.float32)
        with self._synced_read():
            if not self._active_indices.size:
                return out_ids, out_scores
            filter_mask = (self._build_filter_mask(where, ids)
                           if ids is not None or where is not None else None)
            n_cand = (int(filter_mask.sum()) if filter_mask is not None
                      else int(self._active_indices.size))
            if n_cand == 0:
                return out_ids, out_scores
            k_eff = min(top_k, n_cand)
            self._last_k_eff = int(k_eff)
            ids_arr = self._ids_array()
            docs_len = len(self._docs)
            row = 0
            for vals, idxs in self._serve_chunks(
                    vecs, k_eff, filter_mask, self._mask_key(where, ids),
                    batch_size):
                nq, ke = vals.shape
                valid = np.isfinite(vals) & (idxs >= 0) & (idxs < docs_len)
                if better_than is not None:
                    valid &= vals >= better_than
                mapped = ids_arr[np.where(valid, idxs, 0)]
                mapped[~valid] = None
                out_ids[row:row + nq, :ke] = mapped
                out_scores[row:row + nq, :ke] = np.where(valid, vals, -np.inf)
                row += nq
        return out_ids, out_scores

    def _ids_array(self) -> np.ndarray:
        """Cached object-dtype mirror of `_ids` for vectorized id mapping."""
        cached = self._ids_np
        if cached is None or len(cached) != len(self._ids):
            self._ids_np = np.asarray(self._ids, dtype=object)
            cached = self._ids_np
        return cached

    # ------------------------------------------------------------------
    # Getters / stats
    # ------------------------------------------------------------------

    def get(
        self, ids: Union[str, list[str]], include_vector: bool = False
    ) -> Union[Optional[dict[str, Any]], list[dict[str, Any]]]:
        """Get records by ID or IDs (missing IDs are skipped in list form)."""
        with self._rwlock.read_lock():
            if isinstance(ids, str):
                idx = self._id2idx.get(ids)
                if idx is None:
                    return None
                return self._record(idx, ids, include_vector)
            out: list[dict[str, Any]] = []
            for _id in ids:
                idx = self._id2idx.get(_id)
                if idx is not None:
                    out.append(self._record(idx, _id, include_vector))
            return out

    def _record(self, idx: int, _id: str, include_vector: bool) -> dict[str, Any]:
        rec = dict(self._docs[idx] or {K_ID: _id})
        if include_vector:
            rec[K_VECTOR] = np.array(self._host_vectors[idx], dtype=Float)
        return rec

    def get_by_id(
        self, sid: str, include_vector: bool = False
    ) -> Optional[dict[str, Any]]:
        """Deprecated: use `get(sid)` instead."""
        warnings.warn(
            "get_by_id() is deprecated: use get(id) or get([ids])",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.get(sid, include_vector=include_vector)  # type: ignore

    def get_all(
        self, include_vector: bool = False, include_deleted: bool = False
    ) -> list[dict[str, Any]]:
        """All records; deleted slots appear as `{_id_}` placeholders when
        `include_deleted=True`."""
        with self._rwlock.read_lock():
            docs: list[dict[str, Any]] = []
            if include_deleted:
                for idx, (_id, doc) in enumerate(zip(self._ids, self._docs)):
                    if doc is not None:
                        rec = dict(doc)
                        rec[K_ID] = _id
                        if include_vector:
                            rec[K_VECTOR] = np.array(self._host_vectors[idx],
                                                     dtype=Float)
                        docs.append(rec)
                    else:
                        docs.append({K_ID: _id})
            else:
                for idx in self._active_indices.tolist():
                    _id, doc = self._ids[idx], self._docs[idx]
                    if _id is None or doc is None:
                        continue
                    rec = dict(doc)
                    rec[K_ID] = _id
                    if include_vector:
                        rec[K_VECTOR] = np.array(self._host_vectors[idx],
                                                 dtype=Float)
                    docs.append(rec)
            return docs

    def last_query_debug(self) -> dict[str, Any]:
        """Introspection snapshot of the most recent query's execution."""
        with self._rwlock.read_lock():
            return {
                "strategy": self._last_topk_strategy,
                "k_eff": self._last_k_eff,
                "sync_mode": self._last_sync_mode,
                "dirty": self._dirty,
                "device_capacity": self._dev.cap,
                "scan_mode": self._dev.scan_mode,
                "storage_dtype": self._dev.storage_dtype,
                "mirrors": {
                    "bf16": self._dev.vectors_lp is not None,
                    "int8": self._dev.vectors_i8 is not None,
                },
                "index_kind": self._index_kind,
                "ann_active": False,
                "rescore": None,
            }

    def profile_trace(self, log_dir: str):
        """Context manager capturing a torch.profiler trace (CPU and, on
        the card, CUDA activity) of whatever runs inside the block, written
        to `log_dir` for TensorBoard."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._dev._device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        )

    def stats(self) -> dict[str, Any]:
        """Database statistics, including on-disk file sizes and device info."""
        with self._rwlock.read_lock():
            active = int(self._active_indices.size)
            total = len(self._ids)
            return {
                "active": active,
                "deleted": total - active,
                "total": total,
                "dim": self.dim,
                "faiss": False,  # back-compat key: no ANN tier yet
                "memmap": self._use_memmap,
                "file_sizes": persistence.file_sizes(self._path),
                "device": str(self._dev._device),
                "device_capacity": self._dev.cap,
                "index_kind": self._index_kind,
                "sharded": False,
                "last_sync_mode": self._last_sync_mode,
                "last_topk_strategy": self._last_topk_strategy,
                "exact_retries": self._exact_retries,
                "storage_dtype": self._dev.storage_dtype,
                "mirrors": {
                    "bf16": self._dev.vectors_lp is not None,
                    "int8_rows": self._dev.vectors_i8 is not None,
                },
            }

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _synced_read(self):
        """Read lock over a guaranteed-current device mirror: re-checks the
        dirty flag inside the read lock and loops back to the sync step if
        a writer slipped in between."""
        while True:
            with self._rwlock.read_lock():
                if not self._dirty:
                    yield
                    return
            with self._rwlock.write_lock():
                if self._dirty:
                    self._sync_device_locked()

    @staticmethod
    def _freeze_where(where) -> Optional[tuple]:
        """Hashable canonical form of a dict `where`, or None if uncacheable."""
        if not isinstance(where, dict):
            return None
        try:
            parts = []
            for key in sorted(where):
                val = where[key]
                if isinstance(val, dict):
                    if set(val.keys()) != {"$in"}:
                        return None
                    parts.append((key, "$in", tuple(val["$in"])))
                else:
                    parts.append((key, "=", val))
            frozen = tuple(parts)
            hash(frozen)
            return frozen
        except TypeError:
            return None

    def _wire_encode(self, vecs, num_q: int):
        """Compact upload dtype for a host query batch (the int16 wire from
        QUERY_WIRE_MIN_Q queries under "auto"); tensors pass through. The
        device widens to float32 and normalizes, so the ranking holds."""
        if not isinstance(vecs, np.ndarray) or vecs.dtype != Float:
            return vecs
        mode = self._query_wire
        if mode == "float32":
            return vecs
        if mode == "auto":
            if num_q < QUERY_WIRE_MIN_Q:
                return vecs
            mode = "int16"
        from .utils import encode_query_wire

        return encode_query_wire(vecs, mode)

    _IDS_MASK_CACHE_MAX = 4
    _IDS_MASK_CACHE_MIN_LEN = 64

    def _ids_mask_lookup(self, ids) -> Optional[dict]:
        epoch = self._filter_epoch
        for ent in self._ids_mask_cache:
            if ent["obj"] is ids and ent["epoch"] == epoch:
                return ent
        return None

    def _ids_mask_insert(self, ids, mask: np.ndarray) -> dict:
        mask.flags.writeable = False  # shared across calls: freeze it
        ent = {
            "obj": ids,
            "epoch": self._filter_epoch,
            "mask": mask,
            "token": next(self._ids_mask_token_counter),
        }
        cache = [
            e for e in self._ids_mask_cache
            if e["obj"] is not ids or e["epoch"] != ent["epoch"]
        ]
        cache.append(ent)
        self._ids_mask_cache = cache[-self._IDS_MASK_CACHE_MAX:]
        return ent

    def _mask_key(self, where: WhereArg, ids) -> Optional[tuple]:
        """Device-mask cache key for this filter, or None (don't cache)."""
        if ids is not None:
            ent = self._ids_mask_lookup(ids)
            if ent is None:
                return None
            if where is None:
                return (self._filter_epoch, "ids", ent["token"])
            frozen = self._freeze_where(where)
            if frozen is None:
                return None
            return (self._filter_epoch, "ids", ent["token"], frozen)
        if where is None:
            return None
        frozen = self._freeze_where(where)
        if frozen is None:
            return None
        return (self._filter_epoch, frozen)

    def _build_filter_mask(
        self, where: WhereArg, ids: Optional[list[str]]
    ) -> np.ndarray:
        """Compile ids/where prefilters to one boolean slot mask."""
        if ids is not None:
            ent = self._ids_mask_lookup(ids)
            if ent is not None:
                mask = ent["mask"]  # read-only; combined below without |=
            else:
                mask = np.zeros(len(self._ids), dtype=bool)
                hit = [i for i in map(self._id2idx.get, ids) if i is not None]
                if hit:
                    mask[np.asarray(hit, dtype=np.int64)] = True
                if len(ids) >= self._IDS_MASK_CACHE_MIN_LEN:
                    self._ids_mask_insert(ids, mask)
        else:
            mask = self._active_mask.copy()
        if where is not None:
            wmask = compile_where_mask(
                where, self._docs, self._active_mask, self._tag_index
            )
            mask = mask & wmask
        return mask

    def _dispatch_query(self, vecs, k_eff, filter_mask, mask_key=None):
        """Exact routed scan, with the underfill/crowding retry: a -inf in
        a result whose route may mark one (segmax truncation or a crowded
        guard band; k_eff <= candidates by construction) re-runs exact."""
        vals, idxs = self._dev.query(vecs, k_eff, filter_mask,
                                     mask_key=mask_key)
        self._last_topk_strategy = self._dev.last_strategy
        if (_needs_exact_retry(self._last_topk_strategy)
                and np.isneginf(vals).any()):
            vals, idxs = self._dev.query(
                vecs, k_eff, filter_mask, force_exact=True, mask_key=mask_key)
            self._exact_retries += 1
            self._last_topk_strategy = self._dev.last_strategy
        return vals, idxs

    @timed("sync_device")
    def _sync_device_locked(self) -> None:
        """Apply pending mutations to the device mirror (caller holds the
        write lock): scatter small change sets, re-upload past the
        `faiss_incremental_threshold_ratio` (the reference's
        incremental-vs-full rebuild rule)."""
        size = len(self._ids)
        if size == 0:
            self._dirty = False
            return
        changed = sorted(self._pending_add | self._pending_remove)
        if (not self._pending_full and changed
                and self._dev.vectors is not None and size > self._dev.cap):
            # append epoch crossed a capacity bucket: grow on device
            self._dev.grow(size)
        dev_rows = self._dev.cap
        need_full = (
            self._pending_full
            or self._dev.vectors is None
            or size > dev_rows
            or not changed  # unknown change set -> be safe
        )
        if not need_full:
            ratio = len(changed) / float(max(1, min(size, dev_rows)))
            need_full = ratio > max(0.0, self._incr_threshold_ratio)
        if need_full:
            self._dev.full_upload(
                np.asarray(self._host_vectors[:size]), self._active_mask)
            self._last_sync_mode = "full"
        else:
            idxs = np.asarray(changed, dtype=np.int64)
            rows = np.ascontiguousarray(
                np.asarray(self._host_vectors)[idxs], dtype=Float)
            self._dev.scatter(idxs, rows, self._active_mask[idxs])
            self._last_sync_mode = "incremental"
        self._pending_add.clear()
        self._pending_remove.clear()
        self._pending_full = False
        self._dirty = False


# Routes whose results may carry a -inf retry mark: segmax underfill
# (per-segment truncation) or the crowding mark. All of them serve
# unfiltered queries only, so the exact retry over (vectors, active) is the
# full candidate set. "mixed_fused_batch_filtered" is never marked and is
# not retried, hence the exact match for the unfiltered name.
_RETRY_PREFIXES = (
    "segmax", "mixed_fused_smallq", "i8_fused_smallq", "i8c_fused_smallq"
)


def _needs_exact_retry(strategy) -> bool:
    if not strategy:
        return False
    return (strategy == "mixed_fused_batch"
            or strategy.startswith(_RETRY_PREFIXES))
