"""PicoVectorDB — the public engine, on PyTorch.

Counterpart of picovdb_tpu/engine.py for the exact scan over a
single-device store: the same API, record keys, md5 content IDs,
insert/update report, ValueError texts, DeprecationWarnings, PICOVDB_*
knobs and on-disk formats (a store saved by either package, float32 or
quantized, loads in the other).

Host state (ids, docs, id -> slot map, free slots) is authoritative and
guarded by a reader-writer lock; the corpus is mirrored on the device
(`device.DeviceIndex`) in its storage dtype (float32, bfloat16, int8 or
packed int4) and queried through routed masked top-k kernels. Mutations
mark the mirror dirty; the next query synchronizes it lazily — scatter
for small change sets, full re-upload past
`faiss_incremental_threshold_ratio`.

Lossy storage dtypes re-rank on the host: the device selects a guard
band of candidates and the host scores them against the authentic
float32 rows in float64 (`_rescored_dispatch`). Device-born stores
(`ingest_device`) and quantized checkpoints keep the host matrix lazy:
mutations land in an exact-row overlay, and only paths that need the
whole matrix materialize it from the device.

The IVF tier (`ops/ivf.py`) is the ANN path: `index="ivf"` always
builds and probes it, `index="auto"` builds it at the first sync after a
bulk load once the exact sweep reads >= 2 GiB (`should_build`) and routes
unfiltered batches to it while their probed-cluster union stays small.
Its sidecar (`<base>.vecs.npy.ivf.npz`) is picovdb_tpu's format.

The opt-in selection tiers serve as in picovdb_tpu: `PICOVDB_SEGMAX_I8`
(batch segmax over the per-row int8 mirror), the column-scaled int8
mirror (`PICOVDB_INT8C_TIER`, `PICOVDB_SEGMAX_I8C`, `PICOVDB_SMALLQ_I8C`)
and `scan_mode="approx"`, whose TPU-only approximate top-k maps to the
exact top-k_sel of the dense product plus the exact rescore.

Not in this slice, and raising NotImplementedError with the ROADMAP item
that brings it: `mesh=` and multi-process loads.
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
    ENV_RESCORE_GUARD,
    ENV_RESCORE_MAX_Q,
    ENV_USE_PALLAS,
    ENV_WRITER_PRIORITY,
    HNSW_EFC,
    HNSW_EFS,
    HNSW_M,
    K_ID,
    K_METRICS,
    K_VECTOR,
    QUERY_WIRE,
    QUERY_WIRE_MIN_Q,
    RESCORE_GUARD,
    RESCORE_MAX_Q,
    Float,
)
from .device import DeviceIndex
from .filters import TagIndex, compile_where_mask
from .locking import RWLock
from .ops import ivf as ivf_ops
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
        # A device-born store (`ingest_device`) or a quantized checkpoint
        # leaves the host matrix unmaterialized: row mutations land in
        # `_host_overlay` (slot -> exact f32 row; zeros for deletions),
        # which the device sync scatters from, and paths that read the
        # whole matrix call `_ensure_host_vectors()` first.
        self._host_lazy: bool = False
        self._host_overlay: dict[int, np.ndarray] = {}
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

        # ANN knobs, resolved as picovdb_tpu resolves them: hnsw_m scales
        # the IVF partition count and hnsw_ef_construction the k-means
        # effort (_ivf_build_params), ef_search maps to nprobe. faiss_threads
        # and argsort_threshold are accepted for API parity (no host thread
        # pool, no argsort choice); so is PICOVDB_WARM_UPDATES (nothing to
        # pre-compile in eager PyTorch).
        _ = faiss_threads, argsort_threshold
        self._hnsw_m = int(hnsw_m) if hnsw_m is not None else HNSW_M
        self._hnsw_efc = (int(hnsw_ef_construction)
                          if hnsw_ef_construction is not None else HNSW_EFC)
        if hnsw_ef_search_default is not None:
            self._ef_search = int(hnsw_ef_search_default)
        elif ef_search_default is not None:
            self._ef_search = int(ef_search_default)
        else:
            self._ef_search = HNSW_EFS
        self._incr_threshold_ratio = float(faiss_incremental_threshold_ratio)
        self._index_kind = "exact" if no_faiss or index == "exact" else index
        self._ivf_nlist = ivf_nlist
        self._ivf_nprobe = ivf_nprobe
        self._ivf = None  # the IVF tier (ops/ivf.IVFIndex), built lazily
        # construction point of the last build (last_query_debug)
        self._ann_build_params: Optional[dict] = None
        # warm centroids of an IVF freed to let a device grow succeed
        self._ivf_warm_blob: Optional[dict] = None
        # "incremental" | "full" | None: how the last sync kept the tier
        self._last_ann_rebuild_mode: Optional[str] = None

        if rescore is None:
            rescore = os.getenv(ENV_RESCORE) or "auto"
        if rescore not in ("auto", "host", "device"):
            raise ValueError(
                f"rescore must be 'auto', 'host' or 'device'; got {rescore!r}"
            )
        # host-f64 rescore of lossy storage dtypes (`_rescored_dispatch`)
        self._rescore_mode: str = rescore

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
        self._query_wire: str = query_wire
        # int8_rescore: candidates selected past top_k on the 1 B wire,
        # then re-ranked exactly on the host f32 rows (query_batched)
        try:
            self._wire_guard: int = int(
                os.getenv("PICOVDB_WIRE_RESCORE_GUARD", "22"))
        except ValueError:
            self._wire_guard = 22
        rg_env = os.getenv(ENV_RESCORE_GUARD)
        if rg_env:
            self._rescore_guard: int = int(rg_env)
        elif storage_dtype == "int4":
            # int4's ~18x int8 quantization step packs ~4x the near-ties
            # into the band; the JAX package measured the default guard
            # saturating most int4 dispatches, so int4 selects 4x wider
            self._rescore_guard = 4 * RESCORE_GUARD
        else:
            self._rescore_guard = RESCORE_GUARD
        rq_env = os.getenv(ENV_RESCORE_MAX_Q)
        self._rescore_max_q: int = int(rq_env) if rq_env else RESCORE_MAX_Q
        # True once the host matrix was materialized from a lossy device
        # plane: rescoring against it cannot recover f32 precision, so the
        # host rescore stands down
        self._host_f32_lossy: bool = False
        self._last_rescore: Optional[str] = None

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
        # queries whose rescore guard band saturated and re-dispatched
        # wider (see _rescored_dispatch)
        self._rescore_escalations: int = 0
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
        qinfo = persistence.load_quantized(self._path)
        if qinfo is not None:
            self._load_quantized(qinfo)
            return
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
        self._load_slots(count)
        if self._active_indices.size:
            self._dev.full_upload(self._host_vectors, self._active_mask)
            self._last_sync_mode = "full"
            self._load_ann_sidecar(np.asarray(self._host_vectors))
            if self._ivf is None and self._index_kind == "ivf":
                logger.warning("ANN sidecar missing or stale; rebuilding")
                self._rebuild_ann()
        self._dirty = False
        logger.info("Loaded %d active / %d total vectors",
                    int(self._active_indices.size), count)

    def _load_ann_sidecar(self, host_vectors: Optional[np.ndarray]) -> None:
        """Adopt a persisted IVF sidecar that still matches the active rows
        (k-means is not retrained; the layout is rebuilt from the device
        corpus). A stale or unreadable sidecar leaves the tier unbuilt."""
        if self._index_kind == "exact" or not self._active_indices.size:
            return
        blob = persistence.load_ann(self._path)
        if blob is None:
            return
        self._ivf = ivf_ops.IVFIndex.from_blob(
            blob, host_vectors, self._active_mask, self.dim,
            dev_vectors=self._dev.vectors,
            storage_dtype=self._dev.storage_dtype,
            i8_only=self._ivf_i8_only(),
            dequant_scale=self._dev.vstore_scale, device=self._dev._device)
        if self._ivf is not None:
            self._ann_build_params = {"nlist_requested": self._ivf.nlist,
                                      "kmeans_iters": 0, "warm": "sidecar"}

    def _load_slots(self, count: int) -> None:
        """Docs and additional data of a checkpoint with `count` slots,
        and the free / active slot bookkeeping derived from them."""
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

    def _load_quantized(self, q: dict) -> None:
        """Open a quantized checkpoint (packed plane + row scales,
        persistence.save_quantized_atomic). The store comes back lazy, as
        a device-born store lives: the plane streams from its disk memmap
        to the device chunk by chunk and the float32 matrix never exists
        on either side. Overlay rows (mutations made while lazy before
        the save) are restored."""
        sd = self._dev.storage_dtype
        if sd != q["storage_dtype"]:
            raise ValueError(
                f"store at {self._path!r} was saved with storage_dtype="
                f"{q['storage_dtype']!r}; construct PicoVectorDB with "
                f"storage_dtype={q['storage_dtype']!r} (got {sd!r})"
            )
        if q["dim"] != self.dim:
            raise ValueError(
                f"quantized store has dim {q['dim']}; expected {self.dim} — "
                "wrong embedding_dim for this store?"
            )
        if self._use_memmap:
            raise ValueError(
                "use_memmap does not apply to quantized stores: the packed "
                "plane itself loads memmapped and streams to the device"
            )
        logger.info("Loading existing DB (quantized %s plane) …", sd)
        self._ids = persistence.load_ids(self._path)
        count = len(self._ids)
        if count != q["rows"]:
            raise ValueError(
                f"ids file has {count} slots but the quantized plane has "
                f"{q['rows']} rows — mismatched checkpoint generation"
            )
        self._load_slots(count)
        self._host_vectors = None
        self._host_lazy = True
        self._host_overlay = dict(q["overlay"])
        if count:
            self._dev.upload_prequantized(q["plane"], q["scales"],
                                          self._active_mask)
            self._last_sync_mode = "full"
        # the int8-only layout trains straight off the resident plane: a
        # missing or stale sidecar defers the build to the first query's
        # sync, which sees the mirror current (no host materialization)
        self._load_ann_sidecar(None)
        self._dirty = self._ivf is None and self._ann_build_due()
        logger.info("Loaded %d active / %d total vectors (quantized)",
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

        `quantized=True` (int8/int4 stores only) writes the storage plane
        and its row scales instead of a float32 matrix, streamed device ->
        disk chunk by chunk, so host memory stays one chunk. The default
        (None) takes that path for lazy (device-born or quantized-loaded)
        int8/int4 stores whose float32 matrix would pass
        PICOVDB_QSAVE_AUTO_GB (default 2); `quantized=False` forces the
        reference-compatible float32 format.
        """
        with self._rwlock.write_lock():
            if self._dirty:
                self._sync_device_locked()
            if self._quantized_save_applies(quantized, shards):
                n = len(self._ids)
                persistence.save_quantized_atomic(
                    self._path, self._ids, self._docs, self._additional,
                    self._dev.iter_store_chunks(n), n, self._dev.plane_cols,
                    self._dev.storage_dtype, self.dim,
                    overlay=self._host_overlay if self._host_lazy else None,
                    ann_blob=self._ann_blob(),
                )
                return
            self._ensure_host_vectors()
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
                self._host_vectors, self.dim, ann_blob=self._ann_blob(),
                n_shards=shards,
            )

    def _quantized_save_applies(self, quantized: Optional[bool],
                                shards: Optional[int]) -> bool:
        """Resolve the save format (see `save`). Caller holds the write
        lock and has synced the device, so when this returns True the
        resident plane is the authoritative corpus."""
        sd = self._dev.storage_dtype
        if quantized is False:
            return False
        if shards is not None and shards > 1:
            if quantized:
                raise ValueError(
                    "quantized save does not compose with shards=N; the "
                    "plane is one file (load streams it chunk by chunk)"
                )
            return False
        if quantized:
            if sd not in ("int8", "int4"):
                raise ValueError(
                    "quantized save requires int8/int4 storage; this "
                    f"store is {sd or 'float32'!r}"
                )
            return self._dev.vectors is not None and len(self._ids) > 0
        if sd not in ("int8", "int4") or not self._host_lazy:
            return False
        if self._dev.vectors is None or not self._ids:
            return False
        try:
            auto_gb = float(os.getenv("PICOVDB_QSAVE_AUTO_GB", "2") or 2)
        except ValueError:
            auto_gb = 2.0
        return len(self._ids) * self.dim * 4.0 > auto_gb * 2**30

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
                    self._write_host_row(idx, norm[j])
                    self._docs[idx] = meta
                    self._pending_add.add(idx)
                    touched_idx.append(idx)
                    touched_docs.append(meta)
                report["update"].append(item_id)
            else:
                if self._free:
                    idx = self._free.pop()
                    self._write_host_row(idx, norm[j])
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
            if self._host_lazy:
                # appended rows live in the overlay until a full
                # materialization; the device sync scatters them from it
                for t in range(len(new_rows)):
                    self._host_overlay[n_slots + t] = np.array(
                        stacked[t], dtype=Float)
            elif not n_slots:
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

    def ingest_device(
        self,
        vectors: torch.Tensor,
        ids: list[str],
        metadata: Optional[list[Optional[dict]]] = None,
        normalize: bool = True,
        scales: Optional[torch.Tensor] = None,
        host_shadow: bool = False,
    ) -> dict[str, list[str]]:
        """Bulk-load a (n, dim) tensor already on the store's device into a
        fresh store: the device-born counterpart of `upsert_columnar`
        (e.g. embeddings from an on-card encoder). Normalization, the
        storage-dtype cast or quantization, and the capacity pad run on
        the device; the host keeps ids and metadata only and the host
        matrix stays lazy (see `_ensure_host_vectors`).

        Requires an empty store (no rows, no fixed `capacity`, not
        memmapped) and explicit unique ids. The input is not consumed;
        `DeviceIndex.adopt` says when the store takes it without a copy
        (then the caller must not write to it).

        `scales=` takes pre-quantized int8/int4 input (`normalize=False`,
        rows normalized then quantized by `quantize_rows_i8` / `_i4`; int4
        rows packed, (n, dim / 2)), for corpora whose float32 form would
        not fit the device. `host_shadow=True` (lossy storage) fetches the
        normalized float32 rows to host before the cast and keeps them as
        the authentic host matrix, so the host-f64 rescore serves exact
        ranking; not with `scales=`. Without it a lossy device-born store
        ranks at storage precision.
        """
        if not isinstance(vectors, torch.Tensor):
            raise ValueError(
                "ingest_device expects a tensor on the store's device; for "
                "host numpy data use upsert_columnar"
            )
        want_dim = (self.dim // 2 if self._dev.storage_dtype == "int4"
                    and scales is not None else self.dim)
        if vectors.ndim != 2 or vectors.shape[1] != want_dim:
            raise ValueError(
                f"ingest_device expects a 2D array with last dim {want_dim};"
                f" got shape {tuple(vectors.shape)}"
            )
        n = vectors.shape[0]
        if scales is not None:
            if not self._dev.quantized:
                raise ValueError(
                    "scales= is only meaningful for int8/int4 storage; "
                    f"this store is {self._dev.storage_dtype!r}"
                )
            if normalize:
                raise ValueError(
                    "pre-quantized ingest (scales=...) requires "
                    "normalize=False: rows must already be "
                    "normalized-then-quantized (quantize_rows_i8/_i4)"
                )
            if vectors.dtype != torch.int8:
                raise ValueError(
                    "pre-quantized ingest expects int8 rows (packed bytes "
                    f"for int4 storage); got dtype {vectors.dtype}"
                )
            if getattr(scales, "ndim", 1) != 1 or scales.shape[0] != n:
                raise ValueError(
                    f"scales must be a ({n},) array (one per row); got "
                    f"shape {tuple(getattr(scales, 'shape', ()))}"
                )
        if host_shadow and scales is not None:
            raise ValueError(
                "host_shadow=True needs the f32 rows, which pre-quantized "
                "ingest (scales=...) never materializes; quantize on "
                "device without scales= or keep host_shadow=False"
            )
        if n == 0:
            return {"update": [], "insert": []}
        if ids is None or len(ids) != n:
            raise ValueError(
                f"ingest_device needs exactly one id per row; got "
                f"{0 if ids is None else len(ids)} ids for {n} rows"
            )
        if len(set(ids)) != n:
            raise ValueError("ingest_device ids must be unique")
        if metadata is not None and len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != number of vectors {n}"
            )
        with self._rwlock.write_lock():
            if self._ids or self._free or self._use_memmap:
                raise ValueError(
                    "ingest_device requires an empty, non-memmap store; "
                    "use upsert/upsert_columnar on populated stores"
                )
            if self._capacity is not None:
                raise ValueError(
                    "ingest_device does not support fixed-capacity stores"
                )
            shadow = self._dev.adopt(vectors, n, normalize=normalize,
                                     scales=scales, want_shadow=host_shadow)
            if shadow is not None:
                self._host_vectors = shadow
                self._host_lazy = False
                self._host_f32_lossy = False
            else:
                self._host_vectors = None
                self._host_lazy = True
            self._host_overlay = {}
            self._ids = list(ids)
            if metadata is None:
                self._docs = [{K_ID: _id} for _id in ids]
            else:
                self._docs = [
                    {**(m or {}), K_ID: _id} for m, _id in zip(metadata, ids)
                ]
            self._id2idx = None
            self._active_indices = np.arange(n, dtype=np.int64)
            self._active_mask = np.ones(n, dtype=bool)
            self._tag_index.resize(n)
            self._ids_np = None
            self._pending_add.clear()
            self._pending_remove.clear()
            self._pending_full = False
            self._filter_epoch += 1
            self._last_sync_mode = "full"
            self._ivf = None
            # the tier builds at the first query's sync, which finds the
            # device-born mirror current and uploads nothing
            self._dirty = self._ann_build_due()
            return {"update": [], "insert": list(ids)}

    def _write_host_row(self, idx: int, row: np.ndarray) -> None:
        """Record one mutated host row: lazy stores keep the exact f32 row
        in the overlay (O(changed) memory) instead of materializing."""
        if self._host_lazy:
            self._host_overlay[idx] = np.array(row, dtype=Float)
        else:
            self._host_vectors[idx] = row

    def _ensure_host_vectors(self) -> None:
        """Materialize the host matrix of a lazy store from the device
        (caller holds the write lock): one chunked device->host pass,
        int4 unpacked and int8 dequantized on the host, then the overlay
        rows on top. Rows that round-tripped a lossy plane are not
        authentic float32, so the host rescore stands down afterwards."""
        if not self._host_lazy:
            return
        n = len(self._ids)
        rows = np.zeros((n, self.dim), dtype=Float)
        dev = self._dev
        avail = min(n, dev.cap) if dev.vectors is not None else 0
        step = dev.STREAM_CHUNK_ROWS
        for s in range(0, avail, step):
            e = min(avail, s + step)
            rows[s:e] = dev.fetch_rows(np.arange(s, e))
        for idx, row in self._host_overlay.items():
            rows[idx] = row
        self._host_overlay.clear()
        self._host_vectors = rows
        if n and dev.storage_dtype != "float32":
            self._host_f32_lossy = True
        self._host_lazy = False

    def delete(self, ids: list[str]) -> list[str]:
        """Soft-delete vectors by ID; returns the IDs actually deleted."""
        with self._rwlock.write_lock():
            removed: list[str] = []
            removed_idxs: list[int] = []
            for _id in ids:
                idx = self._id2idx.pop(_id, None)
                if idx is not None:
                    self._docs[idx] = None
                    if self._host_lazy:
                        self._host_overlay[idx] = np.zeros(self.dim, Float)
                    else:
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
            self._ensure_host_vectors()
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
                self._rebuild_ann()  # compaction remapped every slot
                self._dirty = False
            else:
                # zero actives: the device mask may still mark old rows
                # active; the next query's sync re-uploads the cleared mask
                self._ivf = None
                self._pending_full = self._dev.vectors is not None
                self._dirty = self._pending_full

    def rebuild_index(self) -> None:
        """Force a full device mirror refresh (+ ANN rebuild) immediately."""
        with self._rwlock.write_lock():
            if len(self._ids) and not self._host_lazy:
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
            elif self._dirty:
                # a lazy store's device plane is the corpus: apply its
                # pending overlay rows and deletes instead of re-uploading
                self._sync_device_locked()
            self._pending_add.clear()
            self._pending_remove.clear()
            self._pending_full = False
            self._rebuild_ann()
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
        `ef_search` / `hnsw_ef_search` scale the IVF tier's probe width
        when it serves; the exact tiers ignore them.
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
            mask_key = self._mask_key(where, ids)
            rescore = self._host_rescore_applies(num_q)
            if rescore:
                # inside the read lock: host rows mutate in place under
                # the write lock, so the gather sees one snapshot
                vals, idxs = self._rescored_dispatch(
                    vecs, k_eff, n_cand, filter_mask, ef_search,
                    hnsw_ef_search, mask_key)
            else:
                vals, idxs = self._dispatch_query(
                    vecs, k_eff, filter_mask, ef_search, hnsw_ef_search,
                    mask_key=mask_key)
            self._last_rescore = "host" if rescore else None
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

    def _serve_chunks(self, vecs, k_eff, filter_mask, mask_key, batch_size,
                      k_sel=None, wvecs=None, ef=None):
        """Dispatch every chunk, then fetch each one, re-serving exactly
        the chunks whose route may carry a retry mark and did (-inf).
        Caller holds the read lock for the whole call: the mirror mutates
        in place, so the retry must see the dispatch-time state.

        Unfiltered chunks go to the IVF tier under `query`'s rule
        (index="ivf" always; "auto" while the chunk's probed-cluster union
        stays small, `_ann_routes_batch`); a chunk whose probed clusters
        were all empty is re-served by the exact scan.

        `k_sel` (>= k_eff) selects a wider band per chunk for the host
        re-rank of the int8 wire (`wvecs`, the encoded batch; `vecs` is
        the float32 batch it re-ranks against); each chunk then comes back
        re-ranked and cut to k_eff."""
        num_q = vecs.shape[0]
        k_sel = k_eff if k_sel is None else k_sel
        if wvecs is None:
            wvecs = self._wire_encode(vecs, num_q)
        ef = self._ef_search if ef is None else ef
        ann_ok = filter_mask is None and self._ann_admits_k(k_sel)
        pending = []
        for start in range(0, num_q, batch_size):
            chunk = wvecs[start:start + batch_size]
            if ann_ok and self._ann_routes_batch(chunk.shape[0], ef):
                vd, xd, nq = self._ivf.search_async(
                    chunk, k_sel, ef, self._dev, nprobe=self._ivf_nprobe)
                pending.append((start, chunk, vd, xd, nq, k_sel, False, True))
                self._last_topk_strategy = self._ivf_strategy_name()
                continue
            vd, xd, nq, ke = self._dev.query_async(
                chunk, k_sel, filter_mask, mask_key=mask_key)
            # a small tail chunk may route differently: record each one's
            pending.append((start, chunk, vd, xd, nq, ke,
                            _needs_exact_retry(self._dev.last_strategy), False))
            self._last_topk_strategy = self._dev.last_strategy
        snap = self._dev.snapshot()
        for start, chunk, vd, xd, nq, ke, retryable, is_ivf in pending:
            vals = vd.cpu().numpy()[:nq, :ke]
            idxs = xd.cpu().numpy()[:nq, :ke]
            if ((retryable and np.isneginf(vals).any())
                    or (is_ivf and not np.isfinite(vals).any())):
                vals, idxs = self._dev.query_exact_snapshot(snap, chunk, k_sel)
                self._exact_retries += 1
            if k_sel != k_eff:
                vals, idxs = self._host_rescore(vals, idxs,
                                                vecs[start:start + nq])
                vals, idxs = vals[:, :k_eff], idxs[:, :k_eff]
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
        tensor already on the device. Unfiltered chunks route to the IVF
        tier per chunk, under `query`'s rule.

        Small host batches of a lossy-storage store take `query` (its
        host rescore). With `query_wire="int8_rescore"`, host batches of
        QUERY_WIRE_MIN_Q or more ship on the 1 B wire, the device selects
        top-(k + PICOVDB_WIRE_RESCORE_GUARD), and the host re-ranks those
        candidates exactly on the authentic float32 rows."""
        vecs = self._as_query_batch(query_vecs, "query_batched")
        num_q = vecs.shape[0]
        if isinstance(vecs, np.ndarray) and self._host_rescore_applies(num_q):
            return self.query(vecs, top_k=top_k, better_than=better_than,
                              where=where, ids=ids, ef_search=ef_search,
                              hnsw_ef_search=hnsw_ef_search)
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
            # judged inside the lock: a writer may have swapped the corpus
            # (e.g. ingest_device dropping the authentic host rows)
            wire_rescore = (isinstance(vecs, np.ndarray)
                            and self._wire_rescore_applies(num_q))
            k_sel, wvecs = k_eff, None
            if wire_rescore:
                k_sel = min(k_eff + self._wire_guard, n_cand)
                wvecs = self._wire_encode(vecs, num_q, rescore=True)
            results = list(self._serve_chunks(
                vecs, k_eff, filter_mask, self._mask_key(where, ids),
                batch_size, k_sel=k_sel, wvecs=wvecs,
                ef=self._resolve_ef(ef_search, hnsw_ef_search)))
            self._last_rescore = "host-wire" if wire_rescore else None
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
        already on the device. Small host batches of a lossy-storage
        store re-rank on the host (`_rescored_dispatch`) chunk by chunk."""
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
            mask_key = self._mask_key(where, ids)
            rescore = (isinstance(vecs, np.ndarray)
                       and self._host_rescore_applies(num_q))
            if rescore:
                chunks = [self._rescored_dispatch(
                    vecs[s:s + batch_size], k_eff, n_cand, filter_mask,
                    ef_search, hnsw_ef_search, mask_key)
                    for s in range(0, num_q, batch_size)]
            else:
                chunks = self._serve_chunks(
                    vecs, k_eff, filter_mask, mask_key, batch_size,
                    ef=self._resolve_ef(ef_search, hnsw_ef_search))
            ids_arr = self._ids_array()
            docs_len = len(self._docs)
            row = 0
            for vals, idxs in chunks:
                nq, ke = vals.shape
                valid = np.isfinite(vals) & (idxs >= 0) & (idxs < docs_len)
                if better_than is not None:
                    valid &= vals >= better_than
                mapped = ids_arr[np.where(valid, idxs, 0)]
                mapped[~valid] = None
                out_ids[row:row + nq, :ke] = mapped
                out_scores[row:row + nq, :ke] = np.where(valid, vals, -np.inf)
                row += nq
            self._last_rescore = "host" if rescore else None
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
            single = isinstance(ids, str)
            recs: list[dict[str, Any]] = []
            slots: list[int] = []
            for _id in [ids] if single else ids:
                idx = self._id2idx.get(_id)
                if idx is not None:
                    recs.append(dict(self._docs[idx] or {K_ID: _id}))
                    slots.append(idx)
            self._attach_vectors(recs, slots, include_vector)
            if single:
                return recs[0] if recs else None
            return recs

    def _attach_vectors(self, recs: list, slots: list,
                        include_vector: bool) -> None:
        """Add each record's float32 row, fetched in one batch."""
        if include_vector and slots:
            for rec, row in zip(recs, self._host_rows_batch(slots)):
                rec[K_VECTOR] = row

    def _host_rows_batch(self, idxs: list[int]) -> np.ndarray:
        """Float32 rows by slot: from the host matrix, or for a lazy store
        by one chunked, dequantizing device gather (`fetch_rows`) with the
        overlay rows (mutations made while lazy: exact, and fresher than
        the device until the next sync) on top."""
        arr = np.asarray(idxs, dtype=np.int64)
        if not self._host_lazy:
            return np.asarray(self._host_vectors)[arr].astype(Float, copy=True)
        # slots past the device rows (appends not yet synced) always live
        # in the overlay; clip the gather and let the overlay win below
        rows = self._dev.fetch_rows(np.minimum(arr, self._dev.cap - 1))
        for pos, i in enumerate(arr.tolist()):
            cached = self._host_overlay.get(i)
            if cached is not None:
                rows[pos] = cached
        return rows

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
            live: list[dict[str, Any]] = []
            slots: list[int] = []
            if include_deleted:
                for idx, (_id, doc) in enumerate(zip(self._ids, self._docs)):
                    if doc is not None:
                        rec = dict(doc)
                        rec[K_ID] = _id
                        live.append(rec)
                        slots.append(idx)
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
                    live.append(rec)
                    slots.append(idx)
                    docs.append(rec)
            self._attach_vectors(live, slots, include_vector)
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
                "ann_active": self._ivf is not None,
                "ann_rebuild_mode": self._last_ann_rebuild_mode,
                # what the IVF tier would serve with right now
                "ann_operating_point": self._ann_operating_point(),
                # the construction point the last build resolved to
                "ann_build_params": self._ann_build_params,
                "rescore": self._last_rescore,
            }

    def _ann_operating_point(self) -> Optional[dict]:
        ivf = self._ivf
        if ivf is None:
            return None
        return {
            "nlist": int(ivf.nlist),
            "nprobe_default": int(
                self._ivf_nprobe
                or ivf_ops.ef_to_nprobe(self._ef_search, ivf.nlist)),
            "layout": "int8_only" if ivf.vectors is None else "classic",
            "postings": ("int8" if ivf.vectors_i8c is not None
                         else str(ivf.vectors.dtype).replace("torch.", "")),
            # rows in the always-probed overflow region since the last
            # full build, and the last requantize-on-append's clip rate
            "overflow_fraction": float(ivf.overflow_fraction),
            "last_update_clip_fraction": ivf.last_update_clip_fraction,
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
                # back-compat key: truthy when an ANN tier exists
                "faiss": self._ivf is not None,
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
                # host-f64 rescore of lossy storage: mode, guard band,
                # last query's application
                "rescore": {
                    "mode": self._rescore_mode,
                    "guard": self._rescore_guard,
                    "max_q": self._rescore_max_q,
                    "last": self._last_rescore,
                },
                "rescore_escalations": self._rescore_escalations,
                "mirrors": {
                    "bf16": self._dev.vectors_lp is not None,
                    "int8_rows": self._dev.vectors_i8 is not None,
                    "int8_cols": self._dev.vectors_i8c is not None,
                },
                "ann_postings": (
                    None if self._ivf is None
                    else "int8-only" if self._ivf.vectors is None
                    else "storage+int8" if self._ivf.vectors_i8c is not None
                    else "storage"),
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

    def _wire_encode(self, vecs, num_q: int, rescore: bool = False):
        """Compact upload dtype for a host query batch (the int16 wire from
        QUERY_WIRE_MIN_Q queries under "auto"); tensors pass through. The
        device widens to float32 and normalizes, so the ranking holds.
        "int8_rescore" ships the 1 B wire only to a caller that re-ranks
        on the host (`rescore`, query_batched) and can (authentic rows);
        otherwise it falls back to the int16 wire."""
        if not isinstance(vecs, np.ndarray) or vecs.dtype != Float:
            return vecs
        mode = self._query_wire
        if mode == "float32":
            return vecs
        if mode in ("auto", "int8_rescore"):
            if num_q < QUERY_WIRE_MIN_Q:
                return vecs
            mode = ("int8" if mode == "int8_rescore" and rescore
                    and self._wire_rescore_applies(num_q) else "int16")
        from .utils import encode_query_wire

        return encode_query_wire(vecs, mode)

    def _wire_rescore_applies(self, num_q: int) -> bool:
        """Whether the int8 wire + host exact re-rank lane runs: opted in,
        a wire-sized host batch, and authentic float32 host rows."""
        return (self._query_wire == "int8_rescore"
                and num_q >= QUERY_WIRE_MIN_Q
                and not self._host_lazy
                and not self._host_f32_lossy)

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

    def _host_rescore_applies(self, num_q: int) -> bool:
        """Whether this query re-ranks on authentic host float32 rows:
        lossy storage only (bfloat16 / int8 / int4 selection loses the
        near-ties), never when the host copy itself came from the lossy
        plane (lazy or materialized device-born stores); "auto" up to
        `_rescore_max_q` queries, "host" always, "device" never."""
        mode = self._rescore_mode
        if mode == "device" or self._dev.storage_dtype == "float32":
            return False
        if self._host_lazy or self._host_f32_lossy:
            return False
        return mode == "host" or num_q <= self._rescore_max_q

    def _rescored_dispatch(self, vecs, k_eff, n_cand, filter_mask,
                           ef_search=None, hnsw_ef_search=None,
                           mask_key=None):
        """Device dispatch of a guard-widened candidate band + host-f64
        rescore + one saturation escalation (caller holds the read lock).
        Returns (vals, idxs) with k_eff columns, exactly ranked against
        the authentic float32 rows.

        The band can saturate: a near-duplicate corpus may pack more
        near-ties than `_rescore_guard` candidates. Every unselected row
        has a selection score <= the band's bottom a_min, so its exact
        score is <= a_min + eps (eps = 3x the tier's quantization noise,
        ops/scan._tie_margin). Where a_min + eps reaches the exact k-th
        score the true top-k may extend past the band: those queries
        re-dispatch once at 4x the width (at most 4096; counted in
        `stats()["rescore_escalations"]`)."""
        k_req = min(k_eff + self._rescore_guard, n_cand)
        vals_a, idxs = self._dispatch_query(vecs, k_req, filter_mask,
                                            ef_search, hnsw_ef_search,
                                            mask_key=mask_key)
        vals, idxs = self._host_rescore(vals_a, idxs, vecs)
        if k_req < n_cand:
            sat = self._rescore_saturated(vals_a, vals, k_eff)
            k2 = min(max(4 * k_req, 1024), n_cand, 4096)
            if sat.any() and k2 > k_req:
                self._rescore_escalations += int(sat.sum())
                sub = np.ascontiguousarray(np.asarray(vecs)[sat])
                v2a, i2 = self._dispatch_query(sub, k2, filter_mask,
                                               ef_search, hnsw_ef_search,
                                               mask_key=mask_key)
                v2, i2 = self._host_rescore(v2a, i2, sub)
                vals = vals[:, :k_eff].copy()
                idxs = idxs[:, :k_eff].copy()
                vals[sat] = v2[:, :k_eff]
                idxs[sat] = i2[:, :k_eff]
                return vals, idxs
        return vals[:, :k_eff], idxs[:, :k_eff]

    def _rescore_saturated(self, vals_approx, vals_exact, k_eff):
        """(Q,) bool: queries whose guard band may be cut mid-tie (see
        _rescored_dispatch); vals_approx are the device's selection
        scores, vals_exact the rescored, sorted exact scores."""
        from .ops.scan import _tie_margin

        va = np.asarray(vals_approx, dtype=np.float32)
        finite = np.isfinite(va)
        a_min = np.where(finite, va, np.inf).min(axis=1)
        ve = np.asarray(vals_exact)
        kth = ve[:, min(k_eff, ve.shape[1]) - 1]
        kind = {"bfloat16": "bf16", "int4": "int4"}.get(
            self._dev.storage_dtype, "int8")
        eps = 3.0 * _tie_margin(kind, self.dim, 1.0)
        return finite.any(axis=1) & np.isfinite(kth) & (a_min + eps >= kth)

    def _host_rescore(self, vals, idxs, vecs):
        """Exact re-rank of device candidates on the host float32 rows
        (caller holds the read lock).

        Each unique candidate row is read once; scores run in float32
        BLAS, and queries whose adjacent float32 gaps fall under 1e-5
        (too tight to rank reliably) are re-scored in float64. Invalid
        slots (-inf / NaN scores, out-of-range rows) sink to the tail as
        -inf, and a row the selection returned twice keeps its best-ranked
        copy only. Returned scores are float32."""
        vals = np.asarray(vals, dtype=np.float32)
        idxs = np.asarray(idxs, dtype=np.int64)
        n_rows = self._host_vectors.shape[0]
        valid = (idxs >= 0) & (idxs < n_rows) & np.isfinite(vals)
        if not valid.any():
            return vals, idxs
        q32 = normalize_batch(np.asarray(vecs, dtype=Float))
        nq, kr = idxs.shape
        flat = np.where(valid, idxs, 0)
        uniq, inv = np.unique(flat.ravel(), return_inverse=True)
        rows_u = np.ascontiguousarray(
            np.asarray(self._host_vectors[uniq], dtype=np.float32))
        inv = inv.reshape(nq, kr)
        ex = np.empty((nq, kr), dtype=np.float32)
        step = max(1, (1 << 22) // max(1, kr * self.dim))  # ~16 MB buffer
        buf = np.empty((step * kr, self.dim), dtype=np.float32)
        for s in range(0, nq, step):
            e = min(nq, s + step)
            m = e - s
            np.take(rows_u, inv[s:e].ravel(), axis=0, out=buf[: m * kr])
            ex[s:e] = np.einsum("qd,qkd->qk", q32[s:e],
                                buf[: m * kr].reshape(m, kr, self.dim),
                                optimize=True)
        ex = np.where(valid, ex.astype(np.float64), -np.inf)
        order = np.argsort(-ex, axis=1, kind="stable")
        exs = np.take_along_axis(ex, order, axis=1)
        if kr > 1:
            # nan gaps (two invalid slots), +inf (valid over invalid) and
            # zero gaps between copies of one row are no ambiguity
            gaps = exs[:, :-1] - exs[:, 1:]
            ids_sorted = np.take_along_axis(idxs, order, axis=1)
            dup = ids_sorted[:, :-1] == ids_sorted[:, 1:]
            ambiguous = ((np.nan_to_num(gaps, nan=1.0, posinf=1.0) < 1e-5)
                         & ~dup).any(axis=1)
            if ambiguous.any():
                qa = q32[ambiguous].astype(np.float64)
                rowsa = rows_u[inv[ambiguous].ravel()].astype(np.float64)
                exa = np.einsum("qd,qkd->qk", qa,
                                rowsa.reshape(qa.shape[0], kr, self.dim))
                ex[ambiguous] = np.where(valid[ambiguous], exa, -np.inf)
                order = np.argsort(-ex, axis=1, kind="stable")
                exs = np.take_along_axis(ex, order, axis=1)
        # sink duplicate rows: keep the best-ranked copy, re-sort stably
        ids_sorted = np.take_along_axis(idxs, order, axis=1)
        bys = np.argsort(ids_sorted, axis=1, kind="stable")
        s_by = np.take_along_axis(ids_sorted, bys, axis=1)
        dup_by = np.zeros(ids_sorted.shape, dtype=bool)
        dup_by[:, 1:] = (s_by[:, 1:] == s_by[:, :-1]) & (s_by[:, 1:] >= 0)
        if dup_by.any():
            dup_sorted = np.zeros_like(dup_by)
            np.put_along_axis(dup_sorted, bys, dup_by, axis=1)
            exs = np.where(dup_sorted, -np.inf, exs)
            reorder = np.argsort(-exs, axis=1, kind="stable")
            exs = np.take_along_axis(exs, reorder, axis=1)
            order = np.take_along_axis(order, reorder, axis=1)
        return exs.astype(np.float32), np.take_along_axis(idxs, order, axis=1)

    def _resolve_ef(self, ef_search: Optional[int],
                    hnsw_ef_search: Optional[int]) -> int:
        """Per-call ef: hnsw_ef_search -> ef_search -> the ctor default."""
        if hnsw_ef_search is not None:
            return int(hnsw_ef_search)
        if ef_search is not None:
            return int(ef_search)
        return self._ef_search

    def _ivf_strategy_name(self) -> str:
        return "ivf_i8" if self._ivf.vectors_i8c is not None else "ivf"

    def _ann_admits_k(self, k_eff: int) -> bool:
        """Whether the IVF tier can serve this k: K7's running top-k is
        bounded by its tile (k + 4 <= IVF_BN); wider k goes exact."""
        if self._ivf is None or self._index_kind == "exact":
            return False
        return k_eff + 4 <= ivf_ops.IVF_BN

    def _ann_routes_batch(self, num_q: int, ef: Optional[int] = None) -> bool:
        """index="ivf" always probes; "auto" probes while the batch's
        expected probed-cluster union nlist * (1 - (1 - nprobe/nlist)^Q)
        stays <= 0.22 of the lists (picovdb_tpu's measured crossover on
        clustered 2M x 1024 data; not re-measured on the H100)."""
        if self._index_kind != "auto":
            return True
        e = int(ef) if ef is not None else self._ef_search
        npb = self._ivf_nprobe or ivf_ops.ef_to_nprobe(e, self._ivf.nlist)
        return 1.0 - (1.0 - npb / self._ivf.nlist) ** num_q <= 0.22

    def _dispatch_query(self, vecs, k_eff, filter_mask, ef_search=None,
                        hnsw_ef_search=None, mask_key=None):
        """Route to the IVF tier (unfiltered, see `_ann_routes_batch`) or
        the exact routed scan, with the underfill/crowding retry: a -inf in
        a result whose route may mark one (segmax truncation or a crowded
        guard band; k_eff <= candidates by construction) re-runs exact."""
        if filter_mask is None and self._ann_admits_k(k_eff):
            ef = self._resolve_ef(ef_search, hnsw_ef_search)
            if self._ann_routes_batch(vecs.shape[0], ef):
                vals, idxs = self._ivf.search(vecs, k_eff, ef, self._dev,
                                              nprobe=self._ivf_nprobe)
                self._last_topk_strategy = self._ivf_strategy_name()
                return vals, idxs
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
        incremental-vs-full rebuild rule). A lazy store scatters from its
        overlay at any ratio: its re-upload would first materialize the
        host matrix. Then the IVF tier: small change sets append to its
        overflow region in place, anything else rebuilds it; `"auto"`
        builds it here once `should_build` holds."""
        size = len(self._ids)
        if size == 0:
            self._dirty = False
            return
        # a device-born (lazy) store with no mutation since: the mirror is
        # the corpus, and the dirty flag only deferred the IVF build
        mirror_current = (
            self._host_lazy and not self._pending_add
            and not self._pending_remove and not self._pending_full
            and self._dev.vectors is not None and self._dev.cap >= size)
        changed = ([] if mirror_current
                   else sorted(self._pending_add | self._pending_remove))
        if (not mirror_current and not self._pending_full and changed
                and self._dev.vectors is not None and size > self._dev.cap):
            # append epoch crossed a capacity bucket: grow on device
            self._grow_device(size)
        dev_rows = self._dev.cap
        need_full = not mirror_current and (
            self._pending_full
            or self._dev.vectors is None
            or size > dev_rows
            or not changed  # unknown change set -> be safe
        )
        if not need_full and not mirror_current and not self._host_lazy:
            ratio = len(changed) / float(max(1, min(size, dev_rows)))
            need_full = ratio > max(0.0, self._incr_threshold_ratio)
        ann_rows = None
        if mirror_current:
            pass
        elif need_full:
            self._ensure_host_vectors()
            self._dev.full_upload(
                np.asarray(self._host_vectors[:size]), self._active_mask)
            self._last_sync_mode = "full"
        else:
            idxs = np.asarray(changed, dtype=np.int64)
            if self._host_lazy:
                # adds are in the overlay by construction; removed slots
                # may not be (mask False -> row content is irrelevant)
                zero = np.zeros(self.dim, dtype=Float)
                rows = np.stack([self._host_overlay.get(i, zero)
                                 for i in changed]).astype(Float, copy=False)
            else:
                rows = np.ascontiguousarray(
                    np.asarray(self._host_vectors)[idxs], dtype=Float)
            self._dev.scatter(idxs, rows, self._active_mask[idxs])
            self._last_sync_mode = "incremental"
            ann_rows = (idxs, rows)
        self._pending_add.clear()
        self._pending_remove.clear()
        self._pending_full = False
        if self._ivf is not None or self._ann_build_due():
            done = False
            if (self._ivf is not None and ann_rows is not None
                    and self._ivf.overflow_fraction
                    <= max(0.0, self._incr_threshold_ratio)):
                idxs, rows = ann_rows
                done = self._ivf.update(idxs, rows, self._active_mask[idxs])
            if done:
                self._last_ann_rebuild_mode = "incremental"
            else:
                self._rebuild_ann()
                self._last_ann_rebuild_mode = (
                    "full" if self._ivf is not None else None)
        self._dirty = False

    def _grow_device(self, size: int) -> None:
        """Grow the device planes to `size` rows. At the memory ceiling
        with the IVF postings resident, free them (their centroids stay in
        `_ivf_warm_blob` for a warm rebuild) and retry once; a grow that
        still fails leaves the store to the sync's full re-upload."""
        if self._dev.grow(size) or self._ivf is None:
            return
        logger.warning("device grow to %d rows ran out of device memory; "
                       "freeing the IVF postings and retrying", size)
        self._ivf_warm_blob = self._ivf._host_blob
        self._ivf = None
        if self._dev._device.type == "cuda":
            torch.cuda.empty_cache()
        if not self._dev.grow(size):
            logger.warning("device grow retry failed after freeing the IVF "
                           "postings; falling back to the full re-upload")

    # ------------------------------------------------------------------
    # IVF tier: layout choice, fit, construction point, (re)build
    # ------------------------------------------------------------------

    def _ann_build_due(self) -> bool:
        """Whether the IVF tier should exist: index="ivf" always, "auto"
        once the exact sweep is large enough (`should_build`)."""
        n = int(self._active_indices.size)
        if not n or self._index_kind == "exact":
            return False
        if self._index_kind == "ivf":
            return True
        return ivf_ops.should_build(n, self.dim,
                            _storage_itemsize(self._dev.storage_dtype))

    def _ann_blob(self) -> Optional[dict]:
        return self._ivf.to_blob() if self._ivf is not None else None

    def _ivf_i8_only(self) -> bool:
        """The int8-only postings layout: always for int8/int4 storage (raw
        rows cannot be scored without their row scales), and for float
        stores whose classic layout (a storage-dtype postings mirror beside
        the corpus) would pass the device budget (`_ivf_budget_bytes`).
        PICOVDB_IVF_I8ONLY forces it on (1) or off (0)."""
        if self._dev.storage_dtype in ("int8", "int4"):
            return True
        env = os.getenv("PICOVDB_IVF_I8ONLY", "auto").strip().lower()
        if env in ("0", "false", "off", "no"):
            return False
        if env in ("1", "true", "on", "yes"):
            return ivf_ops._ivf_i8_enabled(self.dim)
        if not ivf_ops._ivf_i8_enabled(self.dim):
            return False
        item = _storage_itemsize(self._dev.storage_dtype)
        n = max(int(self._active_indices.size), 1)
        corpus_b = self._dev.cap * self.dim * item
        mirror_b = int(1.05 * n) * self.dim * (item + 1)
        return corpus_b + mirror_b > self._ivf_budget_bytes()

    def _ivf_fits(self, n_active: int) -> bool:
        """Whether the postings fit beside the corpus: ~1.05 n rows at
        1 B/element (int8-only) or at the storage width plus an int8
        mirror (classic), within the budget plus 1 GiB."""
        item = _storage_itemsize(self._dev.storage_dtype)
        corpus_b = max(self._dev.cap, n_active) * self.dim * item
        if self._ivf_i8_only():
            post_b = int(1.05 * n_active) * self.dim
        else:
            post_b = int(1.05 * n_active) * self.dim * (item + 1)
        return corpus_b + post_b <= self._ivf_budget_bytes() + 2**30

    def _ivf_budget_bytes(self) -> float:
        """Device bytes the corpus and the IVF postings may take together:
        PICOVDB_IVF_BUDGET_GB, else 13/16 of the card's memory (the share
        picovdb_tpu's 13 GB leaves of a 16 GB v5e), else 13 GiB off the
        card."""
        env = os.getenv("PICOVDB_IVF_BUDGET_GB")
        if env:
            try:
                return float(env) * 2**30
            except ValueError:
                pass
        if self._dev._device.type == "cuda":
            total = torch.cuda.mem_get_info(self._dev._device)[1]
            return total * 13.0 / 16.0
        return 13.0 * 2**30

    def _ivf_build_params(self, n_active: int, warm: bool) -> tuple:
        """(nlist, k-means iterations) of the next build. Explicit
        `ivf_nlist` wins; otherwise `hnsw_m` scales the partition count
        (default_nlist(N) * m / 32) and `hnsw_ef_construction` the k-means
        effort (8 * efc / 40, clamped to [4, 32]); the defaults leave the
        tuned build as it is."""
        nlist: Optional[int] = self._ivf_nlist
        if nlist is None and self._hnsw_m != HNSW_M:
            nlist = int(max(8, min(4096, round(
                ivf_ops.default_nlist(n_active) * self._hnsw_m / HNSW_M))))
        iters = 8
        if self._hnsw_efc != HNSW_EFC:
            iters = int(max(4, min(32, round(8 * self._hnsw_efc / HNSW_EFC))))
        self._ann_build_params = {
            "nlist_requested": nlist,
            "kmeans_iters": iters,
            "hnsw_m": self._hnsw_m,
            "hnsw_ef_construction": self._hnsw_efc,
            "warm": "centroids" if warm else None,
        }
        return nlist, iters

    @timed("rebuild_ann")
    def _rebuild_ann(self) -> None:
        """(Re)build the IVF tier when it is due and fits (caller holds the
        write lock and has synced the device mirror, so the build reads
        the device corpus). Running out of device memory leaves the store
        exact; any other error raises."""
        if not self._ann_build_due():
            self._ivf = None
            return
        n_active = int(self._active_indices.size)
        if self._dev.quantized and not ivf_ops._ivf_i8_enabled(self.dim):
            # quantized storage has only the int8 postings layout, whose
            # column quantization stacks on the storage quantization below
            # IVF_I8_MIN_DIM: serve exact
            if self._index_kind == "ivf":
                logger.warning(
                    "index='ivf' with %s storage needs dim >= %d (or "
                    "PICOVDB_IVF_I8=1); serving exact",
                    self._dev.storage_dtype, ivf_ops.IVF_I8_MIN_DIM)
            self._ivf = None
            return
        if not self._ivf_fits(n_active):
            if self._index_kind == "ivf":
                logger.warning("IVF postings (%d rows) cannot fit device "
                               "memory beside the corpus; serving exact",
                               n_active)
            self._ivf = None
            return
        warm_blob = (self._ivf._host_blob
                     if self._ivf is not None and self._ivf._host_blob
                     else self._ivf_warm_blob)
        warm = warm_blob["centroids"] if warm_blob else None
        self._ivf_warm_blob = None
        # free the old postings first: two corpus-sized mirrors may not fit
        self._ivf = None
        dev_vectors = (self._dev.vectors
                       if self._dev.vectors is not None
                       and self._dev.cap >= len(self._ids) else None)
        if dev_vectors is None:
            self._ensure_host_vectors()
        nlist, iters = self._ivf_build_params(n_active, warm is not None)
        try:
            self._ivf = ivf_ops.IVFIndex.build(
                np.asarray(self._host_vectors[: len(self._ids)])
                if dev_vectors is None else None,
                self._active_mask, nlist=nlist, iters=iters, dim=self.dim,
                warm_centroids=warm, dev_vectors=dev_vectors,
                storage_dtype=self._dev.storage_dtype,
                i8_only=self._ivf_i8_only(),
                dequant_scale=(self._dev.vstore_scale
                               if dev_vectors is not None else None),
                device=self._dev._device)
        except torch.cuda.OutOfMemoryError:
            logger.warning("IVF build ran out of device memory; serving "
                           "exact", exc_info=True)
            self._ivf = None


# Routes whose results may carry a -inf retry mark: segmax underfill
# (per-segment truncation) or the crowding mark. All of them serve
# unfiltered queries only, so the exact retry over (vectors, active) is the
# full candidate set. "mixed_fused_batch_filtered" is never marked and is
# not retried, hence the exact match for the unfiltered name.
_RETRY_PREFIXES = (
    "segmax", "mixed_fused_smallq", "i8_fused_smallq", "i8c_fused_smallq"
)


def _storage_itemsize(storage_dtype: Optional[str]) -> float:
    """Bytes per corpus element as the exact sweep reads it."""
    return {"bfloat16": 2.0, "int8": 1.0, "int4": 0.5}.get(
        storage_dtype or "float32", 4.0)


def _needs_exact_retry(strategy) -> bool:
    if not strategy:
        return False
    return (strategy == "mixed_fused_batch"
            or strategy.startswith(_RETRY_PREFIXES))
