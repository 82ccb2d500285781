"""Device-resident corpus mirror and query dispatch (PyTorch).

Counterpart of picovdb_tpu/device.py for one device: the corpus lives on
the device as a padded (cap, dim) tensor in its storage dtype plus a
boolean active mask. A float32 (or bfloat16) store keeps two selection
mirrors derived on device next to it (a bfloat16 copy for the batch
segmax tier, and per-row int8 + scales for the small-batch tier), and
builds a third on demand for the opt-in column-scaled int8 routes
(`ensure_i8c_mirror`); an int8 or int4 store IS its quantized tier:
per-row int8 rows, or two-plane packed int4 rows (dim / 2 bytes), with
their per-row scales (`vstore_scale`), and no mirrors. Mutations are
applied in place (`index_copy_`), which is what the JAX package's buffer
donation approximated.

Host state (ids, docs, free slots) stays authoritative in
`picovdb_tpu_torch.engine`; the mirror is synchronized lazily before a
query: small mutation sets scatter, large ones re-upload.

Route names (`last_strategy`) are the JAX package's, so the two packages'
dispatch decisions can be compared one to one.
"""

from __future__ import annotations

import logging
import os as _os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import Float, ROW_PAD
from .ops.exact import (
    default_device,
    make_approx_topk,
    make_exact_topk,
    make_exact_topk_i4r,
    make_exact_topk_i8r,
    normalize_on_device,
)
from .ops.scan import (
    make_fused_topk,
    make_fused_topk_i4,
    make_fused_topk_i8,
    make_fused_topk_i8c,
    make_mixed_fused_topk,
    make_segmax_topk,
    make_segmax_topk_i8,
    make_segmax_topk_i8c,
    quantize_cols_i8,
    quantize_rows_i4,
    quantize_rows_i8,
    unpack_i4_np_into,
)
from .utils import round_up

_log = logging.getLogger("picovdb_tpu_torch")

_FVIEW_MISS = object()  # distinguishes 'not cached' from a cached refusal
_OFF = ("0", "false", "False")


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to picovdb_tpu_torch yet (ROADMAP.md queue 1, "
        f"{item}); use picovdb_tpu for it"
    )


def _pad_rows(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if arr.shape[0] == cap:
        return arr
    pad = cap - arr.shape[0]
    widths = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def _pad_to(t: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    """A copy of `t` zero-padded to `rows` rows on its device (None stays
    None). The one allocation `grow` makes per plane."""
    if t is None:
        return None
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


class DeviceIndex:
    """Device-resident (cap, dim) corpus + active mask with routed masked
    top-k dispatch (single device)."""

    def __init__(
        self,
        dim: int,
        device=None,
        mesh=None,
        shard_axis: str = "shard",
        compute_dtype: Optional[str] = None,
        use_pallas: Optional[bool] = None,
        storage_dtype: Optional[str] = None,
        scan_mode: str = "auto",
        mixed_precision: Optional[bool] = None,
        int8_tier: Optional[bool] = None,
    ) -> None:
        if mesh is not None:
            raise _not_in_slice("mesh= (multi-device stores)",
                                "item 8, multi-GPU")
        self.storage_dtype = storage_dtype or "float32"
        if self.storage_dtype not in ("float32", "bfloat16", "int8", "int4"):
            raise ValueError(
                "storage_dtype must be one of float32/bfloat16/int8/int4; "
                f"got {self.storage_dtype!r}"
            )
        if self.storage_dtype == "int4" and dim % 2:
            raise ValueError(
                "int4 storage packs two elements per byte and needs an "
                f"even embedding_dim; got {dim}"
            )
        if scan_mode not in ("auto", "mixed", "fused", "approx", "xla"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        self.dim = dim
        self.cap = 0
        # (cap, dim) in the storage dtype; (cap, dim / 2) packed for int4
        self.vectors: Optional[torch.Tensor] = None
        self.vstore_scale: Optional[torch.Tensor] = None  # int8/int4 rows
        self.vectors_lp: Optional[torch.Tensor] = None  # bf16 scan mirror
        self.vectors_i8: Optional[torch.Tensor] = None  # int8 mirror
        self.vscale: Optional[torch.Tensor] = None  # (cap,) its row scales
        # column-scaled int8 mirror + its (dim,) column scales, built on
        # demand (ensure_i8c_mirror) while _i8c_budget_ok
        self.vectors_i8c: Optional[torch.Tensor] = None
        self.cscale: Optional[torch.Tensor] = None
        self._i8c_budget_ok = False
        self.active: Optional[torch.Tensor] = None  # (cap,) bool
        if compute_dtype is None and self.storage_dtype == "bfloat16":
            compute_dtype = "bfloat16"
        self.compute_dtype = compute_dtype
        self._device = (torch.device(device) if device is not None
                        else default_device())
        on_card = self._device.type == "cuda"
        f32_store = self.storage_dtype == "float32"
        # The hand-written kernels, the bf16 mirror and the int8 mirror
        # default on for the card and off elsewhere, as the JAX package
        # turns them on for its TPU; the mirrors only for float32 storage
        # (a lossy store is its own selection tier).
        if use_pallas is None:
            use_pallas = on_card
        self.use_pallas = use_pallas
        self.scan_mode = scan_mode
        if mixed_precision is None:
            mixed_precision = (on_card and f32_store) or scan_mode == "mixed"
        self.mixed_precision = bool(mixed_precision)
        if int8_tier is None:
            env = _os.getenv("PICOVDB_INT8_TIER")
            if env is not None:
                int8_tier = env not in ("0", "false", "False", "")
            else:
                int8_tier = on_card and f32_store
        self.int8_tier = bool(int8_tier)
        # The opt-in selection tiers, read as the JAX package reads them.
        # PICOVDB_SEGMAX_I8: the batch segmax over the per-row int8 mirror.
        # PICOVDB_INT8C_TIER (default: the int8 tier) places the lazily
        # built column-scaled int8 mirror; PICOVDB_SEGMAX_I8C /
        # PICOVDB_SMALLQ_I8C route batches (K10) and Q <= 16 (K9) to it.
        self.segmax_i8 = self.int8_tier and _os.getenv(
            "PICOVDB_SEGMAX_I8", "") not in ("",) + _OFF
        env_i8c = _os.getenv("PICOVDB_INT8C_TIER", "auto")
        self.i8c_tier = (self.int8_tier if env_i8c in ("auto", "")
                         else env_i8c not in _OFF)
        env_seg_i8c = _os.getenv("PICOVDB_SEGMAX_I8C", "auto")
        self.segmax_i8c = self.i8c_tier and (
            self.SEGMAX_I8C_DEFAULT if env_seg_i8c in ("auto", "")
            else env_seg_i8c not in _OFF)
        env_smq_i8c = _os.getenv("PICOVDB_SMALLQ_I8C", "auto")
        self.smallq_i8c = self.i8c_tier and (
            self.SMALLQ_I8C_DEFAULT if env_smq_i8c in ("auto", "")
            else env_smq_i8c not in _OFF)
        # PICOVDB_SEGMAX_STREAM in {auto, 0, 1}: the grid-order choice of
        # the TPU kernel. Blocks carry no state here, so both orders are
        # the same launch; the knob only selects the route's name.
        env_stream = _os.getenv("PICOVDB_SEGMAX_STREAM", "auto")
        self.segmax_stream = (
            None if env_stream in ("auto", "") else
            env_stream not in ("0", "false", "False")
        )
        # Per-dispatch strategy, thread-local: the engine decides the exact
        # retry from the strategy of its OWN dispatch (see picovdb_tpu).
        self._strategy_tls = threading.local()
        self._strategy_global: Optional[str] = None
        self.last_sync_mode: Optional[str] = None
        # Device-resident filter-mask cache keyed by the engine's frozen
        # filter spec + mutation epoch; cleared on any mirror mutation.
        self._mask_cache: dict = {}
        self.MASK_CACHE_MAX = 32
        # Compacted filtered-corpus views (surviving rows gathered dense
        # from the bf16 mirror) for the filtered big-batch segmax route,
        # keyed like _mask_cache; big, so the bound is small.
        self._fview_cache: dict = {}
        self.FVIEW_CACHE_MAX = 2

    @property
    def last_strategy(self) -> Optional[str]:
        """The calling thread's most recent dispatch strategy (threads
        that never dispatched read the process-wide last value)."""
        return getattr(self._strategy_tls, "v", self._strategy_global)

    @last_strategy.setter
    def last_strategy(self, value: Optional[str]) -> None:
        self._strategy_tls.v = value
        self._strategy_global = value

    # -- placement -----------------------------------------------------------

    def _padded_cap(self, n: int) -> int:
        return round_up(max(n, 1), ROW_PAD)

    def _cap_with_headroom(self, n: int) -> int:
        """Padded capacity plus ~n/64 append headroom on stores of >= 1M
        rows, so many append epochs scatter before `grow` must copy."""
        cap = max(self.cap, self._padded_cap(n))
        if n >= 1_000_000 and cap != n:
            cap = max(cap, self._padded_cap(n + n // 64))
        return cap

    # `auto` routing bounds, the JAX package's values (measured on its TPU;
    # re-measuring them on the H100 is a ROADMAP item).
    SMALL_Q_XLA = 16
    SEGMAX_MAX_K = 16
    SEGMAX_MIN_CAP = 32_768
    STREAM_CHUNK_ROWS = 262_144
    # The column-scaled int8 routes stay opt-in, as in the JAX package;
    # whether they win on the H100 is measured by chip_smoke.py phase 9.
    SEGMAX_I8C_DEFAULT = False
    SMALLQ_I8C_DEFAULT = False
    # Rows per device gather in fetch_rows.
    FETCH_CHUNK_ROWS = 262_144

    # f32 corpus + mirrors = up to 8 bytes/row/dim; above this the mirrors
    # are skipped. Kept at the JAX package's value (PICOVDB_MIXED_BUDGET_GB
    # overrides) so both packages route alike; deriving it from
    # torch.cuda.mem_get_info is a ROADMAP item.
    MIXED_HBM_BUDGET = 12 * 2**30

    @property
    def quantized(self) -> bool:
        return self.storage_dtype in ("int8", "int4")

    @property
    def plane_cols(self) -> int:
        """Columns of the storage plane: dim, or dim / 2 packed int4."""
        return self.dim // 2 if self.storage_dtype == "int4" else self.dim

    def _quantize(self, rows: torch.Tensor):
        """Float rows -> (int8 or packed int4 rows, row scales) on device."""
        if self.storage_dtype == "int4":
            return quantize_rows_i4(rows)
        return quantize_rows_i8(rows)

    def _plane_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            self.storage_dtype, torch.int8)

    def _host_tensor(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # e.g. a read-only checkpoint memmap
            arr = arr.copy()
        return torch.from_numpy(arr).to(self._device)

    def _commit(self, vectors, vstore_scale, active, cap: int) -> None:
        """Install freshly built planes and derive the mirrors."""
        self.vectors = vectors
        self.vstore_scale = vstore_scale
        self.active = active
        self.cap = cap
        self._refresh_lp_mirror()
        self._mask_cache.clear()
        self._fview_cache.clear()
        self.last_sync_mode = "full"

    def grow(self, n: int) -> bool:
        """Grow padded capacity on device to hold `n` rows (device copies,
        no host traffic), with max(ROW_PAD, n/64) rows of slack.

        Peak device memory is the old plus the new plane. When an
        allocation fails (`torch.cuda.OutOfMemoryError`, nothing else) the
        store stays consistent, as in picovdb_tpu:
          * the corpus pad fails: nothing changed, returns False;
          * a later core pad fails (`active`, the int8/int4 row scales):
            every plane is dropped and False returned, so the engine's
            sync re-uploads all of them at one capacity;
          * an optional mirror (bf16, int8 + scales) fails: that mirror
            alone is dropped (its routes stand down) and True returned.
        The lazy column-scaled int8 mirror is dropped in every case.
        """
        if self.vectors is None:
            return False
        new_cap = max(self.cap, self._padded_cap(n + max(ROW_PAD, n // 64)))
        if new_cap <= self.cap:
            return True
        try:
            vectors = _pad_to(self.vectors, new_cap)
        except torch.cuda.OutOfMemoryError:
            _log.warning("device grow %d -> %d rows ran out of device "
                         "memory; store unchanged", self.cap, new_cap)
            return False
        self.vectors = vectors
        try:
            self.active = _pad_to(self.active, new_cap)
            self.vstore_scale = _pad_to(self.vstore_scale, new_cap)
        except torch.cuda.OutOfMemoryError:
            # the corpus is at new_cap, the mask is not: drop every plane
            # so no route pairs mismatched shapes
            _log.warning("device grow %d -> %d rows ran out of device "
                         "memory; device planes dropped", self.cap, new_cap)
            self.vectors = self.active = self.vstore_scale = None
            self.vectors_lp = self.vectors_i8 = self.vscale = None
            self.vectors_i8c = self.cscale = None
            self._mask_cache.clear()
            self._fview_cache.clear()
            return False
        self.cap = new_cap
        try:
            self.vectors_lp = _pad_to(self.vectors_lp, new_cap)
        except torch.cuda.OutOfMemoryError:
            self.vectors_lp = None
        try:
            self.vectors_i8 = _pad_to(self.vectors_i8, new_cap)
            self.vscale = _pad_to(self.vscale, new_cap)
        except torch.cuda.OutOfMemoryError:
            self.vectors_i8 = self.vscale = None
        # the column-scaled mirror stays lazy: dropped, and its budget
        # re-gated at the new capacity, so ensure_i8c_mirror cannot build
        # an over-budget mirror later
        self.vectors_i8c = self.cscale = None
        if self.i8c_tier:
            budget, bpe = self._mirror_budget()
            self._i8c_budget_ok = self.cap * self.dim * bpe <= budget
        self._mask_cache.clear()
        self._fview_cache.clear()
        self.last_sync_mode = "grow"
        return True

    def full_upload(self, host_vectors: np.ndarray, active_np: np.ndarray) -> None:
        """Upload the whole corpus in STREAM_CHUNK_ROWS pieces, so the host
        never holds a padded copy; an int8/int4 store quantizes (and
        packs) each chunk on device, so its float32 form never exists
        there whole."""
        n = host_vectors.shape[0]
        cap = self._cap_with_headroom(n)
        buf = torch.zeros((cap, self.plane_cols), dtype=self._plane_dtype(),
                          device=self._device)
        scales = (torch.zeros((cap,), dtype=torch.float32, device=self._device)
                  if self.quantized else None)
        for start in range(0, n, self.STREAM_CHUNK_ROWS):
            rows = self._host_tensor(np.asarray(
                host_vectors[start:start + self.STREAM_CHUNK_ROWS], dtype=Float))
            end = start + rows.shape[0]
            if scales is not None:
                buf[start:end], scales[start:end] = self._quantize(rows)
            else:
                buf[start:end] = rows.to(buf.dtype)
        active = self._host_tensor(
            _pad_rows(np.asarray(active_np, dtype=bool), cap))
        self._commit(buf, scales, active, cap)

    def from_numpy_state(self, vectors: np.ndarray, active: np.ndarray,
                         vstore_scale: Optional[np.ndarray] = None) -> None:
        """Adopt host state exactly as given: a (n, dim) float corpus, or,
        with `vstore_scale`, an int8/int4 store's quantized plane and row
        scales as picovdb_tpu holds them. The test hook that hands both
        packages the same state."""
        if vstore_scale is not None:
            self.upload_prequantized(np.asarray(vectors), np.asarray(vstore_scale),
                                     np.asarray(active, dtype=bool))
        else:
            self.full_upload(np.asarray(vectors, dtype=Float),
                             np.asarray(active, dtype=bool))

    def upload_prequantized(self, plane: np.ndarray, scales: np.ndarray,
                            active_np: np.ndarray) -> None:
        """Build an int8/int4 corpus from a host quantized plane ((n, dim)
        int8, or (n, dim / 2) packed int4) and its (n,) row scales, e.g. a
        read-only memmap of a quantized checkpoint, one chunk at a time:
        host memory stays one chunk and no float32 corpus exists."""
        n = plane.shape[0]
        cols = self.plane_cols
        if not self.quantized:
            raise ValueError(
                "upload_prequantized requires int8/int4 storage; "
                f"this store is {self.storage_dtype!r}"
            )
        if plane.ndim != 2 or plane.shape[1] != cols:
            raise ValueError(
                f"quantized plane has shape {plane.shape}; expected "
                f"(*, {cols}) for {self.storage_dtype} at dim {self.dim}"
            )
        if scales.shape[0] != n:
            raise ValueError(f"{scales.shape[0]} scales for {n} plane rows")
        cap = self._cap_with_headroom(n)
        buf = torch.zeros((cap, cols), dtype=torch.int8, device=self._device)
        sc = torch.zeros((cap,), dtype=torch.float32, device=self._device)
        step = self.STREAM_CHUNK_ROWS
        for s in range(0, n, step):
            e = min(n, s + step)
            buf[s:e] = self._host_tensor(np.asarray(plane[s:e], dtype=np.int8))
            sc[s:e] = self._host_tensor(np.asarray(scales[s:e], dtype=np.float32))
        active = self._host_tensor(
            _pad_rows(np.asarray(active_np, dtype=bool), cap))
        self._commit(buf, sc, active, cap)

    def adopt(self, vectors_dev: torch.Tensor, n: int, normalize: bool = False,
              scales: Optional[torch.Tensor] = None,
              want_shadow: bool = False) -> Optional[np.ndarray]:
        """Adopt a (n, dim) tensor already on this store's device as the
        whole corpus (device-born ingestion: nothing crosses from the
        host). Normalization (optional), the storage-dtype cast or
        quantization, and the capacity pad run on device, chunk by chunk.

        With `scales` the input is pre-quantized: int8 rows, or packed
        (n, dim / 2) int4 rows in `quantize_rows_i4`'s layout, with their
        (n,) row scales. The input is not consumed (the JAX package
        donates it): when it already has the padded capacity, the storage
        dtype and a contiguous layout, the store takes it as its plane
        without a copy and the caller must not write to it afterwards;
        otherwise it is copied and stays the caller's.

        `want_shadow=True` returns the normalized float32 rows as a host
        array, fetched before the storage cast (the engine's `host_shadow`:
        authentic rows for the host-f64 rescore). Not available with
        `scales`, whose float32 form never existed. Returns None otherwise.
        """
        x = vectors_dev
        if x.device != self._device:
            raise ValueError(
                f"adopt expects a tensor on {self._device}; got {x.device}")
        shadow = None
        if want_shadow and scales is None:
            x = x.float()
            if normalize:
                x = normalize_on_device(x)
                normalize = False
            shadow = x.cpu().numpy().copy()
        cap = self._cap_with_headroom(n)
        active = torch.arange(cap, device=self._device) < n
        if self.quantized and scales is not None:
            if x.dtype != torch.int8 or x.shape != (n, self.plane_cols):
                raise ValueError(
                    f"pre-quantized {self.storage_dtype} rows must be int8 "
                    f"of shape ({n}, {self.plane_cols}); got {x.dtype} "
                    f"{tuple(x.shape)}")
            sc = scales.to(device=self._device, dtype=torch.float32)
            if cap != n or not x.is_contiguous():
                x, sc = _pad_to(x.contiguous(), cap), _pad_to(sc, cap)
            self._commit(x, sc.contiguous(), active, cap)
            return shadow
        if (not self.quantized and cap == n and not normalize
                and x.dtype == self._plane_dtype() and x.is_contiguous()):
            self._commit(x, None, active, cap)
            return shadow
        buf = torch.zeros((cap, self.plane_cols), dtype=self._plane_dtype(),
                          device=self._device)
        sc = (torch.zeros((cap,), dtype=torch.float32, device=self._device)
              if self.quantized else None)
        for s in range(0, n, self.STREAM_CHUNK_ROWS):
            e = min(n, s + self.STREAM_CHUNK_ROWS)
            rows = x[s:e]
            if normalize:
                rows = normalize_on_device(rows)
            if sc is not None:
                buf[s:e], sc[s:e] = self._quantize(rows)
            else:
                buf[s:e] = rows.to(buf.dtype)
        self._commit(buf, sc, active, cap)
        return shadow

    def _mirror_budget(self) -> tuple:
        """(device budget bytes, bytes/element across resident planes)."""
        budget = int(
            float(_os.getenv("PICOVDB_MIXED_BUDGET_GB", "0") or 0) * 2**30
        ) or self.MIXED_HBM_BUDGET
        # f32 corpus, bf16 mirror, int8 rows (+ 4/dim for the scales), and
        # the column-scaled int8 mirror whenever its tier is on, built or
        # not, exactly as the JAX package counts them
        bpe = (4 + (2 if self.mixed_precision else 0)
               + (1 if self.int8_tier else 0) + (1 if self.i8c_tier else 0))
        return budget, bpe

    def _refresh_lp_mirror(self) -> None:
        """(Re)build the bf16 and int8 selection mirrors on device (an
        int8/int4 store is its own selection tier: no mirrors). The
        column-scaled mirror is dropped and its budget re-gated; it is
        rebuilt by `ensure_i8c_mirror` at the first dispatch that routes
        to it."""
        budget, bpe = self._mirror_budget()
        fits = (not self.quantized and self.vectors is not None
                and self.cap * self.dim * bpe <= budget)
        self.vectors_lp = (self.vectors.to(torch.bfloat16)
                           if fits and self.mixed_precision else None)
        if fits and self.int8_tier:
            self.vectors_i8, self.vscale = quantize_rows_i8(self.vectors)
        else:
            self.vectors_i8 = self.vscale = None
        self.vectors_i8c = self.cscale = None
        self._i8c_budget_ok = (not self.quantized and self.i8c_tier
                               and self.cap * self.dim * bpe <= budget)

    def ensure_i8c_mirror(self) -> bool:
        """Build the column-scaled int8 mirror on demand; True if usable."""
        if self.vectors_i8c is not None:
            return True
        if not self.i8c_tier or self.vectors is None or not self._i8c_budget_ok:
            return False
        v8, cs = quantize_cols_i8(self.vectors)
        # scales first: a concurrent reader that sees the mirror sees them
        self.cscale = cs
        self.vectors_i8c = v8
        return True

    def scatter(self, idxs: np.ndarray, rows: Optional[np.ndarray],
                active_vals: np.ndarray) -> None:
        """Apply a small mutation set in place.

        `rows` may be None for delete-only updates: the mask excludes
        deleted slots from scoring, so their rows can stay stale. An
        int8/int4 store quantizes the rows on device with their own row
        scales, so mutations are exact per row."""
        if self.vectors is None:
            raise RuntimeError("scatter before any upload")
        if idxs.shape[0] == 0:
            return
        dev_idx = self._host_tensor(np.asarray(idxs, dtype=np.int64))
        if rows is not None:
            f_rows = self._host_tensor(np.asarray(rows, dtype=Float))
            if self.quantized:
                q_rows, q_scale = self._quantize(f_rows)
                self.vectors.index_copy_(0, dev_idx, q_rows)
                self.vstore_scale.index_copy_(0, dev_idx, q_scale)
            else:
                dev_rows = f_rows.to(self.vectors.dtype)
                self.vectors.index_copy_(0, dev_idx, dev_rows)
                if self.vectors_lp is not None:
                    self.vectors_lp.index_copy_(0, dev_idx,
                                                dev_rows.to(torch.bfloat16))
                if self.vectors_i8 is not None:
                    q_rows, q_scale = quantize_rows_i8(dev_rows)
                    self.vectors_i8.index_copy_(0, dev_idx, q_rows)
                    self.vscale.index_copy_(0, dev_idx, q_scale)
                # column scales are corpus-global: a new row can exceed a
                # column max, so the mirror is dropped and requantized at
                # the next dispatch that routes to it
                self.vectors_i8c = self.cscale = None
        self.active.index_copy_(
            0, dev_idx, self._host_tensor(np.asarray(active_vals, dtype=bool)))
        self._mask_cache.clear()
        self._fview_cache.clear()
        self.last_sync_mode = "scatter"

    # -- reading the store back ----------------------------------------------

    def fetch_rows(self, idxs: np.ndarray) -> np.ndarray:
        """Dequantized float32 host rows by slot id: one device gather and
        one transfer per FETCH_CHUNK_ROWS chunk. The transfer carries the
        storage bytes (packed int4 rows: 1/8 of float32) and the dequant
        runs on the host, int4 through `unpack_i4_np_into` (no (n, dim)
        integer temporary)."""
        if self.vectors is None:
            raise RuntimeError("fetch_rows before any upload")
        idxs = np.asarray(idxs, dtype=np.int64)
        m = idxs.shape[0]
        out = np.empty((m, self.dim), dtype=np.float32)
        step = self.FETCH_CHUNK_ROWS
        for s in range(0, m, step):
            e = min(m, s + step)
            ci = self._host_tensor(idxs[s:e])
            raw = self.vectors[ci]
            if self.storage_dtype == "bfloat16":
                raw = raw.float()
            raw = raw.cpu().numpy()
            if self.storage_dtype == "int4":
                unpack_i4_np_into(raw, out[s:e])
            else:
                out[s:e] = raw
            if self.quantized:
                out[s:e] *= self.vstore_scale[ci].cpu().numpy()[:, None]
        return out

    def iter_store_chunks(self, n: int, chunk: Optional[int] = None):
        """Yield the first n rows of an int8/int4 store as host
        (quantized rows, scales) chunks: the quantized checkpoint writer
        streams them to disk, so host memory stays one chunk."""
        if self.vectors is None or self.vstore_scale is None:
            raise RuntimeError(
                "iter_store_chunks requires a quantized device store")
        step = chunk or self.STREAM_CHUNK_ROWS
        for s in range(0, n, step):
            e = min(n, s + step)
            yield (self.vectors[s:e].cpu().numpy(),
                   self.vstore_scale[s:e].cpu().numpy())

    # -- query -----------------------------------------------------------------

    @staticmethod
    def pack_results(vals, idxs):
        """(Q, k) f32 + (Q, k) i32 -> one (Q, 2k) int32 tensor (scores
        travel bitcast in the first k columns)."""
        return torch.cat([vals.view(torch.int32), idxs], dim=1)

    def snapshot(self):
        """Handles to the current corpus tensors (vectors, active, row
        scales or None). Unlike JAX arrays these are mutated in place by
        `scatter`, so a re-dispatch through them (the engine's exact
        retry) must run under the engine's read lock, which the port's
        engine holds through its retries."""
        return (self.vectors, self.active, self.vstore_scale)

    def _query_tensor(self, qnorm) -> torch.Tensor:
        """Queries as a float32 tensor on the device (the int16 / f16 /
        bf16 wires widen here; normalization on device divides any
        per-row scale back out)."""
        if isinstance(qnorm, np.ndarray):
            qnorm = torch.from_numpy(np.ascontiguousarray(qnorm))
        return qnorm.to(device=self._device, dtype=torch.float32)

    def query_exact_snapshot(self, snap, qnorm, k):
        """Exact masked top-k against a captured `snapshot()` (blocking);
        host (vals, idxs) of (Q, min(k, cap)). On the card it streams
        through K3/K4/K6 (k + 4 <= 1024), never a dense (Q, cap) score
        matrix; int8/int4 stores rank their dequantized rows."""
        vectors, active, vscale = snap
        q = self._query_tensor(qnorm)
        k_eff = min(k, vectors.shape[0])
        on_card = self._device.type == "cuda"
        if vscale is not None and self.storage_dtype == "int4":
            fn4 = (make_fused_topk_i4(k_eff) if on_card
                   else make_exact_topk_i4r(k_eff))
            vals, idxs = fn4(q, vectors, vscale, active)
        elif vscale is not None:
            if on_card and k_eff + 4 <= 1024:
                fn8 = make_fused_topk_i8(k_eff, rescore_dequant=True,
                                         tie_scale=0.0)
                vals, idxs = fn8(q, vectors, vscale, vectors, active)
            else:
                vals, idxs = make_exact_topk_i8r(k_eff)(q, vectors, vscale,
                                                        active)
        elif on_card and k_eff + 4 <= 1024:
            vals, idxs = make_fused_topk(k_eff, self.compute_dtype)(
                q, vectors, active)
        else:
            vals, idxs = make_exact_topk(k_eff, self.compute_dtype)(
                q, vectors, active)
        return vals.cpu().numpy(), idxs.cpu().numpy()

    def query(self, qnorm, k: int, filter_mask: Optional[np.ndarray] = None,
              force_exact: bool = False, mask_key=None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Masked top-k over the device corpus (blocking); host NumPy
        (values, indices) of shape (Q, min(k, cap)), -inf padded."""
        vals, idxs, num_q, k_eff = self.query_async(
            qnorm, k, filter_mask, force_exact=force_exact, mask_key=mask_key)
        return (vals.cpu().numpy()[:num_q, :k_eff],
                idxs.cpu().numpy()[:num_q, :k_eff])

    def _mask_tensor(self, filter_mask, mask_key):
        if filter_mask is None:
            return self.active
        cached = self._mask_cache.get(mask_key) if mask_key is not None else None
        if cached is not None:
            return cached
        m = self._host_tensor(
            _pad_rows(np.ascontiguousarray(filter_mask, dtype=bool), self.cap))
        if mask_key is not None:
            if len(self._mask_cache) >= self.MASK_CACHE_MAX:
                try:  # concurrent readers may evict the same entry
                    self._mask_cache.pop(next(iter(self._mask_cache)), None)
                except (StopIteration, RuntimeError):
                    pass
            self._mask_cache[mask_key] = m
        return m

    def _filter_view(self, mask_key, filter_mask):
        """Get or build the compacted view of a filter: (slots (capf,)
        int64 corpus slot per view row, view (capf, dim) bf16 rows gathered
        on device from the mirror, active (capf,) bool), or None when the
        survivors are too few for segmax to pay (< SEGMAX_MIN_CAP) or the
        view would pass PICOVDB_FVIEW_BUDGET_GB (default 4).

        Compaction makes segmax sound under a filter: a clustered filter
        can pack many true winners into one 128-row segment of the full
        corpus, but in the view the survivors spread over its segments
        as an unfiltered corpus of n_f rows does.

        Views and refusals (None) are cached per mask_key: every chunk of
        a filtered batch asks again. Both take the same bounded eviction
        (refusals leave first), so rotating refused filters cannot grow
        the cache (picovdb_tpu caches refusals without evicting)."""
        cached = self._fview_cache.get(mask_key, _FVIEW_MISS)
        if cached is not _FVIEW_MISS:
            return cached
        n_f = int(filter_mask.sum())
        out = None
        if n_f >= self.SEGMAX_MIN_CAP and self._fview_budget_ok(n_f):
            rows = np.nonzero(filter_mask)[0].astype(np.int64)
            capf = round_up(n_f, ROW_PAD)
            slots = self._host_tensor(_pad_rows(rows, capf))
            out = (slots, self.vectors_lp[slots],
                   torch.arange(capf, device=self._device) < n_f)
        cache = self._fview_cache
        while len(cache) >= self.FVIEW_CACHE_MAX:
            try:
                snap = list(cache.items())
                victim = next((key for key, v in snap if v is None), snap[0][0])
                cache.pop(victim, None)
            except (IndexError, RuntimeError):
                break
        cache[mask_key] = out
        return out

    def _fview_budget_ok(self, n_f: int) -> bool:
        try:
            budget_gb = float(_os.getenv("PICOVDB_FVIEW_BUDGET_GB", "4") or 4)
        except ValueError:
            budget_gb = 4.0
        return n_f * self.dim * 2.0 <= budget_gb * 2**30

    def _stream_name(self, num_q: int) -> bool:
        # stream iff the padded batch spans more than one 256-query tile,
        # exactly the JAX package's route choice
        return num_q > 256 if self.segmax_stream is None else self.segmax_stream

    def query_async(self, qnorm, k: int,
                    filter_mask: Optional[np.ndarray] = None,
                    force_exact: bool = False, mask_key=None):
        """Dispatch a masked top-k; returns (vals, idxs, num_q, k_eff) as
        device tensors without waiting for the device.

        `qnorm` may be raw (normalization runs on device) and may already
        be a tensor on the device, in which case nothing crosses from the
        host. Routes are decided on the unpadded batch, as the JAX package
        decides them (it pads queries for its kernels' tiles; these
        kernels take any Q)."""
        if self.vectors is None or self.cap == 0:
            raise RuntimeError("query before any upload")
        num_q = qnorm.shape[0]
        k_eff = min(k, self.cap)
        i8s = self.storage_dtype == "int8"
        i4s = self.storage_dtype == "int4"
        unfiltered = filter_mask is None and not force_exact
        segmax_ok = (
            unfiltered
            and self.scan_mode in ("auto", "mixed")
            and k_eff <= self.SEGMAX_MAX_K
            and self.cap >= self.SEGMAX_MIN_CAP
            and (num_q > self.SMALL_Q_XLA or self.scan_mode == "mixed")
        )
        small_auto = (unfiltered and self.scan_mode == "auto"
                      and num_q <= self.SMALL_Q_XLA and k_eff + 4 <= 16)
        i8s_segmax = i8s and segmax_ok
        i8s_smallq = i8s and not i8s_segmax and small_auto
        use_segmax = segmax_ok and (
            self.vectors_lp is not None
            or (self.segmax_i8 and self.vectors_i8 is not None)
            or (self.segmax_i8c and self._i8c_budget_ok))
        fview = None
        if (filter_mask is not None and mask_key is not None
                and not force_exact and self.vectors_lp is not None
                and self.scan_mode in ("auto", "mixed")
                and k_eff <= self.SEGMAX_MAX_K and num_q > self.SMALL_Q_XLA):
            fview = self._filter_view(mask_key, filter_mask)
        # small batches take the narrowest mirror: the column-scaled int8
        # ladder when opted in (guard 6), the per-row int8 ladder, bf16
        small_q_i8c = (self.smallq_i8c and self._i8c_budget_ok and unfiltered
                       and self.scan_mode == "auto"
                       and num_q <= self.SMALL_Q_XLA and k_eff + 6 <= 16)
        small_q_i8 = (small_auto and not small_q_i8c
                      and self.vectors_i8 is not None)
        small_q_mixed = (small_auto and not small_q_i8 and not small_q_i8c
                         and self.vectors_lp is not None)
        small_q_xla = (not i8s and not i4s and self.scan_mode == "auto"
                       and not use_segmax and not small_q_i8
                       and not small_q_i8c and not small_q_mixed
                       and num_q <= self.SMALL_Q_XLA)
        q = self._query_tensor(qnorm)
        # the compacted view carries its own mask: the filter never ships
        mask = None if fview is not None else self._mask_tensor(filter_mask,
                                                                mask_key)
        v, vs = self.vectors, self.vstore_scale
        f32, lp = self.vectors, self.vectors_lp
        if i8s_segmax:
            # tie_scale=0 on every int8/int4 storage route: no finer tier
            # exists for a crowding mark to retry into (the exact retry
            # ranks the same quantized rows); segmax underfill still
            # retries
            vals, idxs = make_segmax_topk_i8(
                k_eff, rescore_dequant=True, tie_scale=0.0)(q, v, vs, v, mask)
            self.last_strategy = ("segmax_i8stor_stream"
                                  if self._stream_name(num_q)
                                  else "segmax_i8stor")
        elif i8s_smallq or (i8s and self.use_pallas and k_eff + 4 <= 1024):
            # small batches, and on the kernel path every filtered, wide-k
            # or retried int8 batch: K3 streams the corpus, never a (Q,
            # cap) score matrix
            vals, idxs = make_fused_topk_i8(
                k_eff, rescore_dequant=True, tie_scale=0.0)(q, v, vs, v, mask)
            self.last_strategy = ("i8stor_fused_smallq" if i8s_smallq
                                  else "i8stor_fused_exact")
        elif i8s:
            vals, idxs = make_exact_topk_i8r(k_eff)(q, v, vs, mask)
            self.last_strategy = "i8stor_xla"
        elif i4s and self.use_pallas:
            # every int4 route: K6 over the packed rows (filter honored)
            vals, idxs = make_fused_topk_i4(k_eff)(q, v, vs, mask)
            self.last_strategy = "i4stor_fused"
        elif i4s:
            vals, idxs = make_exact_topk_i4r(k_eff)(q, v, vs, mask)
            self.last_strategy = "i4stor_xla"
        elif fview is not None:
            # tie_scale=0: the engine's snapshot retry re-serves without
            # the filter, so filtered results must never carry a mark
            slots, view, view_active = fview
            vals, idxs = make_segmax_topk(k_eff, tie_scale=0.0)(
                q, view, f32, view_active, slots)
            self.last_strategy = ("fview_segmax_stream"
                                  if self._stream_name(num_q)
                                  else "fview_segmax")
        elif use_segmax and self.segmax_i8c and self.ensure_i8c_mirror():
            vals, idxs = make_segmax_topk_i8c(k_eff)(
                q, self.vectors_i8c, self.cscale, f32, mask)
            self.last_strategy = ("segmax_i8c_stream"
                                  if self._stream_name(num_q)
                                  else "segmax_i8c")
        elif use_segmax and self.segmax_i8 and self.vectors_i8 is not None:
            vals, idxs = make_segmax_topk_i8(k_eff)(
                q, self.vectors_i8, self.vscale, f32, mask)
            self.last_strategy = ("segmax_i8_stream"
                                  if self._stream_name(num_q)
                                  else "segmax_i8")
        elif use_segmax:
            vals, idxs = make_segmax_topk(k_eff)(q, lp, f32, mask)
            self.last_strategy = ("segmax_mixed_stream"
                                  if self._stream_name(num_q)
                                  else "segmax_mixed")
        elif small_q_i8c and self.ensure_i8c_mirror():
            vals, idxs = make_fused_topk_i8c(k_eff)(
                q, self.vectors_i8c, self.cscale, f32, mask)
            self.last_strategy = "i8c_fused_smallq"
        elif small_q_i8:
            i8_fn = make_fused_topk_i8(k_eff)
            vals, idxs = i8_fn(q, self.vectors_i8, self.vscale, f32, mask)
            self.last_strategy = "i8_fused_smallq"
        elif small_q_mixed:
            vals, idxs = make_mixed_fused_topk(k_eff)(q, lp, f32, mask)
            self.last_strategy = "mixed_fused_smallq"
        elif self.scan_mode == "approx":
            # the TPU's approximate top-k maps to the exact top-k_sel of
            # the dense product + the exact rescore (what JAX runs off-TPU)
            vals, idxs = make_approx_topk(k_eff, self.compute_dtype)(
                q, f32, mask)
            self.last_strategy = "xla_approx"
        elif (self.scan_mode == "auto" and self.use_pallas
              and not small_q_xla and not force_exact and lp is not None):
            # Batches segmax declined (filtered, or k past SEGMAX_MAX_K):
            # the exact selection over the bf16 mirror is safe under any
            # clustering. The crowding mark applies only unfiltered: the
            # engine's exact retry re-serves without the filter.
            mfb_fn = make_mixed_fused_topk(
                k_eff, tie_scale=0.0 if filter_mask is not None else None)
            vals, idxs = mfb_fn(q, lp, f32, mask)
            self.last_strategy = ("mixed_fused_batch_filtered"
                                  if filter_mask is not None
                                  else "mixed_fused_batch")
        elif (self.scan_mode == "fused"
              or (self.scan_mode == "auto" and self.use_pallas
                  and not small_q_xla)):
            vals, idxs = make_fused_topk(k_eff, self.compute_dtype)(q, f32, mask)
            self.last_strategy = "pallas_fused"
        else:
            vals, idxs = make_exact_topk(k_eff, self.compute_dtype)(q, f32, mask)
            self.last_strategy = "xla_topk"
        return vals, idxs, num_q, k_eff

    def query_serial_loop(self, queries, k: int):
        """Run M independent Q=1 queries one after another through the
        small-batch route (int8 storage, the opted-in column-scaled or the
        per-row int8 mirror when present, else the bf16 ladder, else the
        int4 / exact scan); host ((M, k) f32 scores, (M, k) int32 slot
        ids). No crowding mark: no retry wraps this lane."""
        if self.vectors is None:
            raise ValueError(
                "empty device mirror; sync first (or use "
                "PicoVectorDB.query_serial_loop, which does)"
            )
        k_eff = min(k, self.cap)
        v, vs, act = self.vectors, self.vstore_scale, self.active
        if self.storage_dtype == "int8" and k_eff + 4 <= 16:
            f8s = make_fused_topk_i8(k_eff, rescore_dequant=True, tie_scale=0.0)
            inner = lambda q: f8s(q, v, vs, v, act)  # noqa: E731
            self.last_strategy = "i8stor_fused_smallq_loop"
        elif (self.smallq_i8c and k_eff + 6 <= 16
              and self.ensure_i8c_mirror()):
            f8c = make_fused_topk_i8c(k_eff, tie_scale=0.0)
            inner = lambda q: f8c(q, self.vectors_i8c,  # noqa: E731
                                  self.cscale, v, act)
            self.last_strategy = "i8c_fused_smallq_loop"
        elif self.vectors_i8 is not None and k_eff + 4 <= 16:
            f8 = make_fused_topk_i8(k_eff, tie_scale=0.0)
            inner = lambda q: f8(q, self.vectors_i8, self.vscale,  # noqa: E731
                                 v, act)
            self.last_strategy = "i8_fused_smallq_loop"
        elif self.vectors_lp is not None and k_eff + 4 <= 16:
            fm = make_mixed_fused_topk(k_eff, tie_scale=0.0)
            inner = lambda q: fm(q, self.vectors_lp, v, act)  # noqa: E731
            self.last_strategy = "mixed_fused_smallq_loop"
        elif self.storage_dtype == "int4":
            f4 = (make_fused_topk_i4(k_eff) if self.use_pallas
                  else make_exact_topk_i4r(k_eff))
            inner = lambda q: f4(q, v, vs, act)  # noqa: E731
            self.last_strategy = ("i4stor_fused_loop" if self.use_pallas
                                  else "i4stor_xla_loop")
        elif self.storage_dtype == "int8":
            x8 = make_exact_topk_i8r(k_eff)
            inner = lambda q: x8(q, v, vs, act)  # noqa: E731
            self.last_strategy = "i8stor_xla_loop"
        else:
            fx = make_exact_topk(k_eff, self.compute_dtype)
            inner = lambda q: fx(q, v, act)  # noqa: E731
            self.last_strategy = "xla_topk_loop"
        qs = self._query_tensor(queries)
        vals = torch.empty((qs.shape[0], k_eff), dtype=torch.float32,
                           device=self._device)
        idxs = torch.empty((qs.shape[0], k_eff), dtype=torch.int32,
                           device=self._device)
        for i in range(qs.shape[0]):
            vals[i], idxs[i] = inner(qs[i:i + 1])
        return vals.cpu().numpy(), idxs.cpu().numpy()
