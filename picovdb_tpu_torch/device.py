"""Device-resident corpus mirror and query dispatch (PyTorch).

Counterpart of picovdb_tpu/device.py for one device and float32 storage:
the corpus lives on the device as a padded (cap, dim) float32 tensor plus
a boolean active mask, next to two selection mirrors derived on device (a
bfloat16 copy for the batch segmax tier, and per-row int8 + scales for the
small-batch tier). Mutations are applied in place (`index_copy_`), which is
what the JAX package's buffer donation approximated.

Host state (ids, docs, free slots) stays authoritative in
`picovdb_tpu_torch.engine`; the mirror is synchronized lazily before a
query: small mutation sets scatter, large ones re-upload.

Route names (`last_strategy`) are the JAX package's, so the two packages'
dispatch decisions can be compared one to one.
"""

from __future__ import annotations

import os as _os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import Float, ROW_PAD
from .ops.exact import make_exact_topk
from .ops.scan import (
    make_fused_topk,
    make_fused_topk_i8,
    make_mixed_fused_topk,
    make_segmax_topk,
    quantize_rows_i8,
)
from .utils import round_up


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


def default_device() -> torch.device:
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


class DeviceIndex:
    """Device-resident (cap, dim) float32 corpus + active mask with routed
    masked top-k dispatch (single device)."""

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
        if self.storage_dtype != "float32":
            if self.storage_dtype not in ("bfloat16", "int8", "int4"):
                raise ValueError(
                    "storage_dtype must be one of float32/bfloat16/int8/int4;"
                    f" got {self.storage_dtype!r}"
                )
            raise _not_in_slice(f"storage_dtype={self.storage_dtype!r}",
                                "item 6, storage tiers")
        if scan_mode not in ("auto", "mixed", "fused", "approx", "xla"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if scan_mode == "approx":
            raise _not_in_slice('scan_mode="approx"', "item 9, opt-in tiers")
        for env in ("PICOVDB_SEGMAX_I8", "PICOVDB_INT8C_TIER",
                    "PICOVDB_SEGMAX_I8C", "PICOVDB_SMALLQ_I8C"):
            if _os.getenv(env, "") not in ("", "0", "false", "False", "auto"):
                raise _not_in_slice(env, "item 9, opt-in tiers")
        self.dim = dim
        self.cap = 0
        self.vectors: Optional[torch.Tensor] = None  # (cap, dim) f32
        self.vectors_lp: Optional[torch.Tensor] = None  # bf16 scan mirror
        self.vectors_i8: Optional[torch.Tensor] = None  # int8 mirror
        self.vscale: Optional[torch.Tensor] = None  # (cap,) its row scales
        self.active: Optional[torch.Tensor] = None  # (cap,) bool
        self.compute_dtype = compute_dtype
        self._device = (torch.device(device) if device is not None
                        else default_device())
        on_card = self._device.type == "cuda"
        # The hand-written kernels, the bf16 mirror and the int8 mirror
        # default on for the card and off elsewhere, as the JAX package
        # turns them on for its TPU.
        if use_pallas is None:
            use_pallas = on_card
        self.use_pallas = use_pallas
        self.scan_mode = scan_mode
        if mixed_precision is None:
            mixed_precision = on_card or scan_mode == "mixed"
        self.mixed_precision = bool(mixed_precision)
        if int8_tier is None:
            env = _os.getenv("PICOVDB_INT8_TIER")
            if env is not None:
                int8_tier = env not in ("0", "false", "False", "")
            else:
                int8_tier = on_card
        self.int8_tier = bool(int8_tier)
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

    # f32 corpus + mirrors = 7 bytes/row/dim; above this the mirrors are
    # skipped. Kept at the JAX package's value (PICOVDB_MIXED_BUDGET_GB
    # overrides) so both packages route alike; deriving it from
    # torch.cuda.mem_get_info is a ROADMAP item.
    MIXED_HBM_BUDGET = 12 * 2**30

    def _host_tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)

    def grow(self, n: int) -> bool:
        """Grow padded capacity on device to hold `n` rows (device copies,
        no host traffic), with max(ROW_PAD, n/64) rows of slack."""
        if self.vectors is None:
            return False
        new_cap = max(self.cap, self._padded_cap(n + max(ROW_PAD, n // 64)))
        if new_cap <= self.cap:
            return True

        def pad_rows(t):
            if t is None:
                return None
            out = t.new_zeros((new_cap,) + tuple(t.shape[1:]))
            out[: t.shape[0]] = t
            return out

        self.vectors = pad_rows(self.vectors)
        self.active = pad_rows(self.active)
        self.vectors_lp = pad_rows(self.vectors_lp)
        self.vectors_i8 = pad_rows(self.vectors_i8)
        self.vscale = pad_rows(self.vscale)
        self.cap = new_cap
        self._mask_cache.clear()
        self.last_sync_mode = "grow"
        return True

    def full_upload(self, host_vectors: np.ndarray, active_np: np.ndarray) -> None:
        """Upload the whole corpus, growing padded capacity as needed.
        Large corpora stream in STREAM_CHUNK_ROWS pieces, so the host never
        holds a padded copy."""
        n = host_vectors.shape[0]
        cap = self._cap_with_headroom(n)
        buf = torch.zeros((cap, self.dim), dtype=torch.float32,
                          device=self._device)
        for start in range(0, n, self.STREAM_CHUNK_ROWS):
            rows = np.asarray(host_vectors[start:start + self.STREAM_CHUNK_ROWS],
                              dtype=Float)
            buf[start:start + rows.shape[0]] = self._host_tensor(rows)
        self.vectors = buf
        self.active = self._host_tensor(
            _pad_rows(np.asarray(active_np, dtype=bool), cap))
        self.cap = cap
        self._refresh_lp_mirror()
        self._mask_cache.clear()
        self.last_sync_mode = "full"

    def from_numpy_state(self, vectors: np.ndarray, active: np.ndarray) -> None:
        """Adopt a host (n, dim) corpus and (n,) active mask exactly as
        given: the test hook that hands both packages the same state."""
        self.full_upload(np.asarray(vectors, dtype=Float),
                         np.asarray(active, dtype=bool))

    def adopt(self, *args, **kwargs):
        raise _not_in_slice("DeviceIndex.adopt (device-born ingestion)",
                            "item 6, storage tiers and serving extras")

    def _mirror_budget(self) -> tuple:
        """(device budget bytes, bytes/element across resident planes)."""
        budget = int(
            float(_os.getenv("PICOVDB_MIXED_BUDGET_GB", "0") or 0) * 2**30
        ) or self.MIXED_HBM_BUDGET
        bpe = 4 + (2 if self.mixed_precision else 0) + (1 if self.int8_tier else 0)
        return budget, bpe

    def _refresh_lp_mirror(self) -> None:
        """(Re)build the bf16 and int8 selection mirrors on device."""
        budget, bpe = self._mirror_budget()
        fits = self.vectors is not None and self.cap * self.dim * bpe <= budget
        self.vectors_lp = (self.vectors.to(torch.bfloat16)
                           if fits and self.mixed_precision else None)
        if fits and self.int8_tier:
            self.vectors_i8, self.vscale = quantize_rows_i8(self.vectors)
        else:
            self.vectors_i8 = self.vscale = None

    def scatter(self, idxs: np.ndarray, rows: Optional[np.ndarray],
                active_vals: np.ndarray) -> None:
        """Apply a small mutation set in place.

        `rows` may be None for delete-only updates: the mask excludes
        deleted slots from scoring, so their rows can stay stale."""
        if self.vectors is None:
            raise RuntimeError("scatter before any upload")
        if idxs.shape[0] == 0:
            return
        dev_idx = self._host_tensor(np.asarray(idxs, dtype=np.int64))
        if rows is not None:
            dev_rows = self._host_tensor(np.asarray(rows, dtype=Float))
            self.vectors.index_copy_(0, dev_idx, dev_rows)
            if self.vectors_lp is not None:
                self.vectors_lp.index_copy_(0, dev_idx,
                                            dev_rows.to(torch.bfloat16))
            if self.vectors_i8 is not None:
                q_rows, q_scale = quantize_rows_i8(dev_rows)
                self.vectors_i8.index_copy_(0, dev_idx, q_rows)
                self.vscale.index_copy_(0, dev_idx, q_scale)
        self.active.index_copy_(
            0, dev_idx, self._host_tensor(np.asarray(active_vals, dtype=bool)))
        self._mask_cache.clear()
        self.last_sync_mode = "scatter"

    # -- query -----------------------------------------------------------------

    @staticmethod
    def pack_results(vals, idxs):
        """(Q, k) f32 + (Q, k) i32 -> one (Q, 2k) int32 tensor (scores
        travel bitcast in the first k columns)."""
        return torch.cat([vals.view(torch.int32), idxs], dim=1)

    def snapshot(self):
        """Handles to the current corpus tensors. Unlike JAX arrays these
        are mutated in place by `scatter`, so a re-dispatch through them
        (the engine's exact retry) must run under the engine's read lock,
        which the port's engine holds through its retries."""
        return (self.vectors, self.active)

    def _query_tensor(self, qnorm) -> torch.Tensor:
        """Queries as a float32 tensor on the device (the int16 / f16 /
        bf16 wires widen here; normalization on device divides any
        per-row scale back out)."""
        if isinstance(qnorm, np.ndarray):
            qnorm = torch.from_numpy(np.ascontiguousarray(qnorm))
        return qnorm.to(device=self._device, dtype=torch.float32)

    def query_exact_snapshot(self, snap, qnorm, k):
        """Exact masked top-k against a captured `snapshot()` (blocking);
        host (vals, idxs) of (Q, min(k, cap)). Streams through K4 for
        k + 4 <= 1024 on the card, never a dense (Q, cap) score matrix."""
        vectors, active = snap
        q = self._query_tensor(qnorm)
        k_eff = min(k, vectors.shape[0])
        if self._device.type == "cuda" and k_eff + 4 <= 1024:
            fn = make_fused_topk(k_eff, self.compute_dtype)
        else:
            fn = make_exact_topk(k_eff, self.compute_dtype)
        vals, idxs = fn(q, vectors, active)
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

    def query_async(self, qnorm, k: int,
                    filter_mask: Optional[np.ndarray] = None,
                    force_exact: bool = False, mask_key=None):
        """Dispatch a masked top-k; returns (vals, idxs, num_q, k_eff) as
        device tensors without waiting for the device.

        `qnorm` may be raw (normalization runs on device) and may already
        be a tensor on the device, in which case nothing crosses from the
        host. The compacted filter view of the JAX package (route
        `fview_segmax`) is not ported yet: filtered batches take the
        routes that package takes with its view refused."""
        if self.vectors is None or self.cap == 0:
            raise RuntimeError("query before any upload")
        num_q = qnorm.shape[0]
        k_eff = min(k, self.cap)
        unfiltered = filter_mask is None and not force_exact
        use_segmax = (
            self.vectors_lp is not None
            and unfiltered
            and self.scan_mode in ("auto", "mixed")
            and k_eff <= self.SEGMAX_MAX_K
            and self.cap >= self.SEGMAX_MIN_CAP
            and (num_q > self.SMALL_Q_XLA or self.scan_mode == "mixed")
        )
        small_auto = (unfiltered and self.scan_mode == "auto"
                      and num_q <= self.SMALL_Q_XLA and k_eff + 4 <= 16)
        small_q_i8 = small_auto and self.vectors_i8 is not None
        small_q_mixed = (small_auto and not small_q_i8
                         and self.vectors_lp is not None)
        small_q_xla = (self.scan_mode == "auto" and not use_segmax
                       and not small_q_i8 and not small_q_mixed
                       and num_q <= self.SMALL_Q_XLA)
        q = self._query_tensor(qnorm)
        mask = self._mask_tensor(filter_mask, mask_key)
        f32, lp = self.vectors, self.vectors_lp
        if use_segmax:
            # stream iff the padded batch spans more than one 256-query
            # tile, exactly the JAX package's route choice
            stream = (num_q > 256 if self.segmax_stream is None
                      else self.segmax_stream)
            seg_fn = make_segmax_topk(k_eff)
            vals, idxs = seg_fn(q, lp, f32, mask)
            self.last_strategy = ("segmax_mixed_stream" if stream
                                  else "segmax_mixed")
        elif small_q_i8:
            i8_fn = make_fused_topk_i8(k_eff)
            vals, idxs = i8_fn(q, self.vectors_i8, self.vscale, f32, mask)
            self.last_strategy = "i8_fused_smallq"
        elif small_q_mixed:
            vals, idxs = make_mixed_fused_topk(k_eff)(q, lp, f32, mask)
            self.last_strategy = "mixed_fused_smallq"
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
        small-batch route (int8 mirror when present, else the bf16 ladder,
        else the exact scan); host ((M, k) f32 exact scores, (M, k) int32
        slot ids). No crowding mark: no retry wraps this lane."""
        if self.vectors is None:
            raise ValueError(
                "empty device mirror; sync first (or use "
                "PicoVectorDB.query_serial_loop, which does)"
            )
        k_eff = min(k, self.cap)
        if self.vectors_i8 is not None and k_eff + 4 <= 16:
            f8 = make_fused_topk_i8(k_eff, tie_scale=0.0)
            inner = lambda q: f8(q, self.vectors_i8, self.vscale,  # noqa: E731
                                 self.vectors, self.active)
            self.last_strategy = "i8_fused_smallq_loop"
        elif self.vectors_lp is not None and k_eff + 4 <= 16:
            fm = make_mixed_fused_topk(k_eff, tie_scale=0.0)
            inner = lambda q: fm(q, self.vectors_lp,  # noqa: E731
                                 self.vectors, self.active)
            self.last_strategy = "mixed_fused_smallq_loop"
        else:
            fx = make_exact_topk(k_eff, self.compute_dtype)
            inner = lambda q: fx(q, self.vectors, self.active)  # noqa: E731
            self.last_strategy = "xla_topk_loop"
        qs = self._query_tensor(queries)
        vals = torch.empty((qs.shape[0], k_eff), dtype=torch.float32,
                           device=self._device)
        idxs = torch.empty((qs.shape[0], k_eff), dtype=torch.int32,
                           device=self._device)
        for i in range(qs.shape[0]):
            vals[i], idxs[i] = inner(qs[i:i + 1])
        return vals.cpu().numpy(), idxs.cpu().numpy()
