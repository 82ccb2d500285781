"""Persistence: atomic JSON+npy checkpoints, byte-compatible with the reference.

File layout per store (reference: picovdb/pico_vdb.py:42-51, 330-393):
  <base>.ids.json   — JSON list of ids (None for never-used slots)
  <base>.vecs.npy   — (size, dim) float32 matrix
  <base>.meta.json  — {"embedding_dim", "data": [docs], "additional_data": {}}
  <base>.vecs.npy.ivf.npz — optional ANN sidecar (this framework's IVF tier,
                            counterpart of the reference's .faiss sidecar)

Saves are atomic: tmp files + os.replace, with straggler cleanup on failure
(reference: picovdb/pico_vdb.py:342-393). Memmap stores flush in place
instead of rewriting the vectors file (the vectors file *is* the store); the
reference's np.save-over-memmap would both copy the whole corpus and write an
npy header the reference's own raw-memmap loader cannot skip, so here memmap
files are proper .npy files handled via np.lib.format.open_memmap, with a
raw-memmap fallback for headerless files.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

import numpy as np

from .constants import Float
from .utils import (
    ann_path, ids_path, meta_path, round_up, vecs_path, to_c_f32,
)

logger = logging.getLogger("picovdb_tpu_torch")

_NPY_MAGIC = b"\x93NUMPY"


def qvecs_path(base: str) -> str:
    """Quantized plane: (n, dim) int8 rows, or (n, dim//2) packed int4."""
    return f"{base}.vecs.q.npy"


def qscale_path(base: str) -> str:
    return f"{base}.vecs.qscale.npy"


def qinfo_path(base: str) -> str:
    return f"{base}.vecs.q.json"


def overlay_path(base: str) -> str:
    return f"{base}.vecs.overlay.npz"


def exists(base: str) -> bool:
    if not os.path.exists(ids_path(base)):
        return False
    return (
        os.path.exists(vecs_path(base))
        or os.path.exists(qvecs_path(base))
        or bool(find_shards(base))
    )


def load_ids(base: str) -> list:
    with open(ids_path(base), "r", encoding="utf-8") as f:
        return json.load(f)


def load_meta(base: str, count: int) -> tuple[list, dict]:
    mpath = meta_path(base)
    if os.path.exists(mpath):
        with open(mpath, "r", encoding="utf-8") as f:
            meta_json = json.load(f)
        docs = meta_json.get("data", [None] * count)
        additional = meta_json.get("additional_data", {})
        return docs, additional
    return [None] * count, {}


def load_vectors(base: str, count: int, dim: int, use_memmap: bool) -> np.ndarray:
    vpath = vecs_path(base)
    if not os.path.exists(vpath):
        sharded = load_vectors_sharded(base, dim)
        if sharded is not None:
            return sharded
        raise FileNotFoundError(
            f"store {base!r} has an ids file but no vector data "
            f"({vpath} missing, no complete shard set, and no usable "
            "quantized plane) — the checkpoint is incomplete"
        )
    if not use_memmap:
        return to_c_f32(np.load(vpath))
    # Memmap path: prefer npy-aware memmap; fall back to raw (headerless)
    # files as produced by the reference's fresh-capacity mode
    # (picovdb/pico_vdb.py:286-296).
    with open(vpath, "rb") as f:
        magic = f.read(6)
    if magic == _NPY_MAGIC:
        mm = np.lib.format.open_memmap(vpath, mode="r+")
        if mm.dtype != Float or mm.ndim != 2 or mm.shape[1] != dim:
            raise ValueError(
                f"memmap vectors file has shape {mm.shape} dtype {mm.dtype}; "
                f"expected (*, {dim}) {np.dtype(Float).name}"
            )
        return mm
    return np.memmap(vpath, dtype=Float, mode="r+", shape=(count, dim))


def create_memmap(base: str, capacity: int, dim: int) -> np.ndarray:
    """Pre-allocate a (capacity, dim) on-disk npy store (fresh-DB memmap mode)."""
    return np.lib.format.open_memmap(
        vecs_path(base), mode="w+", dtype=Float, shape=(capacity, dim)
    )


def save_atomic(
    base: str,
    ids: list,
    docs: list,
    additional: dict,
    vectors: np.ndarray,
    embedding_dim: int,
    ann_blob: Optional[dict] = None,
    n_shards: Optional[int] = None,
) -> None:
    """Atomically persist ids/vectors/meta (+ optional ANN sidecar).

    With `n_shards`, vectors are written as per-shard files (multi-host
    layout) and a stale single-file matrix is removed — and vice versa.
    """
    ids_file, vfile, mfile = ids_path(base), vecs_path(base), meta_path(base)
    tmp_ids = f"{ids_file}.tmp"
    tmp_vecs_base = f"{base}.vecs.tmp"  # np.save appends .npy
    tmp_vecs = f"{tmp_vecs_base}.npy"
    tmp_meta = f"{mfile}.tmp"
    ann_file = ann_path(base)
    tmp_ann = f"{ann_file}.tmp"
    vectors_is_memmap = isinstance(vectors, np.memmap)
    try:
        with open(tmp_ids, "w", encoding="utf-8") as f:
            json.dump(ids, f, ensure_ascii=False)

        if n_shards is not None and n_shards > 1:
            fresh_shards = save_vectors_sharded(
                base, np.asarray(vectors), n_shards
            )
        elif vectors_is_memmap:
            vectors.flush()
        else:
            np.save(tmp_vecs_base, vectors)

        meta_json = {
            "embedding_dim": embedding_dim,
            "data": docs,
            "additional_data": additional,
        }
        with open(tmp_meta, "w", encoding="utf-8") as f:
            json.dump(meta_json, f, ensure_ascii=False)

        if ann_blob is not None:
            with open(tmp_ann, "wb") as f:
                np.savez(f, **ann_blob)

        os.replace(tmp_ids, ids_file)
        if n_shards is not None and n_shards > 1:
            if os.path.exists(vfile):
                os.remove(vfile)  # stale single-file matrix
            # A previous save with a DIFFERENT shard count leaves its own
            # shardNNNofMMM files behind; find_shards would lexicographically
            # interleave both generations into a corrupt corpus on reload.
            keep = set(fresh_shards)
            for stale in find_shards(base):
                if stale not in keep:
                    try:
                        os.remove(stale)
                    except OSError:
                        # Surface now: a surviving stale shard makes the
                        # strict generation check refuse every future load.
                        logger.warning(
                            "Could not remove stale shard %s; the store "
                            "will refuse to load until it is deleted",
                            stale,
                        )
        elif not vectors_is_memmap:
            os.replace(tmp_vecs, vfile)
            for stale in find_shards(base):
                try:
                    os.remove(stale)
                except OSError:
                    logger.warning(
                        "Could not remove stale shard %s; the store "
                        "will refuse to load until it is deleted",
                        stale,
                    )
        os.replace(tmp_meta, mfile)
        if ann_blob is not None:
            os.replace(tmp_ann, ann_file)
        # A previous save(quantized=True) leaves its packed plane behind;
        # the loader prefers that plane (engine._load_or_init tries
        # load_quantized first), so a stale one would silently shadow
        # this fresh f32 matrix — mirror of save_quantized_atomic
        # removing the stale .vecs.npy.
        for stale_q in (qvecs_path(base), qscale_path(base),
                        qinfo_path(base), overlay_path(base)):
            if os.path.exists(stale_q):
                try:
                    os.remove(stale_q)
                except OSError:
                    logger.warning(
                        "Could not remove stale quantized plane %s; the "
                        "loader would prefer it over the fresh f32 "
                        "matrix — delete it manually", stale_q,
                    )
        logger.info("Saved %d vectors", len(ids))
    finally:
        for tmp in (tmp_ids, tmp_vecs, tmp_meta, tmp_ann):
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass


def has_quantized(base: str) -> bool:
    """Whether `base` holds a quantized checkpoint (packed plane, scales
    and info file), the format of picovdb_tpu's quantized storage tiers."""
    return all(os.path.exists(p) for p in
               (qvecs_path(base), qscale_path(base), qinfo_path(base)))


def shard_path(base: str, i: int, n: int) -> str:
    return f"{base}.vecs.shard{i:03d}of{n:03d}.npy"


# Non-last shards hold a multiple of this many rows (see shard_split_rows):
# the multi-process loader tail-pads only the LAST process's block (any
# other padding would shift the global slot <-> device row correspondence),
# which requires every earlier shard's row count to divide evenly across
# that process's local devices. 8 covers 1/2/4/8 chips per host.
SHARD_ROW_ALIGN = 8


def shard_split_rows(n: int, n_shards: int) -> int:
    """Rows per non-last shard for an n-row corpus over n_shards files:
    the ceil split rounded up to SHARD_ROW_ALIGN (the last shard takes
    the remainder, possibly zero rows)."""
    if not n:
        return 0
    return round_up(-(-n // n_shards), SHARD_ROW_ALIGN)


def save_vectors_sharded(base: str, vectors: np.ndarray, n_shards: int) -> list:
    """Write the matrix as n_shards row-contiguous npy files (atomic each).

    Multi-host layout (SURVEY.md §7.6): shard i holds rows
    [i*per : (i+1)*per) with per = `shard_split_rows`, matching a
    row-sharded Mesh so each host of a pod can load only its own shard
    (empty tail shards are written as (0, dim) files so the loader's
    one-file-per-process contract holds). Returns the final paths.
    """
    n = vectors.shape[0]
    per = shard_split_rows(n, n_shards)
    paths = []
    tmp_file = None
    try:
        for i in range(n_shards):
            final = shard_path(base, i, n_shards)
            tmp_base = f"{final[:-4]}.tmp"
            tmp_file = f"{tmp_base}.npy"
            np.save(tmp_base,
                    np.ascontiguousarray(vectors[i * per : (i + 1) * per]))
            os.replace(tmp_file, final)
            tmp_file = None
            paths.append(final)
    finally:
        if tmp_file and os.path.exists(tmp_file):
            try:
                os.remove(tmp_file)
            except OSError:
                pass
    return paths


_SHARD_RE = re.compile(r"\.vecs\.shard(\d+)of(\d+)\.npy$")


def find_shards(base: str) -> list:
    """Existing shard files for `base`, in order; [] when none.

    Strict shardNNNofMMM.npy match: a crash between np.save and
    os.replace leaves `<shard>.tmp.npy`, which a loose
    startswith/endswith filter would pick up — and validated_shards
    would then reject the whole (otherwise valid) generation.
    """
    d = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + ".vecs.shard"
    try:
        names = sorted(
            f for f in os.listdir(d)
            if f.startswith(prefix) and _SHARD_RE.search(f)
        )
    except OSError:
        return []
    return [os.path.join(d, f) for f in names]


def validated_shards(base: str) -> list:
    """Shard files for `base` as ONE complete generation, ordered by
    numeric shard index; [] when none; raises on a mixed/partial set.

    The shard set must be one complete generation (indices 0..n-1, all
    the same `ofNNN` count): stores written before stale-shard cleanup
    existed (save_atomic) may hold two interleaved generations, which
    would silently pair ids/docs with wrong vectors if concatenated —
    or, on the multi-process load path, hand a process the wrong file.
    Numeric ordering also shields >999-shard sets from lexicographic
    interleaving (shard1000 sorts before shard999 as strings).
    """
    paths = find_shards(base)
    if not paths:
        return []
    seen = []
    for p in paths:
        m = _SHARD_RE.search(p)
        if m:
            seen.append((int(m.group(1)), int(m.group(2))))
    counts = {n for _, n in seen}
    idxs = sorted(i for i, _ in seen)
    if len(seen) != len(paths) or len(counts) != 1 or idxs != list(
        range(next(iter(counts)))
    ):
        # Recovery guidance: the generation written last (a crash between
        # save_atomic's prepare and cleanup phases leaves both) is the
        # fresh one — report per-generation newest mtime so the operator
        # knows which files to keep.
        by_gen: dict[int, float] = {}
        for (i, n), p in zip(seen, paths):
            try:
                by_gen[n] = max(by_gen.get(n, 0.0), os.path.getmtime(p))
            except OSError:
                pass
        freshest = max(by_gen, key=by_gen.get) if by_gen else None
        hint = (
            f" (newest mtime belongs to the of{freshest:03d} generation — "
            "keep those files, delete the rest)"
            if freshest is not None and len(by_gen) > 1
            else ""
        )
        raise ValueError(
            f"inconsistent shard set for {base!r}: {sorted(paths)} — "
            "expected one complete shardNNNofMMM generation; delete the "
            f"stale generation's files and reload{hint}"
        )
    return [p for _, p in sorted(
        zip((i for i, _ in seen), paths), key=lambda t: t[0]
    )]


def load_vectors_sharded(base: str, dim: int) -> Optional[np.ndarray]:
    """Concatenate shard files into one (N, dim) matrix; None when absent.

    See `validated_shards` for the one-complete-generation requirement.
    """
    paths = validated_shards(base)
    if not paths:
        return None
    parts = [np.load(p) for p in paths]
    for p, arr in zip(paths, parts):
        if arr.ndim != 2 or arr.shape[1] != dim:
            raise ValueError(
                f"shard {p} has shape {arr.shape}; expected (*, {dim})"
            )
    return to_c_f32(np.concatenate(parts, axis=0)) if len(parts) > 1 else to_c_f32(parts[0])


def file_sizes(base: str) -> dict[str, int]:
    """On-disk size per store file (reference: picovdb/pico_vdb.py:804-819)."""
    out: dict[str, int] = {}
    paths = [ids_path(base), meta_path(base), vecs_path(base),
             ann_path(base), qvecs_path(base),
             qscale_path(base), overlay_path(base)]
    for p in paths:
        try:
            if os.path.exists(p):
                out[os.path.basename(p)] = os.path.getsize(p)
        except OSError:
            pass
    return out
