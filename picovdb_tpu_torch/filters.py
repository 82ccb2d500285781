"""Metadata prefilter compilation.

The reference evaluates `where` filters with Python loops over candidate
documents at query time (picovdb/pico_vdb.py:613-656). Here dict-shaped
filters compile to vectorized NumPy mask operations over a lazily built
columnar *tag index*: per metadata key, an int64 column of `hash(value)` per
slot. Equality / `$in` filters then become one vectorized compare, with an
exact-equality verification pass over hash matches only (collision safety).
Arbitrary callables keep the reference's Python-loop semantics.

Dict filters are a strict superset of the reference: multi-key dicts mean AND
(the reference only fast-paths single-key dicts and crashes on multi-key
dicts by calling them, pico_vdb.py:643-645).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

WhereType = Union[Dict[str, Any], Callable[[dict], bool]]

# Sentinel hash for "key absent or doc deleted". Collisions with a real
# hash(value) are resolved by the verification pass.
_MISSING = np.int64(-0x6A09E667F3BCC909)


def _safe_hash(v: Any) -> int:
    try:
        return hash(v)
    except TypeError:
        # Unhashable values (lists, dicts) can never match a hashed probe;
        # they fall through to the verification pass via the missing bucket.
        return int(_MISSING)


# Object-column slot marker for "key absent / doc deleted": identity-unique,
# compares unequal to every user value.
_ABSENT = object()

# Value types safe for vectorized object-array equality: numpy won't try to
# unpack them as sequences, and their __eq__ is total.
_SCALARISH = (str, int, float, bool, bytes, type(None))


class TagIndex:
    """Lazily built per-key hash + value columns over the slot table.

    Per key, two parallel columns: an int64 `hash(value)` column driving a
    vectorized prefilter, and an object column of the raw values driving a
    vectorized equality verification over the hash hits (hash collisions —
    e.g. CPython's hash(-1) == hash(-2) — must not surface as matches, and
    dict lookups per hit would make a 10%-selectivity filter over 1M rows
    Python-loop-bound). Columns are built on first filter use of a key
    (one O(N) pass) and kept incrementally up to date by `update_rows` /
    `clear_rows` / `resize`.
    """

    def __init__(self) -> None:
        self._cols: Dict[str, np.ndarray] = {}
        self._vals: Dict[str, np.ndarray] = {}
        self._size = 0

    def reset(self) -> None:
        self._cols.clear()
        self._vals.clear()

    def resize(self, new_size: int) -> None:
        if new_size < self._size:
            self._cols.clear()
            self._vals.clear()
        else:
            grow = new_size - self._size
            if grow and self._cols:
                pad = np.full(grow, _MISSING, dtype=np.int64)
                vpad = np.full(grow, _ABSENT, dtype=object)
                for k in list(self._cols):
                    self._cols[k] = np.concatenate([self._cols[k], pad])
                    self._vals[k] = np.concatenate([self._vals[k], vpad])
        self._size = new_size

    def update_rows(self, idxs: List[int], docs: List[Optional[dict]]) -> None:
        """Refresh columns for mutated slots. `docs[i]` is the new doc of `idxs[i]`."""
        if not self._cols:
            return
        n = len(idxs)
        idx_arr = np.asarray(idxs, dtype=np.int64)
        for key in self._cols:
            raw = [
                _ABSENT if doc is None or key not in doc else doc[key]
                for doc in docs
            ]
            hashes = np.fromiter(
                (
                    _MISSING if v is _ABSENT else _safe_hash(v)
                    for v in raw
                ),
                dtype=np.int64,
                count=n,
            )
            self._cols[key][idx_arr] = hashes
            vcol = self._vals[key]
            vrow = np.empty(n, dtype=object)
            vrow[:] = raw
            vcol[idx_arr] = vrow

    def clear_rows(self, idxs: List[int]) -> None:
        for key, col in self._cols.items():
            col[idxs] = _MISSING
            self._vals[key][idxs] = _ABSENT

    def _column(self, key: str, docs: List[Optional[dict]]) -> np.ndarray:
        col = self._cols.get(key)
        if col is None or col.shape[0] != self._size:
            raw = [
                _ABSENT if doc is None or key not in doc else doc[key]
                for doc in docs
            ]
            col = np.fromiter(
                (_MISSING if v is _ABSENT else _safe_hash(v) for v in raw),
                dtype=np.int64,
                count=self._size,
            )
            vals = np.empty(self._size, dtype=object)
            vals[:] = raw
            self._cols[key] = col
            self._vals[key] = vals
        return col

    def _verify_eq(self, hits: np.ndarray, key: str, value: Any) -> np.ndarray:
        """hits -> bool array: stored value == probe value, exactly."""
        stored = self._vals[key][hits]
        if isinstance(value, _SCALARISH):
            return stored == value
        return np.fromiter(
            (s is not _ABSENT and s == value for s in stored),
            dtype=bool,
            count=hits.shape[0],
        )

    def eq_mask(
        self, key: str, value: Any, docs: List[Optional[dict]]
    ) -> np.ndarray:
        """Boolean mask over slots where doc[key] == value."""
        col = self._column(key, docs)
        probe = _safe_hash(value)
        mask = col == np.int64(probe)
        # Verify equality on hash hits only (collision + unhashable safety).
        hits = np.nonzero(mask)[0]
        if hits.size:
            mask[hits] = self._verify_eq(hits, key, value)
        if probe == int(_MISSING):
            # probe collided with the missing sentinel: scan properly.
            stored = self._vals[key]
            for i in range(self._size):
                s = stored[i]
                if s is not _ABSENT and s == value:
                    mask[i] = True
        return mask

    def in_mask(
        self, key: str, values: Any, docs: List[Optional[dict]]
    ) -> np.ndarray:
        col = self._column(key, docs)
        vals = list(values)
        probes = np.asarray([_safe_hash(v) for v in vals], dtype=np.int64)
        mask = np.isin(col, probes)
        value_set = set()
        unhashable = []
        for v in vals:
            try:
                value_set.add(v)
            except TypeError:
                unhashable.append(v)
        hits = np.nonzero(mask)[0]
        if hits.size:
            stored = self._vals[key][hits]
            keep = np.fromiter(
                (_in_values(s, value_set, unhashable) for s in stored),
                dtype=bool,
                count=hits.shape[0],
            )
            mask[hits] = keep
        return mask


def compile_where_mask(
    where: WhereType,
    docs: List[Optional[dict]],
    active_mask: np.ndarray,
    tag_index: Optional[TagIndex],
) -> np.ndarray:
    """Compile a `where` filter to a boolean slot mask (restricted to actives).

    Dict filters use the tag index (vectorized); callables run the reference's
    Python loop over active slots (picovdb/pico_vdb.py:643-648).
    """
    n = active_mask.shape[0]
    if isinstance(where, dict):
        mask = active_mask.copy()
        for k, v in where.items():
            if isinstance(v, dict) and set(v.keys()) == {"$in"}:
                if tag_index is not None:
                    mask &= tag_index.in_mask(k, v["$in"], docs)
                else:
                    values = list(v["$in"])
                    sub = np.zeros(n, dtype=bool)
                    for i in np.nonzero(mask)[0]:
                        doc = docs[i]
                        if doc is not None and _value_in(doc.get(k), values):
                            sub[i] = True
                    mask &= sub
            else:
                if tag_index is not None:
                    mask &= tag_index.eq_mask(k, v, docs)
                else:
                    sub = np.zeros(n, dtype=bool)
                    for i in np.nonzero(mask)[0]:
                        doc = docs[i]
                        if doc is not None and doc.get(k) == v:
                            sub[i] = True
                    mask &= sub
        return mask
    if callable(where):
        mask = np.zeros(n, dtype=bool)
        for i in np.nonzero(active_mask)[0]:
            doc = docs[i]
            if doc is not None and where(doc):
                mask[i] = True
        return mask
    raise TypeError(f"where must be a dict or callable; got {type(where)!r}")


def _value_in(value: Any, values: List[Any]) -> bool:
    try:
        return value in values
    except TypeError:
        return any(value == v for v in values)


def _in_values(stored: Any, value_set: set, unhashable: List[Any]) -> bool:
    if stored is _ABSENT:
        return False
    try:
        if stored in value_set:
            return True
    except TypeError:
        pass
    return any(stored == u for u in unhashable)
