"""K2 topk_packed_keys as a split-row warp select (csrc/topk_keys.cu),
checked on the CPU.

* A numpy emulation of the kernel, warp by warp: a row cut into chunks of
  `scan.topk_keys_chunk` keys, one warp a chunk; each step a lane holds 4
  keys, compares each key's 64-bit composite ((key ^ 0x80000000) << 32 |
  column) with the warp's k-th best (`tau`), admits the survivors through
  a ballot into the warp's queue (key slot by key slot, lanes in order),
  and when the queue holds 32 sorts it by the warp's bitonic network of
  xor-shuffles and merges it into the 32 held keys (the reversed lane-wise
  max, then five merge steps); the chunks' lists merge in the row's last
  warp the same way, skipping lists with no key above tau. The network
  is emulated lane by lane as the shuffles exchange.
* The emulation returns `torch.topk`'s keys bit for bit and the columns
  of the tie rule (equal keys: the larger column first; each entry once),
  on seeded numpy slabs: all-equal keys, rows of KEY_MIN, the row maximum
  repeated across chunk boundaries, k_sel 1 / 16 / 22 / 32, C not a
  multiple of the chunk, C == k_sel; and JAX's
  `picovdb_tpu.ops.pallas_scan.topk_packed_keys` in interpret mode (keys
  bit for bit; its columns of keys above KEY_MIN point at its keys, each
  once, and equal ours wherever the row's keys are distinct: across its
  2048-key chunks JAX takes the lower column of a tie first, and it gives
  KEY_MIN entries any column).
* The wrapper's launch, recorded on CPU tensors posing as CUDA tensors
  against `_build._SIGNATURES`: the chunk, the scratch and ticket only
  where a row has several chunks; on the CPU the counter stays 0.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

LANES = 32
STEP = 4 * LANES  # keys a warp reads a step
KEY_MIN = tscan.KEY_MIN


def _composite(keys, cols):
    """uint64 composites of int32 keys at their columns."""
    hi = (keys.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64) ^ np.uint64(
        0x80000000)
    return (hi << np.uint64(32)) | cols.astype(np.uint64)


def _sort_desc(x):
    """`warp_sort_desc`: the bitonic network of xor-shuffles on 32 lanes."""
    lane = np.arange(LANES)
    x = x.copy()
    size = 2
    while size <= LANES:
        stride = size // 2
        while stride > 0:
            y = x[lane ^ stride]
            desc = (lane & size) == 0
            low = (lane & stride) == 0
            x = np.where(low == desc, np.maximum(x, y), np.minimum(x, y))
            stride //= 2
        size *= 2
    return x


def _merge_desc(a, b):
    """`warp_merge_desc`: the 32 largest of two descending lists."""
    lane = np.arange(LANES)
    x = np.maximum(a, b[LANES - 1 - lane])
    stride = LANES // 2
    while stride > 0:
        y = x[lane ^ stride]
        low = (lane & stride) == 0
        x = np.where(low, np.maximum(x, y), np.minimum(x, y))
        stride //= 2
    return x


def _warp(row, c0, c1, k):
    """One warp over row[c0:c1]: its 32 held composites, descending."""
    held = np.zeros(LANES, dtype=np.uint64)
    tau = np.uint64(0)
    queue = []
    for b in range(c0, c1, STEP):
        idx = b + np.arange(STEP).reshape(LANES, 4)  # lane l: 4 l .. 4 l + 3
        ok = idx < c1
        kv = np.where(ok, row[np.minimum(idx, c1 - 1)], 0)
        cand = np.where(ok, _composite(kv, idx), np.uint64(0))
        passed = cand > tau
        if not passed.any():
            continue
        for e in range(4):  # a ballot a key slot, lanes in order
            queue.extend(cand[passed[:, e], e].tolist())
        if len(queue) >= LANES:
            for j in range(0, len(queue), LANES):
                x = np.zeros(LANES, dtype=np.uint64)
                part = queue[j:j + LANES]
                x[:len(part)] = part
                held = _merge_desc(held, _sort_desc(x))
            queue = []
            tau = held[k - 1]
    if queue:
        x = np.zeros(LANES, dtype=np.uint64)
        x[:len(queue)] = queue
        held = _merge_desc(held, _sort_desc(x))
    return held


def _emulate(keys, k):
    """The kernel on a (Q, C) int32 slab: (keys, columns), each (Q, k)."""
    num_q, c = keys.shape
    chunk = tscan.topk_keys_chunk(num_q, c)
    assert chunk % tscan.TOPK_KEYS_STEP == 0
    out = np.zeros((num_q, k), dtype=np.uint64)
    for q in range(num_q):
        lists = [_warp(keys[q], c0, min(c0 + chunk, c), k)[:k]
                 for c0 in range(0, c, chunk)]
        if len(lists) == 1:
            held = np.concatenate([lists[0], np.zeros(LANES - k, np.uint64)])
        else:  # the row's last warp
            held = np.zeros(LANES, dtype=np.uint64)
            tau = np.uint64(0)
            for lst in lists:
                x = np.zeros(LANES, dtype=np.uint64)
                x[:k] = lst
                if not (x > tau).any():
                    continue
                held = _merge_desc(held, x)
                tau = held[k - 1]
        out[q] = held[:k]
    hi = (out >> np.uint64(32)) ^ np.uint64(0x80000000)
    return (hi.astype(np.int64).astype(np.uint32).view(np.int32),
            (out & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32))


def _tie_rule(keys, k):
    """Top-k by (key, column) descending."""
    order = np.lexsort((-np.arange(keys.shape[1])[None, :].repeat(
        keys.shape[0], 0), -keys.astype(np.int64)), axis=1)[:, :k]
    return np.take_along_axis(keys, order, 1), order.astype(np.int32)


def _slab(case, num_q, c, k, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2**31, 2**31, (num_q, c), dtype=np.int64).astype(
        np.int32)
    if case == "all_equal":
        keys[:] = -77
    elif case == "key_min":
        keys[:] = KEY_MIN
        keys[::2, c // 2] = 5  # one live key in every other row
    elif case == "dup_max":
        chunk = tscan.topk_keys_chunk(num_q, c)
        for b in range(0, c + 1, chunk):
            for col in (b - 2, b - 1, b, b + 1):
                if 0 <= col < c:
                    keys[:, col] = 2**31 - 1
    elif case == "repeats":
        keys = rng.integers(-40, 40, (num_q, c)).astype(np.int32)
        keys[:, ::9] = KEY_MIN
    return keys


CASES = [("random", 3, 4096, 16), ("random", 2, 15872, 22),
         ("random", 5, 130, 32), ("all_equal", 3, 2050, 16),
         ("all_equal", 2, 32, 32), ("key_min", 4, 1538, 22),
         ("key_min", 2, 6, 1), ("dup_max", 4, 3000, 16),
         ("dup_max", 2, 1100, 32), ("repeats", 3, 2562, 1),
         ("repeats", 3, 2562, 32), ("random", 2, 22, 22),
         ("random", 2, 2, 1), ("random", 1, 4098, 16)]


@pytest.mark.parametrize("case,num_q,c,k", CASES)
def test_emulated_select_is_topk_with_the_tie_rule(case, num_q, c, k):
    """The emulated kernel: keys bit for bit `torch.topk`'s, columns the
    tie rule's (and so pointing at their keys, each once)."""
    keys = _slab(case, num_q, c, k, seed=c + k + num_q)
    got_k, got_c = _emulate(keys, k)
    ref_k, ref_c = _tie_rule(keys, k)
    np.testing.assert_array_equal(got_k, ref_k)
    np.testing.assert_array_equal(got_c, ref_c)
    tk, _ = torch.topk(torch.from_numpy(keys), k, dim=1)
    np.testing.assert_array_equal(got_k, tk.numpy())
    np.testing.assert_array_equal(np.take_along_axis(keys, got_c, 1), got_k)


def test_chunking_splits_rows_and_fills_the_card():
    """Over 15,872-key rows Q = 2048 reads each row in one chunk (no
    merge), Q = 256 in 4, Q = 64 in 16 and Q = 1 in 31 (512 keys each);
    short rows are one chunk; chunks are whole 512 keys and cover the
    row."""
    for num_q, c, chunks in ((2048, 15872, 1), (256, 15872, 4),
                             (64, 15872, 16), (1, 15872, 31), (64, 400, 1),
                             (4096, 16384, 1), (8, 2, 1)):
        chunk = tscan.topk_keys_chunk(num_q, c)
        assert chunk % tscan.TOPK_KEYS_STEP == 0 and chunk > 0
        assert -(-c // chunk) == chunks, (num_q, c, chunk)
    # at the segmax route's Q = 64 the launch holds ~1,000 warps (8 an SM)
    assert 64 * -(-15872 // tscan.topk_keys_chunk(64, 15872)) >= 1000


@pytest.mark.parametrize("c,k", [(640, 16), (4160, 9), (2050, 32)])
def test_emulated_select_matches_jax_interpret(c, k):
    """The emulation against picovdb_tpu's Pallas kernel run in interpret
    mode on the same seeded slab (its (C, Q) layout, Q = 128): keys bit
    for bit; JAX's columns of keys above KEY_MIN point at its keys, each
    once, and equal the emulation's wherever the row's keys are all
    distinct."""
    import jax.numpy as jnp
    from picovdb_tpu.ops.pallas_scan import topk_packed_keys

    rng = np.random.default_rng(c + k)
    keys = rng.integers(-2**31, 2**31, (128, c), dtype=np.int64).astype(
        np.int32)
    keys[rng.random((128, c)) < 0.3] = KEY_MIN
    keys[3] = KEY_MIN  # an empty row
    keys[5, :] = 9  # a row of one value
    keys[6, 1::2] = keys[6, ::2]  # every key twice (c is even)
    tk, ti = map(np.asarray, topk_packed_keys(jnp.asarray(keys.T), k,
                                              interpret=True))
    got_k, got_c = _emulate(keys, k)
    np.testing.assert_array_equal(got_k, tk)
    for q in range(128):
        live = tk[q] != KEY_MIN  # JAX's KEY_MIN columns are any column
        cols = ti[q][live]
        np.testing.assert_array_equal(keys[q, cols], tk[q][live])
        assert len(set(cols.tolist())) == len(cols)
        if len(np.unique(keys[q])) == c:
            np.testing.assert_array_equal(got_c[q][live], cols)


# --------------------------------------------------------------------------
# The wrapper's launch
# --------------------------------------------------------------------------


class _AsCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def launch(t, name, entry, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[entry]), entry
        calls.append((entry, args))

    monkeypatch.setattr(tscan, "_launch", launch)
    return calls


@pytest.mark.parametrize("num_q,c,k", [(2048, 15872, 16), (64, 15872, 16),
                                       (3, 300, 32)])
def test_k2_launch_arguments(recorded, num_q, c, k):
    """keys, out_keys, out_cols, scratch, Q, C, k, chunk: the scratch (Q
    S k lists, then Q int32 tickets) only where a row has S > 1 chunks;
    counted once under its shape."""
    keys = torch.zeros(num_q, c, dtype=torch.int32)
    tscan.reset_launch_counts()
    tk, tc = tscan.topk_packed_keys(torch.Tensor._make_subclass(_AsCuda, keys),
                                    k)
    assert tk.shape == tc.shape == (num_q, k)
    (entry, args), = recorded
    assert entry == "pv_topk_packed_keys"
    chunk = tscan.topk_keys_chunk(num_q, c)
    assert args[0] == keys.data_ptr()
    assert args[4:] == (num_q, c, k, chunk)
    assert (args[3] is not None) == (-(-c // chunk) > 1)
    assert tscan.LAUNCHES["topk_keys"] == 1
    assert tscan.LAUNCH_SHAPES["topk_keys"] == {(num_q, k): 1}
    tscan.reset_launch_counts()


def test_counter_stays_zero_on_the_cpu():
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 1000),
                                         dtype=np.int64).astype(np.int32))
    tscan.reset_launch_counts()
    tk, tc = tscan.topk_packed_keys(keys, 16)
    rk, rc = torch.topk(keys, 16, dim=1)
    assert torch.equal(tk, rk) and torch.equal(tc, rc.to(torch.int32))
    assert tscan.LAUNCHES["topk_keys"] == 0
