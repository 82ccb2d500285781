"""K1 `segmax_scan`'s key slab: the port's plain version against the TPU
kernel on the CPU (at dims 100 and 300 too, the widths the card serves
through the mainloop fed by cp.async), and the dispatch between the
port's products.

The same seeded numpy inputs go through picovdb_tpu's `segmax_scan`
(Pallas interpret mode, its transposed (C, Q) slab mapped to the port's
(Q, 2 * cap / 128) layout as for K5) and `picovdb_tpu_torch.ops.scan.
segmax_scan` on CPU tensors (its plain version). Tolerances, each with its
reason:

  * the KEY_MIN patterns (masked rows, fully masked segments) are equal;
  * decoded key values agree within TOL_KEY = 1e-5: float32 sums of the
    same bf16 products in different orders, then each key drops its low 7
    bits (at most 128 ulp, 7.6e-6 below a score of 1);
  * lane bits agree wherever the segment's scores at that rank are more
    than TOL_KEY from their neighbours (closer, either lane is the top).

The TPU kernel refuses a cap that is not a multiple of its 1024-row tile,
so the port's half-tile edge (cap % 256 == 128, where the card kernel's
last 256-row tile holds one segment) is held against a float64 dense
reference instead, with the same checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch import probes
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TOL_KEY = 1e-5
SEG = tscan.SEG


def _inputs(rng, nq, cap, dim):
    """bf16-rounded normalized queries and rows (as numpy float32) and a
    ~10 % mask with segment 1 fully masked."""
    q = normalize_batch(rng.normal(size=(nq, dim)).astype(np.float32))
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    mask = rng.random(cap) > 0.1
    mask[SEG:2 * SEG] = False
    return q, v, mask


def _plain_keys(q, v, mask):
    bf = torch.bfloat16
    return tscan.segmax_scan(torch.from_numpy(q).to(bf),
                             torch.from_numpy(v).to(bf),
                             torch.from_numpy(mask)).numpy()


def _decode(keys):
    return tscan._from_sortable(torch.from_numpy(keys) & ~(SEG - 1)).view(
        torch.float32).numpy()


def _segment_ranks(q, v, mask):
    """float64 scores per (query, segment), descending: (Q, nseg, 128)."""
    s = q.astype(np.float64) @ v.astype(np.float64).T
    s[:, ~mask] = -np.inf
    nq, cap = s.shape
    return -np.sort(-s.reshape(nq, cap // SEG, SEG), axis=2)


def _assert_slab_agrees(keys, ref_keys, ranks, ref_vals=None):
    """KEY_MIN patterns equal, decoded values within TOL_KEY (of the
    reference keys', or of `ref_vals`), lane bits equal where the rank's
    score stands TOL_KEY clear of its neighbours."""
    nq, ncol = keys.shape
    live = keys != tscan.KEY_MIN
    np.testing.assert_array_equal(live, ref_keys != tscan.KEY_MIN)
    want = _decode(ref_keys) if ref_vals is None else ref_vals
    np.testing.assert_allclose(_decode(keys)[live], want[live], rtol=0,
                               atol=TOL_KEY)
    seg, r = np.arange(ncol) // 2, np.arange(ncol) % 2
    top = ranks[:, seg, :3]  # (Q, ncol, 3): ranks 0..2 of each column's segment
    here = np.take_along_axis(top, r[None, :, None].repeat(nq, 0), 2)[..., 0]
    above = np.where(r == 0, np.inf,
                     np.take_along_axis(top, np.maximum(r - 1, 0)[None, :, None]
                                        .repeat(nq, 0), 2)[..., 0])
    below = np.take_along_axis(top, (r + 1)[None, :, None].repeat(nq, 0), 2)[..., 0]
    with np.errstate(invalid="ignore"):  # -inf - -inf past the live rows
        clear = live & (above - here > TOL_KEY) & (here - below > TOL_KEY)
    assert clear.sum() > 0.9 * live.sum()
    np.testing.assert_array_equal((keys & (SEG - 1))[clear],
                                  (ref_keys & (SEG - 1))[clear])


@pytest.mark.parametrize("nq", [16, 200])
@pytest.mark.parametrize("cap", [1024, 3072])
@pytest.mark.parametrize("dim", [96, 256, 100, 300])
def test_segmax_keys_match_tpu_slab(rng, nq, cap, dim):
    q, v, mask = _inputs(rng, nq, cap, dim)
    keys_t, ns = jps.segmax_scan(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), mask,
                                 interpret=True, raw_t=True)
    keys_t = np.asarray(keys_t)
    c = np.arange(keys_t.shape[0])
    tile, s = c // (2 * ns), c % (2 * ns)
    seg, r = tile * ns + s % ns, (s >= ns).astype(int)
    jkeys = np.empty((nq, keys_t.shape[0]), np.int32)
    jkeys[:, 2 * seg + r] = keys_t.T
    tkeys = _plain_keys(q, v, mask)
    assert tkeys.shape == (nq, 2 * cap // SEG)
    assert (tkeys[:, 2:4] == tscan.KEY_MIN).all()  # the masked segment
    _assert_slab_agrees(tkeys, jkeys, _segment_ranks(q, v, mask))


def test_segmax_half_tile_edge_matches_float64(rng):
    """cap = 1152 (9 segments; cap % 256 == 128): the plain keys against
    a float64 dense reference's per-segment top two."""
    nq, cap, dim = 200, 1152, 96
    q, v, mask = _inputs(rng, nq, cap, dim)
    mask[cap - SEG:] = False  # one live row in the last segment
    mask[cap - 1] = True
    ranks = _segment_ranks(q, v, mask)
    s = q.astype(np.float64) @ v.astype(np.float64).T
    s[:, ~mask] = -np.inf
    order = np.argsort(-s.reshape(nq, cap // SEG, SEG), axis=2, kind="stable")
    lanes = order[:, :, :2].reshape(nq, -1)
    vals = ranks[:, :, :2].reshape(nq, -1)
    ref_keys = np.where(np.isfinite(vals), lanes, tscan.KEY_MIN).astype(np.int32)
    tkeys = _plain_keys(q, v, mask)
    assert tkeys.shape == (nq, 2 * cap // SEG)
    assert (tkeys[:, -1] == tscan.KEY_MIN).all()  # a lone live row
    assert (tkeys[:, -2] & (SEG - 1) == 127).all()
    _assert_slab_agrees(tkeys, ref_keys, ranks,
                        ref_vals=np.where(np.isfinite(vals), vals, 0.0))


def test_wgmma_dispatch_rule():
    """The TMA + wgmma mainloop takes dim % 8 == 0 with 16-byte aligned
    bases; dim 50 and a view 2 bytes off alignment take the wmma tile."""
    bf = torch.bfloat16

    def ready(dim, offset=0):
        q = torch.zeros(16, dim, dtype=bf)
        flat = torch.zeros(256 * dim + 8, dtype=bf)
        v = flat[offset:offset + 256 * dim].view(256, dim)
        return tscan.wgmma_ready(q, v)

    assert ready(1024) and ready(96) and ready(1024, offset=8)
    assert not ready(50) and not ready(1024, offset=1) and not ready(96, 1)


def test_wgmma_counters_stay_zero_on_the_cpu(rng):
    q, v, mask = _inputs(rng, 16, 1024, 96)
    bf = torch.bfloat16
    qb, vb = torch.from_numpy(q).to(bf), torch.from_numpy(v).to(bf)
    tscan.reset_launch_counts()
    tscan.segmax_scan(qb, vb, torch.from_numpy(mask))
    probes.dot_rowmax(qb, vb)
    assert tscan.LAUNCHES["segmax_wgmma"] == 0
    assert tscan.LAUNCHES["dot_rowmax_wgmma"] == 0
    assert tscan.LAUNCHES["segmax"] == 0 and tscan.LAUNCHES["dot_rowmax"] == 0
