"""How picovdb_tpu_torch launches its kernels, checked on the CPU.

* Every ctypes launch runs under `torch.cuda.device(<its tensor's
  device>)` through one helper, `ops/scan.py::_launch`: a source scan
  fails if any module of the package reaches the kernel library, or a
  launch stream, another way, and recorders stand in for
  `torch.cuda.device` and `torch.cuda.current_stream` to show what the
  helper enters and passes.
* Which kernel a launch takes: P1-int8's TMA + wgmma rule
  (`wgmma_i8_ready`) and K9's one-query sweep (`sweep_ready`), with the
  sweep's row ranges (`sweep_partition`).
* K9 over the sweep's own ranges: the plain version run per range, then
  merged, against a numpy int oracle (exact: ties to the lower row) and
  the JAX package's `fused_topk_i8c` in interpret mode (its scores the
  port's floored to its lane unit, as in tests/test_torch_i8c.py).
"""

import ast
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch import probes
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

PKG = Path(picovdb_tpu_torch.__file__).resolve().parent


def _enclosing_functions(tree):
    """{id(node): name of the innermost function def around it}."""
    owner = {}

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            here = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
            owner[id(child)] = here
            visit(child, here)

    visit(tree, None)
    return owner


def test_every_library_call_goes_through_launch():
    """`_build.library()` and `_stream(...)` are called only inside
    `scan._launch`, and no module names a library entry (`pv_*`) as an
    attribute: a launch that bypassed the device guard would have to."""
    seen = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if rel == "ops/_build.py":
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        owner = _enclosing_functions(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith("pv_"):
                pytest.fail(f"{rel}:{node.lineno} reaches {node.attr} directly")
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None)
            if name in ("library", "_stream"):
                seen.append((rel, name, owner.get(id(node))))
    assert sorted(seen) == [("ops/scan.py", "_stream", "_launch"),
                            ("ops/scan.py", "library", "_launch")], seen


def test_launch_enters_the_tensors_device(monkeypatch):
    """`_launch` enters `torch.cuda.device(t.device)`, takes the current
    stream of that same device, calls the entry with it as the last
    argument while the guard is held, and raises on a non-zero code."""
    log = []
    held = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            log.append(("enter", self.device))
            held.append(self.device)

        def __exit__(self, *exc):
            held.pop()
            log.append(("exit", self.device))

    def current_stream(device=None):
        log.append(("stream", device))
        return types.SimpleNamespace(cuda_stream=4242)

    def entry(*args):
        log.append(("call", args, list(held)))
        return 0 if args[0] == 7 else 1

    lib = types.SimpleNamespace(pv_fake=entry)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "library", lambda: lib)
    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    tscan._launch(t, "fake", "pv_fake", 7, 8)
    dev1 = torch.device("cuda", 1)
    assert log == [("enter", dev1), ("stream", dev1),
                   ("call", (7, 8, 4242), [dev1]), ("exit", dev1)]
    with pytest.raises(RuntimeError, match="fake launch failed"):
        tscan._launch(t, "fake", "pv_fake", 9)
    assert held == []


# --------------------------------------------------------------------------
# Which kernel a launch takes: the dispatch rules, pure functions of the
# operands' shapes and addresses
# --------------------------------------------------------------------------


def _operands(dim, dtype, offset=0, nq=16, rows=256):
    """Contiguous (nq, dim) queries and a (rows, dim) view `offset`
    elements into a larger buffer."""
    q = torch.zeros(nq, dim, dtype=dtype)
    flat = torch.zeros(rows * dim + 16, dtype=dtype)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


def test_wgmma_i8_dispatch_rule():
    """P1-int8 takes the mainloop at dim % 16 == 0 with 16-byte aligned
    bases (dim 1024 and 96); dim 40 and a view 1 byte off alignment take
    the mma.sync tile."""
    i8 = torch.int8
    assert tscan.wgmma_i8_ready(*_operands(1024, i8))
    assert tscan.wgmma_i8_ready(*_operands(96, i8))
    assert tscan.wgmma_i8_ready(*_operands(1024, i8, offset=16))
    assert not tscan.wgmma_i8_ready(*_operands(40, i8))
    assert not tscan.wgmma_i8_ready(*_operands(1024, i8, offset=1))
    assert not tscan.wgmma_i8_ready(*_operands(96, i8, offset=8))


@pytest.mark.parametrize("nq", [1, 8, 16])
def test_sweep_dispatch_rule(nq):
    """K9's one-query sweep: Q <= 16 with k <= 128 at dim 1024; Q = 17,
    k = 300, dim 40 and a misaligned view keep the template."""
    i8 = torch.int8
    q, v = _operands(1024, i8, nq=nq)
    assert tscan.sweep_ready(q, v, 1) and tscan.sweep_ready(q, v, 128)
    assert not tscan.sweep_ready(q, v, 300)
    assert not tscan.sweep_ready(*_operands(1024, i8, nq=17), 16)
    assert not tscan.sweep_ready(*_operands(40, i8, nq=nq), 16)
    assert not tscan.sweep_ready(*_operands(1024, i8, offset=4, nq=nq), 16)


@pytest.mark.parametrize("cap", [1, 128, 8192, 8152, 1_000_000])
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_sweep_partition_covers_cap(cap, sms):
    """128-row-aligned ranges that cover [0, cap) once, at most two CTAs
    per SM, none past the end."""
    chunk, n = tscan.sweep_partition(cap, sms)
    assert chunk % tscan.SEG == 0 and 1 <= n <= max(1, 2 * sms)
    assert (n - 1) * chunk < cap <= n * chunk


# --------------------------------------------------------------------------
# K9's partition: the plain version over the sweep's own row ranges
# --------------------------------------------------------------------------

CAP = 8192


def _k9_inputs(nq=3, dim=128, seed=5):
    """Column-scaled int8 rows and folded queries made by the JAX package
    (as numpy), and a mask keeping ~80 % of the rows."""
    rng = np.random.default_rng(seed)
    v = normalize_batch(rng.normal(size=(CAP, dim)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(nq, dim)).astype(np.float32))
    v8, cs = map(np.asarray, jps.quantize_cols_i8(jnp.asarray(v)))
    q8 = np.asarray(jps.fold_queries_i8(jnp.asarray(q), jnp.asarray(cs)))
    v8, mask = v8.copy(), rng.random(CAP) < 0.8
    return q8, v8, mask


@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("case", ["tie", "empty", "few"])
def test_k9_plain_over_sweep_ranges_matches_tpu_kernel(case, sms):
    """The sweep's edges at the partition of `sms` SMs: "tie" (two rows of
    127 * sign(q8[0]), query 0's largest reachable sum, on either side of
    a range boundary: the lower row first), "empty" (range 1 has no live
    row), "few" (3 live rows, k = 8: -inf / row 0 past them)."""
    q8, v8, mask = _k9_inputs()
    chunk, n = tscan.sweep_partition(CAP, sms)
    assert n >= 2
    k = 16
    if case == "tie":
        b = chunk
        v8[b - 1] = v8[b] = np.where(q8[0] >= 0, 127, -127)
        mask[b - 1] = mask[b] = True
    elif case == "empty":
        mask[chunk:2 * chunk] = False
    else:
        mask[:] = False
        mask[[3, chunk + 5, CAP - 1]] = True
        k = 8
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    vals, idx = tscan.fused_topk_i8c_plain(t(q8), t(v8), t(mask), k,
                                           chunk=chunk)
    vals, idx = vals.numpy(), idx.numpy()
    # the numpy int oracle: (int32 sum desc, row asc) over the live rows
    s = q8.astype(np.int64) @ v8.astype(np.int64).T
    rows = np.nonzero(mask)[0]
    for i in range(q8.shape[0]):
        order = np.lexsort((rows, -s[i, rows]))[:k]
        live = len(order)
        np.testing.assert_array_equal(idx[i, :live], rows[order])
        np.testing.assert_array_equal(vals[i, :live],
                                      s[i, rows[order]].astype(np.float32))
        assert np.isneginf(vals[i, live:]).all() and not idx[i, live:].any()
    if case == "tie":
        assert idx[0, :2].tolist() == [chunk - 1, chunk]
    # the TPU kernel ranks (s & ~(L - 1)) | lane: its scores are the port's
    # floored to a multiple of L (see test_torch_i8c.py)
    jv, ji = map(np.asarray, jps.fused_topk_i8c(
        jnp.asarray(q8), jnp.asarray(v8), jnp.asarray(mask), k,
        interpret=True))
    bn = jps._pick_bn(q8.shape[1], min(jps.DEFAULT_QT, q8.shape[0]), k, 1,
                      CAP, 4096)
    unit = 1 << max(1, int(bn - 1).bit_length())
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(np.isfinite(jv), fin)
    np.testing.assert_array_equal((np.floor(vals / unit) * unit)[fin], jv[fin])
    assert bool(mask[ji[fin]].all())


def test_new_counters_stay_zero_on_the_cpu():
    """On the CPU the wrappers run the plain versions: the int8 mainloop's
    and the sweep's counters stay 0."""
    g = torch.Generator().manual_seed(0)
    q8 = torch.randint(-127, 128, (4, 96), generator=g, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (1024, 96), generator=g, dtype=torch.int8)
    mask = torch.ones(1024, dtype=torch.bool)
    tscan.reset_launch_counts()
    probes.dot_rowmax(q8, v8)
    tscan.fused_topk_i8c(q8, v8, mask, 16)
    tscan.fused_topk_i8c(q8[:1], v8, mask, 16)
    for key in ("dot_rowmax_i8_wgmma", "scan_topk_i8c_sweep", "dot_rowmax",
                "scan_topk_i8c"):
        assert tscan.LAUNCHES[key] == 0, key
