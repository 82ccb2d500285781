"""DeviceIndex.grow under device-memory exhaustion (picovdb_tpu_torch).

`grow` pads every device plane to a larger capacity, one allocation per
plane. When an allocation fails with `torch.cuda.OutOfMemoryError` the
store must stay consistent, as picovdb_tpu's grow keeps it:
  * the corpus pad fails -> store untouched, grow returns False;
  * the `active` pad fails -> every plane dropped, returns False;
  * the bf16 mirror pad fails -> that mirror alone dropped, returns True.
The engine's next sync then re-uploads the whole store (a, b) or scatters
into the grown planes (c), and answers as a store that never failed.
The failure is injected by making the module's pad helper raise for the
chosen plane, on the CPU.
"""

import numpy as np
import pytest
import torch

import picovdb_tpu_torch
from picovdb_tpu_torch import K_ID, K_METRICS
from picovdb_tpu_torch import device as tdevice

DIM = 32
KNOBS = dict(mixed_precision=True, int8_tier=True, use_pallas=True)

# which plane's pad fails: picked by the padded tensor's dtype and rank
PLANES = {
    "corpus": lambda t: t.dtype == torch.float32 and t.ndim == 2,
    "active": lambda t: t.dtype == torch.bool,
    "bf16": lambda t: t.dtype == torch.bfloat16,
}


def _failing_pad(which):
    real = tdevice._pad_to

    def pad(t, rows):
        if t is not None and PLANES[which](t):
            raise torch.cuda.OutOfMemoryError("injected: device memory")
        return real(t, rows)

    return pad


@pytest.mark.parametrize("which", list(PLANES))
def test_grow_end_states(rng, monkeypatch, which):
    vecs = rng.normal(size=(8000, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    dev = tdevice.DeviceIndex(DIM, **KNOBS)
    dev.from_numpy_state(vecs, np.ones(8000, bool))
    cap0, corpus0 = dev.cap, dev.vectors
    monkeypatch.setattr(tdevice, "_pad_to", _failing_pad(which))
    ok = dev.grow(9000)
    if which == "corpus":
        assert ok is False
        assert dev.cap == cap0 and dev.vectors is corpus0
        assert dev.active.shape == (cap0,) and dev.vectors_lp.shape[0] == cap0
    elif which == "active":
        assert ok is False
        assert dev.vectors is None and dev.active is None
        assert dev.vectors_lp is None and dev.vectors_i8 is None
        assert dev.vscale is None
    else:
        assert ok is True and dev.cap > cap0
        assert dev.vectors_lp is None
        for t in (dev.vectors, dev.active, dev.vectors_i8, dev.vscale):
            assert t.shape[0] == dev.cap


def _engine(tmp, name, base, extra):
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=DIM, storage_file=f"{tmp}/{name}", **KNOBS)
    db.upsert_columnar(base, ids=[f"b{i}" for i in range(len(base))])
    db.query(base[0], top_k=3)  # first sync: the store is on the device
    db.upsert_columnar(extra, ids=[f"e{i}" for i in range(len(extra))])
    return db


@pytest.mark.parametrize("which", list(PLANES))
def test_engine_recovers_after_failed_grow(rng, tmp_path, monkeypatch, which):
    """The append epoch crosses a capacity bucket, grow fails at `which`,
    and the query that triggered the sync answers as a store that grew
    without trouble (ids equal; scores within 1e-6: the same float32
    rows, scored by the same routes or by K3/K4 instead of K1)."""
    base = rng.normal(size=(8000, DIM)).astype(np.float32)
    extra = rng.normal(size=(600, DIM)).astype(np.float32)
    q = np.concatenate([extra[:4], base[:4]]) + 0.05
    ref = _engine(tmp_path, "ref", base, extra)
    want = ref.query(q, top_k=5)
    assert ref.last_query_debug()["sync_mode"] == "incremental"

    db = _engine(tmp_path, "db", base, extra)
    monkeypatch.setattr(tdevice, "_pad_to", _failing_pad(which))
    got = db.query(q, top_k=5)
    dbg = db.last_query_debug()
    assert dbg["sync_mode"] == ("incremental" if which == "bf16" else "full")
    assert dbg["device_capacity"] >= 8600
    assert dbg["mirrors"]["bf16"] is (which == "corpus" or which == "active")
    for hw, hg in zip(want, got):
        assert [h[K_ID] for h in hg] == [h[K_ID] for h in hw]
        np.testing.assert_allclose([h[K_METRICS] for h in hg],
                                   [h[K_METRICS] for h in hw],
                                   rtol=0, atol=1e-6)
    assert [h[0][K_ID] for h in got[:4]] == [f"e{i}" for i in range(4)]
