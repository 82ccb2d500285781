"""A picovdb_tpu_torch store across processes on the card.

Marked `cuda`: skips with a reason where no CUDA device is present, and
runs on the card with

    python -m pytest tests/test_torch_cuda_multihost.py -q

Two ranks run tests/torch_multihost_worker.py in every mode of
tests/test_torch_multihost_procs.py with the kernel routes on: on one
card both on cuda:0 under gloo (its collectives staged through host
memory: NCCL refuses two ranks on one device), on two or more cards one
rank a card under NCCL. Each worker holds itself to the float64 oracle
as on the CPU; here every rank must also have launched the mode's
kernels on the card (K4 / K6 / K7 a local shard; K3 under int8 storage).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

NPROCS = 2
DIM = 16
N = 64
WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel family each mode must have launched on every rank
FAMILY = {"exact": "scan_topk", "dp": "scan_topk", "i4": "scan_topk_i4",
          "ivf": "ivf_scan_topk", "ivf8": "ivf_scan_topk",
          "engine": "scan_topk", "engine_odd": "scan_topk",
          "engine_i8": "scan_topk_i8", "grow": "scan_topk"}


@pytest.fixture
def where():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda-nccl" if torch.cuda.device_count() >= NPROCS else "cuda-gloo"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode", list(FAMILY))
def test_two_ranks_on_the_card(tmp_path, where, mode):
    from picovdb_tpu_torch import PicoVectorDB
    from picovdb_tpu_torch.constants import ROW_PAD

    base = str(tmp_path / "mhstore")
    n = {"engine_odd": N + 1, "grow": 2 * ROW_PAD - 100}.get(mode, N)
    vecs = np.random.default_rng(0).standard_normal((n, DIM)).astype(
        np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=base, device="cpu")
    db.upsert_columnar(vecs, ids=[str(i) if mode == "grow" else f"r{i}"
                                  for i in range(n)])
    db.save(shards=NPROCS)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(NPROCS), str(port), base,
         str(DIM), mode, "1", str(tmp_path / "answers.npz"), where],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(NPROCS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} ({where}) failed:\n{text}"
        assert f"MH OK pid={r} mode={mode}" in text, text
        counts = json.loads(text.split("LAUNCHES ", 1)[1].splitlines()[0])
        assert counts.get(FAMILY[mode], 0) > 0, (r, counts)
