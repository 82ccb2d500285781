"""parallel/multihost.py of picovdb_tpu_torch in its single-process form.

The counterpart of tests/test_multihost.py: the pod mesh's axes, the
shard-file handoff (`load_host_shard`) and its validation, and
`init_distributed` with no address. Beside them, the anchor of the
reference's fault 2: with the `env://` launcher variables set and no
address passed, picovdb_tpu's `init_distributed` returns without a
runtime, the port's initialises a process group. The real multi-process
runs are tests/test_torch_multihost_procs.py.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from picovdb_tpu import persistence as jpersistence
from picovdb_tpu_torch import persistence
from picovdb_tpu_torch.parallel import Mesh, multihost
from picovdb_tpu_torch.parallel.multihost import (
    init_distributed,
    load_host_shard,
    pod_mesh,
)
from torch_port_setup import cap_torch_threads

cap_torch_threads()

CPU = torch.device("cpu")
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def no_launcher_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def test_pod_mesh_axes(no_launcher_env):
    mesh = pod_mesh(devices=[CPU] * 4)
    assert mesh.shape["shard"] == 4 and mesh.shape["dp"] == 1
    assert not mesh.multiprocess and mesh.local_shards == [0, 1, 2, 3]
    assert mesh.first == CPU
    mesh2 = pod_mesh(dp=2, devices=[CPU] * 4)
    assert mesh2.shape["dp"] == 2 and mesh2.shape["shard"] == 2
    with pytest.raises(ValueError, match="dp=3"):
        pod_mesh(dp=3, devices=[CPU] * 4)


def test_pod_mesh_needs_a_card_or_devices(no_launcher_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pod_mesh()


def test_mesh_owners_and_local_shards():
    """A mesh across processes names every rank's devices; a rank owns the
    columns `owners` gives it and sees None at the others'."""
    m = Mesh([[CPU] * 4, [CPU] * 4], ("dp", "shard"), owners=[0, 0, 1, 1],
             rank=1, world_size=2)
    assert m.multiprocess and m.local_shards == [2, 3]
    assert m.local_row(1) == [None, None, CPU, CPU]
    assert [m.is_local(s) for s in range(4)] == [False, False, True, True]
    with pytest.raises(ValueError, match="owners"):
        Mesh([[CPU] * 4], ("dp", "shard"), owners=[0, 1], world_size=2)
    with pytest.raises(ValueError, match="owns no shard"):
        Mesh([[CPU] * 2], ("dp", "shard"), owners=[0, 0], rank=1,
             world_size=2)


@pytest.mark.parametrize("shards", [1, 4])
def test_load_host_shard_roundtrip(tmp_path, shards):
    """One process reads a save(shards=1) layout as its blocks, padded to
    the local shard count; the same rows picovdb_tpu's loader joins."""
    base = str(tmp_path / "mh")
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(66, 16)).astype(np.float32)
    persistence.save_vectors_sharded(base, vectors, n_shards=1)
    blocks, n = load_host_shard(base, 16, pod_mesh(devices=[CPU] * shards))
    assert len(blocks) == shards and n == sum(b.shape[0] for b in blocks)
    got = torch.cat(blocks).numpy()
    np.testing.assert_array_equal(got[:66], vectors)
    assert not got[66:].any()

    import jax

    from picovdb_tpu.parallel.multihost import load_host_shard as jload

    if shards <= len(jax.devices()):
        jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:shards]).reshape(
            1, shards), ("dp", "shard"))
        want = np.asarray(jload(base, 16, jmesh))
        np.testing.assert_array_equal(got, want)


def test_load_host_shard_validates(tmp_path):
    base = str(tmp_path / "mh2")
    mesh = pod_mesh(devices=[CPU])
    rng = np.random.default_rng(1)
    with pytest.raises(FileNotFoundError):
        load_host_shard(base, 4, mesh)
    persistence.save_vectors_sharded(
        base, rng.normal(size=(8, 4)).astype(np.float32), n_shards=2)
    with pytest.raises(ValueError, match="processes"):
        load_host_shard(base, 4, mesh)  # 2 shard files, 1 process
    two = Mesh([[CPU] * 2], ("dp", "shard"), owners=[0, 1], world_size=2)
    with pytest.raises(ValueError, match="has shape"):
        load_host_shard(base, 5, two)
    # a layout the fixed-per writer never makes: a short shard first
    bad = str(tmp_path / "bad")
    np.save(persistence.shard_path(bad, 0, 2), np.zeros((3, 4), np.float32))
    np.save(persistence.shard_path(bad, 1, 2), np.zeros((8, 4), np.float32))
    with pytest.raises(ValueError, match="unexpected shard row layout"):
        load_host_shard(bad, 4, two)
    # three shard columns cannot split over two processes
    three = Mesh([[CPU] * 3], ("dp", "shard"), owners=[0, 0, 1], world_size=2)
    with pytest.raises(ValueError, match="distribute evenly"):
        load_host_shard(base, 4, three)


def test_save_shard_atomic_matches_jax(tmp_path):
    """The multi-process saver's one-file writer: the same bytes as
    picovdb_tpu's, no temporary left behind."""
    rows = np.random.default_rng(2).normal(size=(10, 8))
    a = persistence.save_shard_atomic(str(tmp_path / "t"), 1, 2, rows)
    b = jpersistence.save_shard_atomic(str(tmp_path / "j"), 1, 2, rows)
    assert a.endswith(".vecs.shard001of002.npy")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(a), os.path.basename(b)])


def test_init_distributed_is_safe_single_process(no_launcher_env):
    # no address and no launcher variables: must not raise or hang
    init_distributed()
    init_distributed(backend="gloo")
    assert not dist.is_initialized()


def test_init_distributed_honours_env_launcher(monkeypatch):
    """Reference fault 2: picovdb_tpu returns early unless its own
    coordinator variable is set, so a torchrun-style launch never starts
    a runtime. The port reads MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE and initialises the group; a second call is a no-op."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not dist.is_initialized()
    try:
        init_distributed(backend="gloo", timeout_s=30)
        assert dist.is_initialized()
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        init_distributed(backend="gloo")  # already up: swallowed
        mesh = pod_mesh(devices=[CPU] * 2)  # world 1: one process's mesh
        assert not mesh.multiprocess and mesh.shape["shard"] == 2
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def test_init_distributed_surfaces_a_connect_failure(no_launcher_env):
    """A rank that cannot reach its rendezvous raises; the backend is not
    switched and no group is left behind."""
    port = _free_port()
    with pytest.raises(Exception) as err:
        init_distributed(f"tcp://127.0.0.1:{port}", world_size=2, rank=1,
                         backend="gloo", timeout_s=3)
    assert "twice" not in str(err.value)
    assert not dist.is_initialized()


def test_move_rows_single_process():
    """move_rows on one process is a re-split: every row lands at its new
    part, in pieces of `chunk` rows."""
    mesh = Mesh([[CPU] * 3], ("dp", "shard"))
    src = [torch.arange(s * 5, s * 5 + 5, dtype=torch.float32)[:, None]
           .repeat(1, 2) for s in range(3)]
    dst = [torch.zeros((8, 2)) for _ in range(2)]

    def write(s, a, b, rows):
        dst[s][a - s * 8:b - s * 8] = rows

    multihost.move_rows(mesh, 15, 5, lambda o: 0,
                        lambda o, a, b: src[o][a - o * 5:b - o * 5], 8, 2,
                        lambda s: 0, write, (2,), torch.float32, chunk=2)
    flat = torch.cat(dst)[:, 0].numpy()
    np.testing.assert_array_equal(flat[:15], np.arange(15))
    assert not flat[15:].any()
