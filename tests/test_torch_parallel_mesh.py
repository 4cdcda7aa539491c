"""The port's data-parallel group (``rcgan_tpu_torch/parallel/mesh.py``) on
the CPU, over gloo ranks that :func:`launch` spawns: rows, the in-place mean
over ranks, the gather in rank order, the broadcast, ``any``, a rank's
failure and a hang killed by the timeout, joining a launcher's group from
the environment, a failed initialisation raising, the app's placement
checks; and ``CifarSplit.epoch(shard=)`` against JAX's.

Rank functions are module-level and this module imports JAX only inside
its test functions: a spawned rank unpickles them by importing this module,
and must not import JAX.  Every launch has its own timeout.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rcgan_tpu_torch.parallel import mesh
from rcgan_tpu_torch.parallel.mesh import DataGroup, launch

TIMEOUT = 120.0  # seconds for a launch of a few small ranks


def _collectives(group):
    r, n = group.rank, group.world_size
    # a mix of dtypes and shapes, meaned in place
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
    b = torch.tensor([float(r)], dtype=torch.float64)
    c = torch.full((), 2.0 ** -20 * (r + 1))
    alias = a
    group.mean_([a, b, c])
    gathered = group.gather_rows(torch.tensor([[r, 10 * r]], dtype=torch.int64))
    return {"a": a, "b": b, "c": c, "in_place": alias is a and a.data_ptr() == alias.data_ptr(),
            "gathered": gathered, "rows": group.local_rows(8 * n),
            "obj": group.broadcast_object({"rank": r} if r == 0 else None),
            "any_last": group.any(r == n - 1), "any_none": group.any(False),
            "bytes": group.bytes_reduced}


@pytest.mark.parametrize("n", [2, 4])
def test_group_collectives_over_gloo_ranks(n):
    """Each rank gets the mean of every tensor in place (per dtype, one
    all_reduce each), the same bits on every rank; ``gather_rows`` in rank
    order; rank 0's object; ``any``; contiguous rows; the byte counter."""
    outs = launch(_collectives, n, backend="gloo", timeout=TIMEOUT)
    k = np.arange(1, n + 1).mean()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["a"].numpy(), np.arange(6).reshape(2, 3) * k, rtol=1e-7)
        assert o["b"].dtype == torch.float64 and float(o["b"]) == (n - 1) / 2
        assert float(o["c"]) == 2.0 ** -20 * k
        assert o["in_place"]
        assert o["gathered"].tolist() == [[q, 10 * q] for q in range(n)]
        assert o["rows"] == slice(8 * r, 8 * (r + 1))
        assert o["obj"] == {"rank": 0}
        assert o["any_last"] is True and o["any_none"] is False
        assert o["bytes"] == 7 * 4 + 8  # one float32 and one float64 buffer
        for key in ("a", "b", "c"):
            assert torch.equal(o[key], outs[0][key])


def test_local_rows_and_checks():
    g = DataGroup(rank=1, world_size=4, device=torch.device("cpu"), backend="gloo")
    assert g.local_rows(16) == slice(4, 8) and not g.is_main
    with pytest.raises(ValueError, match="does not split"):
        g.local_rows(10)
    assert mesh.check_group(None, "cpu") is None
    assert mesh.check_group(g, "cpu") is g
    with pytest.raises(TypeError, match="DataGroup"):
        mesh.check_group(object(), "cpu")
    with pytest.raises(ValueError, match="differ"):
        mesh.check_group(g, "cuda")


def _fails(group):
    if group.rank == 1:
        raise ValueError("rank one is broken")
    group.barrier()  # rank 0 waits for a rank that never comes


def _hangs(group):
    import time

    time.sleep(3600)


def test_launch_raises_a_ranks_error_and_kills_a_hang():
    with pytest.raises(RuntimeError, match="of 2 failed(.|\n)*rank 1: (.|\n)*rank one is broken"):
        launch(_fails, 2, backend="gloo", timeout=TIMEOUT)
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        launch(_hangs, 2, backend="gloo", timeout=5.0)


def _from_env(group, port):
    """A launcher's process: the group torn down, then joined again from
    the environment as torchrun would set it."""
    dist.destroy_process_group()
    os.environ.update(RANK=str(group.rank), WORLD_SIZE=str(group.world_size),
                      LOCAL_RANK=str(group.rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    joined = mesh.maybe_initialize_distributed("cpu", timeout=60)
    t = torch.tensor([float(joined.rank)])
    joined.mean_([t])
    return joined.rank, joined.world_size, joined.backend, float(t)


def test_maybe_initialize_distributed_joins_the_launchers_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized() and mesh.maybe_initialize_distributed("cpu") is None
    outs = launch(_from_env, 2, backend="gloo", args=(mesh.free_port(),), timeout=TIMEOUT)
    assert outs == [(0, 2, "gloo", 0.5), (1, 2, "gloo", 0.5)]


def test_a_failed_initialisation_raises(monkeypatch):
    """A group asked for through the environment whose other rank never
    comes raises when its rendezvous times out; nothing falls back to one
    device."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(mesh.free_port()))
    with pytest.raises(RuntimeError):
        mesh.maybe_initialize_distributed("cpu", timeout=3)
    assert not dist.is_initialized()


def test_app_placement_checks(monkeypatch):
    """An app places one rank per card: more ranks than cards, or an
    explicit card for several ranks, raise before anything runs; one device
    or the CPU needs nothing."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.join_app_group(1, "cpu") is None
    assert mesh.join_app_group(4, "cpu") is None  # four gloo ranks, spawned by the app
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.join_app_group(1, "cuda") is None
    with pytest.raises(ValueError, match="2 devices asked for; 1 card"):
        mesh.join_app_group(2, "cuda")
    with pytest.raises(ValueError, match="one rank per card"):
        mesh.join_app_group(2, "cuda:0")
    with pytest.raises(ValueError, match="NCCL takes one card per rank"):
        launch(_hangs, 2, backend="nccl", devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_epoch_shard_matches_jax(n):
    """``CifarSplit.epoch(b, shard=(i, n))`` yields JAX's rows for every
    shard, and the shards of a batch tile it in order."""
    from rcgan_tpu.data import cifar10 as jdata
    from rcgan_tpu_torch.data import cifar10 as tdata

    rs = np.random.RandomState(n)
    m = 40
    arrays = dict(images=rs.randint(0, 256, (m, 3072)).astype(np.uint8),
                  labels=rs.randint(0, 10, m).astype(np.int32),
                  labels_actual=rs.randint(0, 10, m).astype(np.int32),
                  labels_random=rs.randint(0, 10, m).astype(np.int32),
                  labels_biased=rs.randint(0, 10, m).astype(np.int32),
                  labels_inv_weights=rs.rand(m, 10).astype(np.float32))
    mine, theirs = tdata.CifarSplit(**arrays), jdata.CifarSplit(**arrays)
    whole = list(mine.epoch(12))
    assert len(whole) == 3
    for i in range(n):
        got, want = list(mine.epoch(12, shard=(i, n))), list(theirs.epoch(12, shard=(i, n)))
        assert len(got) == len(want) == 3
        for g, w, full in zip(got, want, whole):
            for a, b, f in zip(g, w, full):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, f[i * 12 // n:(i + 1) * 12 // n])
