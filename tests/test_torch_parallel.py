"""Port: the rank sampler, the batch split and the launcher of
``fovealseg_torch/parallel`` on the CPU.

The sampler's indices are held equal to the JAX package's
``host_shard_indices`` and ``DistributedSampler`` (both plain numpy, so the
comparison is exact). The launcher runs real OS processes over gloo: one run
shows the ranks meet and each keeps its contiguous block; the others show it
fails fast, drains a worker's output while it runs, and refuses more ranks
than cards (this host has none) and NCCL between CPU ranks.
"""

import time

import numpy as np
import pytest
import torch

from fovealseg_torch.parallel import multihost as port
from fovealseg_torch.parallel.launch import WorkerError, rank_devices, run_workers
from fovealseg_torch.parallel.mesh import fold_generator, shard_batch
from fovealseg_tpu.parallel import multihost as ref

import torch_parallel_workers as W


@pytest.mark.parametrize("n,replicas", [(10, 2), (10, 3), (7, 4), (3, 4), (1, 3), (16, 8)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sampler_equals_jax(n, replicas, shuffle):
    """Every rank's indices over three epochs, including n < replicas (the
    tiled fill): equal to the JAX package's, as arrays and through the
    sampler with ``set_epoch``."""
    for rank in range(replicas):
        s_port = port.DistributedSampler(n, replicas, rank, shuffle=shuffle, seed=5)
        s_ref = ref.DistributedSampler(n, replicas, rank, shuffle=shuffle, seed=5)
        assert len(s_port) == len(s_ref)
        for epoch in range(3):
            np.testing.assert_array_equal(
                port.host_shard_indices(n, replicas, rank, epoch, shuffle, seed=5),
                ref.host_shard_indices(n, replicas, rank, epoch, shuffle, seed=5))
            s_port.set_epoch(epoch)
            s_ref.set_epoch(epoch)
            assert list(s_port) == list(s_ref)
    with pytest.raises(ValueError):
        port.host_shard_indices(n, replicas, replicas)


def test_split_and_shard_batch():
    """``split_batch_axis`` equals the JAX package's; ``shard_batch`` gives
    contiguous blocks and leaves the per-step scalars whole."""
    rng = np.random.default_rng(0)
    batch = {"img_data": rng.normal(size=(8, 4, 4, 3)).astype(np.float32),
             "cls_label": np.arange(8, dtype=np.int32)}
    for i in range(4):
        got, want = port.split_batch_axis(batch, 4, i), ref.split_batch_axis(batch, 4, i)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        port.split_batch_axis(batch, 3, 0)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t.update(edge_scale=7.0, edge_only=True, pool_s=-1)
    for rank in range(2):
        blk = shard_batch(t, rank, 2)
        torch.testing.assert_close(blk["img_data"], t["img_data"][4 * rank : 4 * rank + 4])
        assert blk["cls_label"].tolist() == list(range(4 * rank, 4 * rank + 4))
        assert (blk["edge_scale"], blk["edge_only"], blk["pool_s"]) == (7.0, True, -1)
    with pytest.raises(ValueError):
        shard_batch(t, 0, 3)


def test_fold_generator_keeps_rank_0():
    """Rank 0's dropout stream is the single process's; other ranks get
    streams of their own that depend on the step count."""
    base = torch.Generator().manual_seed(11)
    draws = {}
    for rank, step in ((0, 0), (1, 0), (2, 0), (1, 5)):
        g = fold_generator(torch.Generator().manual_seed(11), rank, step)
        draws[rank, step] = torch.rand(4, generator=g)
    torch.testing.assert_close(draws[0, 0], torch.rand(4, generator=base), rtol=0, atol=0)
    keys = list(draws)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(draws[a], draws[b]), (a, b)


def test_ranks_meet_and_keep_their_blocks():
    """Two gloo ranks: each gets its contiguous block, an all-reduce over
    them adds up the whole array, and each reports its topology."""
    arr = np.arange(12, dtype=np.float64).reshape(6, 2)
    results = run_workers(2, W.block_sum, arr, device="cpu", timeout=120, threads=1)
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["block"].numpy(), arr[3 * rank : 3 * rank + 3])
        assert res["total"] == res["expected"] == float(arr.sum())
    (topo,) = run_workers(1, W.topology, device="cpu", timeout=120, threads=1)
    assert topo == {"rank": 0, "world_size": 1, "backend": "gloo", "device": "cpu",
                    "device_name": "cpu", "local_device_count": 0}


def test_replicate_state_copies_rank_0():
    """``replicate_state`` over two gloo ranks: rank 1 ends with rank 0's
    parameters and buffers bit for bit, whatever their dtype or strides
    (one flattened broadcast per dtype), and the ranks' dropout streams
    differ (rank 0 keeps its own)."""
    r0, r1 = run_workers(2, W.replicate, device="cpu", timeout=120, threads=1)
    assert [v.dtype for v in r0["sd"].values()].count(torch.int64) == 1
    for i, (k, t) in enumerate(r0["sd"].items()):
        torch.testing.assert_close(t, (torch.arange(t.numel()).reshape(t.shape) + i).to(t.dtype),
                                   rtol=0, atol=0, msg=k)
        torch.testing.assert_close(r1["sd"][k], t, rtol=0, atol=0, msg=k)
    assert torch.equal(r0["draw"], torch.rand(4, generator=torch.Generator().manual_seed(7)))
    assert not torch.equal(r1["draw"], r0["draw"])


def test_a_failing_rank_stops_the_run_within_seconds():
    """Rank 1 raises at once while rank 0 waits in a collective: the
    launcher stops rank 0 and raises with rank 1's traceback (rank 0 may be
    seen failing in the same instant, its collective cut)."""
    t = time.perf_counter()
    with pytest.raises(WorkerError,
                       match=r"rank 1 of 2 \(cpu, gloo\) failed(?s:.*)rank 1 fails on purpose"):
        run_workers(2, W.fail_on_rank_1, device="cpu", timeout=300, threads=1)
    assert time.perf_counter() - t < 60


def test_output_beyond_a_pipe_does_not_block():
    """A rank that prints 256 KiB (four times a 64 KiB pipe) before it
    returns finishes: the launcher drains its output while it runs."""
    assert run_workers(2, W.print_a_lot, 256 * 1024, device="cpu", timeout=120,
                       threads=1) == [0, 1]


def test_deadline_stops_the_ranks():
    """A rank still running at the deadline is stopped and reported."""
    t = time.perf_counter()
    with pytest.raises(WorkerError, match="deadline"):
        run_workers(1, W.sleep_forever, device="cpu", timeout=1)
    assert time.perf_counter() - t < 30


@pytest.mark.parametrize("n,device,backend", [(2, "cuda", None), (1, ["cuda:1"], "gloo"),
                                              (2, "cpu", "nccl"), (2, ["cpu", "cuda:0"], None)])
def test_refuses_more_ranks_than_cards_and_nccl_on_the_host(n, device, backend):
    """No silent truncation and no fallback: on a host with no card, asking
    for ranks on cards raises, and so does NCCL between CPU ranks or a mix
    of devices, before any process starts."""
    with pytest.raises(ValueError):
        rank_devices(n, device, backend)
    with pytest.raises(ValueError):
        run_workers(n, W.topology, device=device, backend=backend, timeout=10)


def test_initialize_is_a_noop_at_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert port.initialize() is False
    assert port.rank_and_world() == (0, 1)
    assert port.backend_for("cpu") == "gloo" and port.backend_for("cuda:0") == "nccl"
