"""The port's runtime helpers, debug modes and profiler capture on the CPU,
one process (the two-process runs are in ``tests/test_torch_parallel.py``).

- ``shard_datalist`` and ``per_host_batch_size`` equal the JAX package's
  over a grid of (rank, world), errors included;
- ``initialize_distributed``'s no-op cases, its error for an incomplete
  configuration, and its backend choice (NCCL only where every local rank
  has a card of its own);
- ``shard_batch_multihost`` raises on the rank whose local batch differs;
- the mesh of one process: the collectives are identities, ``shard_batch``
  takes the whole batch, ``all_reduce_gradients`` refuses a missing
  gradient;
- ``nan_checks`` raises at a NaN made in a forward, ``strict_mode`` at an
  infinity, both restore anomaly mode and remove their hooks; ``trace``
  writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from medseg.parallel import runtime as jruntime
from medseg_torch.parallel import make_mesh, replicate, shard_batch
from medseg_torch.parallel import runtime
from medseg_torch.parallel.mesh import Mesh, all_reduce_gradients, global_batch_rows
from medseg_torch.utils import debug, profiling

GRID = [(rank, world) for world in (1, 2, 3, 4) for rank in range(world)]


@pytest.mark.parametrize("rank,world", GRID)
def test_shard_datalist_matches_jax(rank, world):
    items = [{"image": f"img{i}"} for i in range(10)]
    got = runtime.shard_datalist(items, rank, world)
    assert got == jruntime.shard_datalist(items, rank, world)
    if world > 1:
        assert got == items[rank::world]


@pytest.mark.parametrize("global_batch,world", [(8, 1), (8, 2), (8, 4), (12, 3), (6, 4), (5, 2)])
def test_per_host_batch_size_matches_jax(global_batch, world):
    if global_batch % world:
        for fn in (runtime.per_host_batch_size, jruntime.per_host_batch_size):
            with pytest.raises(ValueError, match="not divisible"):
                fn(global_batch, world)
    else:
        assert (runtime.per_host_batch_size(global_batch, world)
                == jruntime.per_host_batch_size(global_batch, world) == global_batch // world)


@pytest.fixture
def clean_env(monkeypatch):
    for var in runtime.ENV + ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,kwargs", [
    ({}, {}),
    ({"MEDSEG_NUM_PROCESSES": "1"}, {}),
    ({"MEDSEG_NUM_PROCESSES": "1", "MEDSEG_COORDINATOR": "localhost:1234"}, {}),
    ({"MEDSEG_DISTRIBUTED": "1", "MEDSEG_NUM_PROCESSES": "1"}, {}),
    ({"MEDSEG_DISTRIBUTED": "1", "WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "localhost"}, {}),
    ({}, {"num_processes": 1, "coordinator_address": "localhost:1234", "process_id": 0}),
])
def test_initialize_distributed_no_op_cases(clean_env, env, kwargs):
    for name, value in env.items():
        clean_env.setenv(name, value)
    assert runtime.initialize_distributed(device="cpu", **kwargs) is None
    assert not torch.distributed.is_initialized()
    assert runtime.process_info() == (0, 1)
    runtime.barrier("no group")  # one process: returns at once


def test_initialize_distributed_is_a_no_op_when_joined(clean_env, tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                                         world_size=1, rank=0)
    try:
        clean_env.setenv("MEDSEG_NUM_PROCESSES", "2")
        assert runtime.initialize_distributed(device="cpu") == "gloo"
        mesh = make_mesh("cpu")
        assert (mesh.data, mesh.rank, mesh.backend, mesh.shape) == (1, 0, "gloo",
                                                                    {"data": 1, "model": 1})
        t = torch.arange(4.0)
        assert torch.equal(mesh.all_reduce_(t.clone()), t)  # a real collective of one rank
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("env", [
    {"MEDSEG_COORDINATOR": "localhost:1234"},
    {"MEDSEG_NUM_PROCESSES": "2", "MEDSEG_PROCESS_ID": "0"},
    {"MEDSEG_DISTRIBUTED": "1", "WORLD_SIZE": "2"},
])
def test_incomplete_configuration_names_what_is_missing(clean_env, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    with pytest.raises(ValueError, match="incomplete: no"):
        runtime.initialize_distributed(device="cpu")


@pytest.mark.parametrize("device,local_world,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 8, 4, "gloo"),
])
def test_backend_choice(monkeypatch, device, local_world, cards, backend):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert runtime.choose_backend(torch.device(device), local_world)[0] == backend


def test_shard_batch_multihost_guards_the_local_batch():
    mesh = Mesh(None, 2, 1, torch.device("cpu"), "gloo")  # rank 1 of 2
    batch = {"image": np.zeros((3, 8, 8, 8, 1), np.float32), "name": ["a", "b", "c"]}
    with pytest.raises(ValueError, match="rank 1: batch leaf 'image' has local batch 3 != "
                                         "expected 4"):
        runtime.shard_batch_multihost(mesh, batch, expected_local_batch=4)
    out = runtime.shard_batch_multihost(mesh, batch, expected_local_batch=3)
    assert out["image"].shape == (3, 1, 8, 8, 8) and out["name"] == ["a", "b", "c"]


def test_mesh_of_one_process():
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.data, mesh.rank) == (None, 1, 0)
    batch = {"image": torch.arange(8.0).reshape(4, 2), "name": "x"}
    assert torch.equal(shard_batch(mesh, batch)["image"], batch["image"])
    assert global_batch_rows(mesh, 4) == slice(0, 4)
    model = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    replicate(mesh, model)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="has no gradient"):
        all_reduce_gradients(mesh, model)
    two = Mesh(None, 2, 1, torch.device("cpu"), None)
    assert torch.equal(shard_batch(two, batch)["image"], batch["image"][2:])
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        shard_batch(two, {"image": torch.zeros(3)})


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


@pytest.mark.parametrize("mode,value,raises", [
    (debug.nan_checks, -1.0, "NaN in the output of _Log"),
    (debug.nan_checks, 0.0, None),  # -inf passes nan_checks
    (debug.strict_mode, 0.0, "infinity in the output of _Log"),
    (debug.strict_mode, -1.0, "NaN in the output of _Log"),
])
def test_debug_modes_raise_and_restore(mode, value, raises):
    was = torch.is_anomaly_enabled()
    x = torch.tensor([value])
    if raises:
        with pytest.raises(FloatingPointError, match=raises):
            with mode():
                _Log()(x)
    else:
        with mode():
            assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
            _Log()(x)
    assert torch.is_anomaly_enabled() == was
    _Log()(torch.tensor([-1.0]))  # the hook is gone


def test_nan_checks_catch_a_nan_made_in_backward():
    x = torch.tensor([0.0], requires_grad=True)
    with debug.nan_checks():
        y = torch.sqrt(x) * 0.0  # sqrt's backward at 0 gives inf * 0 = NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and prof is not None
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)
