"""Multi-process runtime: joining the process group, and per-rank data
sharding (counterpart of ``medseg/parallel/runtime.py``).

The JAX package runs one process per host, joined by
``jax.distributed.initialize``; each process loads its ``rank::world``
slice of the datalist and contributes its local batch to globally sharded
arrays. Here one process drives one device (one rank per card, or several
ranks sharing a card), joined by ``torch.distributed``:

- ``initialize_distributed`` reads the JAX package's variables,
  ``MEDSEG_COORDINATOR`` (``host:port``, or an ``init_method`` URL such as
  ``file:///shared/path``), ``MEDSEG_NUM_PROCESSES`` and
  ``MEDSEG_PROCESS_ID``; with ``MEDSEG_DISTRIBUTED=1`` alone it reads
  torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (the counterpart of JAX's auto-detection). Backend: NCCL where every local
  rank has a card of its own, gloo on the CPU and where local ranks share a
  card (NCCL refuses two ranks on one GPU); the choice is printed. Each rank
  selects its card (``LOCAL_RANK``, else its rank, modulo the cards) before
  the group is made. The local ranks are ``LOCAL_WORLD_SIZE`` (torchrun sets
  it; set it by hand where the ``MEDSEG_*`` processes span several hosts),
  else all the processes;
- ``shard_datalist`` (``items[rank::world]``), ``per_host_batch_size``,
  ``shard_batch_multihost`` (with the local-batch guard) and
  ``replicate_multihost`` (``mesh.replicate``: a broadcast from rank 0),
  ``barrier`` and ``global_mesh``.

Launch on N processes (the segmentation CLI calls ``initialize_distributed``
itself)::

    MEDSEG_COORDINATOR=localhost:29500 MEDSEG_NUM_PROCESSES=2 MEDSEG_PROCESS_ID=0 \\
        python -m medseg_torch.cli.segmentation ... --data-parallel &
    MEDSEG_COORDINATOR=localhost:29500 MEDSEG_NUM_PROCESSES=2 MEDSEG_PROCESS_ID=1 \\
        python -m medseg_torch.cli.segmentation ... --data-parallel

or ``MEDSEG_DISTRIBUTED=1 torchrun --nproc-per-node 2 -m
medseg_torch.cli.segmentation ...``.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from medseg_torch.parallel.mesh import Mesh, make_mesh, replicate

ENV = ("MEDSEG_DISTRIBUTED", "MEDSEG_COORDINATOR", "MEDSEG_NUM_PROCESSES", "MEDSEG_PROCESS_ID")
TIMEOUT = datetime.timedelta(minutes=10)  # of the group's collectives and its rendezvous


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why) for ranks on ``device``: NCCL where each of the
    ``local_world`` ranks of this host has a card of its own, gloo on the
    CPU and where they share cards."""
    if device.type != "cuda":
        return "gloo", f"device {device}"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} local rank(s) on {cards} card(s)"
    return "gloo", f"{local_world} local ranks share {cards} card(s), which NCCL refuses"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: torch.device | str = "cuda",
) -> str | None:
    """Join (or bootstrap) the process group; returns its backend, or None
    where the run stays one process.

    A no-op when a group exists already, with ``num_processes == 1``, and
    without any configuration (no argument, none of the ``MEDSEG_*``
    variables). Explicit arguments win over the variables; what is still
    missing under ``MEDSEG_DISTRIBUTED=1`` comes from torchrun's. On a CUDA
    ``device`` each rank selects its card before the group is made.
    """
    if dist.is_initialized():
        return dist.get_backend()
    coordinator = coordinator_address or os.environ.get("MEDSEG_COORDINATOR") or None
    if num_processes is None:
        num_processes = _env_int("MEDSEG_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MEDSEG_PROCESS_ID")
    if num_processes == 1:
        return None  # single-process run: nothing to join
    auto = os.environ.get("MEDSEG_DISTRIBUTED", "0") == "1"
    if coordinator is None and num_processes is None and process_id is None and not auto:
        return None  # no multi-process configuration: one process
    if auto:  # torchrun's variables fill what is missing
        if coordinator is None and "MASTER_ADDR" in os.environ:
            coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        process_id = process_id if process_id is not None else _env_int("RANK")
    missing = [name for name, v in (("coordinator", coordinator), ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"multi-process configuration incomplete: no {missing} (set "
                         "MEDSEG_COORDINATOR, MEDSEG_NUM_PROCESSES and MEDSEG_PROCESS_ID, "
                         "or launch with torchrun and MEDSEG_DISTRIBUTED=1)")
    if num_processes == 1:
        return None
    device = torch.device(device)
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device (pass device='cpu' to run "
                               "the ranks on the CPU)")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    chosen, why = choose_backend(device, local_world)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    print(f"[medseg_torch.parallel] rank {process_id}/{num_processes}: backend {chosen} ({why}), "
          f"init {init_method}", file=sys.stderr, flush=True)
    dist.init_process_group(chosen, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return chosen


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier(name: str = "barrier") -> None:
    """Every rank waits here until all have reached it (e.g. between rank 0
    committing a checkpoint and the others reading it). No-op with one
    process. ``name`` labels the point in the error of a failed wait."""
    if process_info()[1] <= 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def shard_datalist(items: list, process_index: int | None = None,
                   process_count: int | None = None) -> list:
    """This rank's slice of a datalist: ``items[rank::world]``.

    Deterministic, disjoint, covering; stride (not blocks) so that volumes
    of different sizes spread evenly. One process: the full list."""
    rank, world = process_info()
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    if process_count <= 1:
        return list(items)
    return list(items)[process_index::process_count]


def per_host_batch_size(global_batch: int, process_count: int | None = None) -> int:
    if process_count is None:
        process_count = process_info()[1]
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} not divisible by {process_count} hosts")
    return global_batch // process_count


def shard_batch_multihost(mesh: Mesh, batch: dict, expected_local_batch: int | None = None,
                          ) -> dict:
    """This rank's LOCAL batch (leading dim = global batch / ranks) on the
    mesh's device, as ``cli.common.device_put_batch`` puts it there.

    ``expected_local_batch`` guards the data-parallel contract: every rank
    must contribute the same local batch at every step, or the mean of the
    ranks' gradients is not the global batch's gradient (and, JAX's case, the
    global shapes diverge). A mismatch raises on the rank at fault; loaders
    that cycle a dataset use ``drop_last``."""
    from medseg_torch.cli.common import device_put_batch

    if mesh.data > 1 and expected_local_batch is not None:
        for key, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object and v.shape[0] != expected_local_batch:
                raise ValueError(
                    f"rank {mesh.rank}: batch leaf {key!r} has local batch {v.shape[0]} != "
                    f"expected {expected_local_batch}; the ranks' gradients would average "
                    "unequal batches (use drop_last=True on the loader)"
                )
    return device_put_batch(batch, mesh.device)


# a process's values are its own in torch: replicating them is the broadcast
replicate_multihost = replicate


def global_mesh(device: torch.device | str | None = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over all processes' devices."""
    return make_mesh(device, model_parallel=model_parallel)


__all__ = ["ENV", "initialize_distributed", "process_info", "barrier", "shard_datalist",
           "per_host_batch_size", "shard_batch_multihost", "replicate_multihost", "global_mesh",
           "choose_backend"]
