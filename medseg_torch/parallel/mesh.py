"""The data-parallel mesh and its collectives (counterpart of
``medseg/parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh,
replicates parameters and optimizer state, and lets XLA insert the gradient
all-reduce. Here every rank of a ``torch.distributed`` process group drives
one device, and the collectives are explicit:

- ``shard_batch`` takes this rank's contiguous rows of a global batch (the
  JAX ``P("data")`` layout); ``replicate`` broadcasts tensors from rank 0;
- ``all_reduce_gradients`` averages the gradients over the ranks after
  ``backward``: one all-reduce per dtype of one flat buffer, in
  ``model.parameters()`` order, so that every rank issues the same
  collectives in the same order (the psum XLA places);
- ``psum_metric_counts`` sums the (C, 4) confusion counts of each rank's
  batch rows over the ranks.

The ``model`` axis is 1, as every JAX preset has it. ``NamedSharding`` has
no counterpart: a tensor lives on its rank's device. A gloo group (the CPU,
or ranks that share one card) reduces CUDA tensors through host copies,
which ``Mesh`` makes explicitly and logs once; no collective error is caught.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from medseg_torch.ops.metrics import confusion_counts

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The (data, model) mesh of this process: ``data`` ranks of the process
    group ``group`` (None: one process, no group), this process's ``rank``
    and ``device``, the group's ``backend``; ``model`` is 1. ``collectives``
    counts the all-reduces and broadcasts it issued to the group."""

    def __init__(self, group, data: int, rank: int, device: torch.device,
                 backend: str | None) -> None:
        self.group = group
        self.data = data
        self.rank = rank
        self.device = device
        self.backend = backend
        self.model = 1
        self.collectives = 0
        self._staging_logged = False

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def _through_host(self, t: torch.Tensor) -> bool:
        staged = self.backend == "gloo" and t.device.type == "cuda"
        if staged and not self._staging_logged:
            self._staging_logged = True
            print(f"[medseg_torch.parallel] rank {self.rank}/{self.data}: gloo collectives on "
                  f"{t.device} tensors go through host copies", file=sys.stderr, flush=True)
        return staged

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; identity without a group."""
        if self.group is None:
            return t
        self.collectives += 1
        if self._through_host(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.group is None:
            return t
        self.collectives += 1
        if self._through_host(t):
            host = t.cpu()
            dist.broadcast(host, src=src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src=src, group=self.group)
        return t


def make_mesh(device: torch.device | str | None = None, *, model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over the ranks of the default process group,
    one ``device`` per rank (default: this rank's current CUDA device); one
    process without a group gives a mesh of one rank."""
    if model_parallel != 1:
        raise ValueError(f"model_parallel={model_parallel}: the port's mesh has a model axis of 1")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(None, 1, 0, device, None)
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), device,
                dist.get_backend())


def _rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.data:
        raise ValueError(f"global batch {n} not divisible by {mesh.data} ranks")
    per = n // mesh.data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous rows of every tensor or array of a global
    ``batch`` (leading dim divisible by the ranks), on the mesh's device."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) or hasattr(v, "__array__"):
            t = torch.as_tensor(v)
            out[k] = t[_rows(mesh, t.shape[0])].to(mesh.device)
        else:
            out[k] = v
    return out


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [t for t in tree.state_dict().values() if isinstance(t, torch.Tensor)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _coalesced(mesh: Mesh, tensors: list[torch.Tensor], op) -> None:
    """``op`` (an in-place collective of the mesh) over one flat buffer per
    dtype of ``tensors``, in their order, written back."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        parts = torch.split(flat, [t.numel() for t in group])
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(parts, group)])  # one launch


def replicate(mesh: Mesh, tree):
    """Rank 0's values of a module's state (parameters and buffers), a
    tensor, or a dict or list of tensors on every rank, in place; returns
    ``tree``. The train state's module after seeded initialisation or a
    restore is identical on every rank already; this makes it so."""
    if mesh.group is not None:
        with torch.no_grad():
            _coalesced(mesh, _tensors(tree), mesh.broadcast_)
    return tree


def all_reduce_gradients(mesh: Mesh, model: torch.nn.Module) -> None:
    """Average the gradients of ``model`` over the ranks, in place: the
    counterpart of the psum XLA inserts for a sharded batch. Every
    parameter must hold a gradient (``engine.state.apply_gradients`` fills
    the missing ones with zeros before this runs), so that every rank
    reduces the same buffer. The DiceCE is a mean over samples, so the mean
    of equal local batches' gradients is the global batch's gradient."""
    grads = []
    for name, p in model.named_parameters():
        if p.grad is None:
            raise ValueError(f"parameter {name} has no gradient; fill it before the all-reduce")
        grads.append(p.grad)
    if mesh.group is None:
        return
    scale = 1.0 / mesh.data

    def mean_(flat: torch.Tensor) -> None:
        mesh.all_reduce_(flat)
        flat.mul_(scale)

    with torch.no_grad():
        _coalesced(mesh, grads, mean_)


def psum_metric_counts(mesh: Mesh, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(C, 4) float32 [tp, fp, tn, fn] confusion counts over every rank's
    batch rows: each rank counts its (B_local, ..., C) channels-last masks,
    one all-reduce (int64, exact) sums them; every rank gets the totals."""
    counts = confusion_counts(pred, target).sum(0).to(torch.int64)
    return mesh.all_reduce_(counts).float()


def global_batch_rows(mesh: Mesh, local_batch: int) -> slice:
    """The rows of the global batch (``local_batch`` x ranks) that this rank
    holds: the contiguous block ``shard_batch`` takes."""
    return _rows(mesh, local_batch * mesh.data)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "shard_batch", "replicate",
           "all_reduce_gradients", "psum_metric_counts", "global_batch_rows"]
