"""One rank of ``tests/test_torch_parallel.py``'s two-process run on the CPU
(gloo), started by ``medseg_torch.parallel.launch.run_ranks``:

    python tests/torch_dist_worker.py INPUTS.npz OUT_DIR

Joins the group from the ``MEDSEG_*`` variables, then on the inputs the
test wrote: one data-parallel step of the tiny UNETR (its rows of the global
batch), the sharded flat walk in both forms, the sharded z-row walk on
three grids, the all-reduced confusion counts, and the device augmentation
of its rows; writes ``OUT_DIR/rank<r>.npz``. Imports no JAX.
"""

import sys

import numpy as np
import torch

from medseg_torch.engine.state import create_train_state
from medseg_torch.engine.train import make_train_step
from medseg_torch.kernels.unetr_of import class_pad
from medseg_torch.models.unetr import UNETR
from medseg_torch.ops.augment import augment_batch
from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference_sharded
from medseg_torch.ops.swi_zrow import sliding_window_inference_zrow_sharded
from medseg_torch.parallel import make_mesh, psum_metric_counts, shard_batch
from medseg_torch.parallel.mesh import global_batch_rows
from medseg_torch.parallel.runtime import initialize_distributed, process_info

TINY = dict(in_channels=1, out_channels=2, img_size=(16, 16, 16), feature_size=2, hidden_size=8,
            mlp_dim=16, num_heads=2, num_layers=4, patch_size=16)
LR, WD = 1e-3, 1e-5
ZROW_GRIDS = (((20, 18, 14, 3), 0.5), ((40, 36, 32, 1), 0.25), ((8, 8, 8, 2), 0.25))


def voxelwise(w):
    """The voxelwise predictor: (B, C, d, h, w) windows -> (B, K, d, h, w)."""
    return lambda windows: torch.einsum("bcdhw,ck->bkdhw", windows, w)


def weighted_padded(w, k):
    """The flat walk's weighted form (as the fused forward's out head):
    logits times the blend weight, K padded to ``class_pad``."""
    def apply(windows, wgt):
        logits = torch.einsum("bcdhw,ck->bkdhw", windows, w) * wgt
        return torch.nn.functional.pad(logits, (0, 0, 0, 0, 0, 0, 0, class_pad(k) - k))
    return apply


def zrow_apply(w, k):
    """The z-row contract: the weighted logits added into acc at starts."""
    def apply(windows, wgt, starts, acc):
        logits = torch.einsum("bcdhw,ck->bkdhw", windows, w) * wgt
        rd, rh, rw = windows.shape[2:]
        for (d, h, x), o in zip(starts.tolist(), logits):
            acc[:k, d : d + rd, h : h + rh, x : x + rw] += o
    return apply


def main(inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank, world = process_info()
    assert world == 2, world
    data = np.load(inputs)
    mesh = make_mesh("cpu")
    out = {}

    # one data-parallel step on this rank's rows of the global batch
    model = UNETR(**TINY)
    state = create_train_state(model, generator=torch.Generator().manual_seed(0),
                               learning_rate=LR, weight_decay=WD, device="cpu")
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in data.items()
                           if k.startswith("sd/")})  # the JAX weights
    batch = shard_batch(mesh, {"image": torch.from_numpy(data["image"]),
                               "label": torch.from_numpy(data["label"])})
    out["local_rows"] = np.array([batch["image"].shape[0]])
    state, loss = make_train_step(model, task="ct", mesh=mesh)(state, batch)
    mesh.all_reduce_(loss)
    out["loss"] = (loss / world).numpy()
    for name, p in model.named_parameters():
        out[f"param/{name}"] = p.detach().numpy()
        out[f"grad/{name}"] = p.grad.numpy()

    # the sharded flat walk, both forms, and the sharded z-row walk
    w = torch.from_numpy(data["w"])
    spec = SlidingWindowSpec(roi=(8, 8, 8), overlap=0.5, sw_batch=2, mode="gaussian")
    vol = torch.from_numpy(data["vol"])
    out["flat"] = sliding_window_inference_sharded(vol, voxelwise(w), 5, spec, mesh).numpy()
    out["flatk"] = sliding_window_inference_sharded(
        vol, weighted_padded(w, 5), 5, spec, mesh, apply_takes_weight=True).numpy()
    for i, (shape, overlap) in enumerate(ZROW_GRIDS):
        zspec = SlidingWindowSpec(roi=(8, 8, 8), overlap=overlap, mode="gaussian")
        zw = torch.from_numpy(data[f"zrow_w{i}"])
        out[f"zrow{i}"] = sliding_window_inference_zrow_sharded(
            torch.from_numpy(data[f"zrow_vol{i}"]), zrow_apply(zw, 5), 5, zspec, mesh,
            acc_dtype="fp32").numpy()

    # confusion counts of this rank's rows, summed over the ranks
    rows = global_batch_rows(mesh, data["pred"].shape[0] // world)
    out["counts"] = psum_metric_counts(mesh, torch.from_numpy(data["pred"][rows]),
                                       torch.from_numpy(data["target"][rows])).numpy()

    # the augmentation of this rank's rows, decisions drawn for the global batch
    rows = global_batch_rows(mesh, data["aug_image"].shape[0] // world)
    image, label = augment_batch(
        torch.Generator().manual_seed(int(data["aug_seed"])),
        torch.from_numpy(data["aug_image"][rows]), torch.from_numpy(data["aug_label"][rows]),
        flip_prob=0.5, rot_prob=0.5, rank=rank, world=world)
    out["aug_image"], out["aug_label"] = image.numpy(), label.numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
