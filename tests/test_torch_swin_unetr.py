"""``medseg_torch.models.swin_unetr.SwinUNETR`` against the plain reference
(``portbench.reference.swin_unetr``, plain torch over a dict of weights,
nothing of the port), on the CPU at a tiny size: 32^3 crops, feature size
24 (head width 8). The stages' token grids are then 16, 8, 4 and 2: 16 pads
to 21 and 8 to 14 and both shift, 4^3 and 2^3 windows are clamped to the
grid, do not shift and read the first 64 x 64 and 8 x 8 entries of the 7^3
window's relative-position index.

The float32 comparisons run on the CPU's default convolutions. Against a
float64 computation of the same network, a float32 gradient sits ~1e-6
away, or ~1e-3 where one of the decoder's leaky ReLUs has a pre-activation
within rounding of 0 that takes the other sign (``GRAD_TOL``).
"""

from __future__ import annotations

import copy
import itertools
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medseg_torch.engine.evaluate import Validator
from medseg_torch.engine.state import TrainState, adamw
from medseg_torch.engine.train import make_train_step
from medseg_torch.kernels import unetr_of
from medseg_torch.models import swin_unetr as swin
from medseg_torch.ops.sliding_window import SlidingWindowSpec
from portbench import inputs as portbench_inputs
from portbench import judge, params
from portbench.reference import swin_unetr as reference
from portbench.reference.loss import dice_ce

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "portbench" / "configs" / "swin_unetr_btcv.json").read_text())
EDGE, FS, CLASSES = 32, 24, 14
M = dict(CONFIG["model"], img_size=EDGE, feature_size=FS)
# fp32 against fp32: logits agree to ~1.3e-6 of their scale (summation
# order only; each side reads 1.1e-6-1.4e-6 from float64); 1e-4 leaves room
# for a machine's other kernels; the wrong variants below read 0.1-0.7
LOGIT_TOL = 1e-4
# every weight's gradient, as the norm of the difference over the larger of
# the reference's norm and the median weight's, as portbench's judge scales
# it. The decoder's leaky ReLUs set it: a pre-activation within float32
# rounding of 0 may take one sign in the port and the other in the
# reference, and that voxel's gradient then differs 100-fold (slope 1
# against 0.01). Against float64, the reference's float32 gradients read
# ~1e-6 on seeds without such a flip and 2e-4 to 5e-3 on seeds with one or
# two (every weight upstream of the voxel moves), on either of the CPU's
# convolution backends. 3e-2 holds that; a gradient that is missing or wrong
# reads ~1.
GRAD_TOL = 3e-2


class _Arch:  # what judge needs of an architecture file
    parameter_table = staticmethod(reference.parameter_table)
    forward = staticmethod(reference.forward)


def weights(seed: int, table_std: float | None = None) -> dict[str, torch.Tensor]:
    """The benchmark's seeded weights; ``table_std`` redraws the bias tables
    at that scale."""
    w = params.make_weights(_Arch, M, seed, "cpu")
    if table_std is not None:
        g = torch.Generator().manual_seed(seed)
        for name, t in w.items():
            if name.endswith("relative_position_bias_table"):
                w[name] = torch.randn(t.shape, generator=g) * table_std
    return w


def model_of(w: dict, dtype=None, remat: bool = False) -> swin.SwinUNETR:
    model = swin.SwinUNETR(in_channels=1, out_channels=CLASSES, img_size=(EDGE,) * 3,
                           feature_size=FS, dtype=dtype, remat=remat)
    model.load_state_dict(w)
    return model


def tiny_config() -> dict:
    config = copy.deepcopy(CONFIG)
    config["model"], config["train"]["crop"] = M, EDGE
    return config


def inputs(seed: int, batch: int = 1):
    """One of the benchmark's CT batches at the tiny size: an image and its
    labels as regions (random labels, voxel by voxel, leave every gradient a
    sum that nearly cancels, and float32 rounding then reads as a gap)."""
    b = portbench_inputs.train_pool(tiny_config(), {"crops_per_step": batch, "pool": 1},
                                    seed, "cpu")[0]
    return b["image"], b["label"]


def grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """Each weight's ``|got - want|`` over the larger of ``|want|`` and the
    median weight's ``|want|`` (norms)."""
    norms = {k: float(g.norm()) for k, g in want.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return {k: float((got[k] - want[k]).norm()) / max(norms[k], median) for k in want}


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def test_the_state_dict_is_the_reference_table_and_buffers_are_not_in_it():
    w = weights(1)
    model = model_of(w)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {n: tuple(s) for n, s, _, _ in reference.parameter_table(M)}
    buffers = dict(model.named_buffers())
    assert "swinViT.layers1.0.blocks.1.attn.relative_position_index" in buffers
    assert "swinViT.layers1.0.shift_mask" in buffers
    for name in ("swinViT.patch_embed.proj.weight",
                 "swinViT.layers1.0.blocks.1.attn.relative_position_bias_table",
                 "swinViT.layers1.0.downsample.reduction.weight",
                 "encoder10.layer.conv1.conv.weight", "decoder1.transp_conv.conv.weight",
                 "out.conv.conv.weight"):
        assert name in w
    assert "swinViT.layers1.0.downsample.reduction.bias" not in w


def test_relative_position_index_by_brute_force():
    index = swin.relative_position_index(7)
    coords = list(itertools.product(range(7), repeat=3))
    for i in range(0, 343, 17):
        for j in range(0, 343, 13):
            d, h, w = (coords[i][a] - coords[j][a] + 6 for a in range(3))
            assert index[i, j] == d * 169 + h * 13 + w
    assert torch.equal(index, reference.relative_index())
    assert index.min() == 0 and index.max() == 13**3 - 1


@pytest.mark.parametrize("grid", [16, 8, 48])
def test_shift_mask_by_brute_force(grid):
    """Token pairs of a window are masked exactly where their positions on
    the padded grid lie in different bands of some dim: [0, P - 7),
    [P - 7, P - 3), [P - 3, P)."""
    win, shift = swin.window_for((grid,) * 3, 7, 3)
    dims = swin.padded((grid,) * 3, win)
    mask = swin.shift_mask(dims, win, shift)
    p = dims[0]
    assert mask.shape == ((p // 7) ** 3, 343, 343)

    def band(t):
        return 0 if t < p - 7 else 1 if t < p - 3 else 2

    rng = torch.Generator().manual_seed(grid)
    for window in torch.randint(0, mask.shape[0], (4,), generator=rng).tolist():
        wd, wh, ww = window // (p // 7) ** 2, window // (p // 7) % (p // 7), window % (p // 7)
        pos = [(7 * wd + a, 7 * wh + b, 7 * ww + c) for a, b, c in
               itertools.product(range(7), repeat=3)]
        bands = torch.tensor([[band(t) for t in q] for q in pos])
        differ = (bands[:, None, :] != bands[None, :, :]).any(-1)
        assert torch.equal(mask[window] != 0, differ)
        assert set(mask[window].unique().tolist()) <= {0.0, -100.0}


def test_clamped_windows_do_not_shift():
    assert swin.window_for((4, 4, 4), 7, 3) == ((4, 4, 4), (0, 0, 0))
    assert swin.window_for((8, 6, 16), 7, 3) == ((7, 6, 7), (3, 0, 3))
    assert swin.padded((16, 8, 6), (7, 7, 6)) == (21, 14, 6)


def test_version_1_merge_order():
    """The eight slices of PatchMerging (MONAI version 1): the fifth and sixth
    repeat the third and fourth, so two of the eight sub-grids never enter."""
    x = torch.arange(2 * 2 * 2, dtype=torch.float32).view(1, 2, 2, 2, 1)  # value = 4d + 2h + w
    merge = swin.PatchMerging(1)
    with torch.no_grad():
        merge.norm.weight.fill_(1.0)
        merge.norm.bias.zero_()
        merge.reduction.weight.copy_(torch.eye(2, 8))
    order = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in swin.MERGE_ORDER], -1).flatten()
    assert order.tolist() == [0.0, 4.0, 2.0, 1.0, 5.0, 2.0, 1.0, 7.0]
    assert swin.MERGE_ORDER == reference.MERGE
    assert merge(x).shape == (1, 1, 1, 1, 2)


def test_a_window_of_fewer_tokens_reads_the_first_entries_of_the_index():
    attn = swin.WindowAttention(12, 3, 7)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(torch.randn(13**3, 3))
    for n in (8, 64, 216):
        want = attn.relative_position_bias_table[swin.relative_position_index(7)[:n, :n]]
        assert torch.equal(attn.bias(n), want.permute(2, 0, 1))
    # a 4^3 window's own geometry would read other rows
    own = swin.relative_position_index(4)
    assert not torch.equal(swin.relative_position_index(7)[:64, :64], own)


def test_forward_and_every_gradient_match_the_reference_in_fp32():
    w = weights(2)
    x, y = inputs(2)
    model = model_of(w)
    logits = model(x)
    dice_ce(logits, y, "ct").backward()
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = reference.forward(wr, M, x)
    dice_ce(want, y, "ct").backward()
    assert logit_gap(logits, want) < LOGIT_TOL
    gaps = grad_gaps({k: p.grad for k, p in model.named_parameters()},
                     {k: t.grad for k, t in wr.items()})
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < GRAD_TOL, (worst, gaps[worst])
    assert all(float(wr[k].grad.norm()) > 0 for k in wr if "relative_position_bias_table" in k)


def test_the_key_bias_gets_no_gradient():
    """softmax(q k^T + q b_k) is softmax(q k^T): q . b_k is one constant
    along each row, so the key third of every ``attn.qkv.bias`` has a
    gradient of zero up to rounding (why the benchmark's ``change_gap``
    reads above a tenth on the card: AdamW moves those elements on the sign
    of rounding noise)."""
    w = weights(2)
    x, y = inputs(2)
    model = model_of(w)
    dice_ce(model(x), y, "ct").backward()
    for name, p in model.named_parameters():
        if name.endswith("attn.qkv.bias"):
            q, k, v = p.grad.chunk(3)
            assert float(k.norm()) < 1e-4 * min(float(q.norm()), float(v.norm())), name


def test_bf16_logits_within_the_precision():
    """bf16 keeps 8 significant bits (a rounding is up to 2^-9 of the value);
    the roundings in series through the encoder and decoder, partly
    cancelling under the norms, leave the logits ~2% of their scale from
    float32 here; 5% holds that with room. (The float32 tolerance, not this
    one, is what the wrong variants below fail.)"""
    w = weights(3)
    x, _ = inputs(3)
    with torch.no_grad():
        want = reference.forward(w, M, x)
        got = model_of(w, dtype=torch.bfloat16)(x)
    assert got.dtype == torch.bfloat16
    assert logit_gap(got, want) < 0.05


def _no_mask(monkeypatch):
    def forward(self, x):
        for blk in self.blocks:
            x = blk(x, torch.zeros_like(self.shift_mask))
        return self.downsample(x)

    monkeypatch.setattr(swin.BasicLayer, "forward", forward)


def _merge_v2(monkeypatch):
    monkeypatch.setattr(swin, "MERGE_ORDER", tuple(itertools.product(range(2), repeat=3)))


def _own_index(monkeypatch):
    def bias(self, n):
        edge = round(n ** (1 / 3))
        coords = torch.stack(torch.meshgrid(*(torch.arange(edge),) * 3, indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + 6
        index = rel[..., 0] * 169 + rel[..., 1] * 13 + rel[..., 2]
        table = self.relative_position_bias_table
        return table[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1).contiguous()

    monkeypatch.setattr(swin.WindowAttention, "bias", bias)


@pytest.mark.parametrize("variant", [_no_mask, _merge_v2, _own_index],
                         ids=["no-shift-mask", "PatchMergingV2-order", "unsliced-index"])
def test_wrong_variants_fail_the_same_tolerance(monkeypatch, variant):
    """The bias tables drawn at N(0, 1): large enough that a wrong row of the
    table moves the logits; the right module passes at this scale too."""
    w = weights(4, table_std=1.0)
    x, _ = inputs(4)
    with torch.no_grad():
        want = reference.forward(w, M, x)
        assert logit_gap(model_of(w)(x), want) < LOGIT_TOL
        variant(monkeypatch)
        assert logit_gap(model_of(w)(x), want) > 10 * LOGIT_TOL


def test_one_train_step_matches_the_reference_step():
    """``make_train_step`` in fp32 (fused DiceCE, remat, the program's AdamW)
    against the reference's DiceCE, gradients and AdamW on a batch of 2
    crops, in the judge's numbers: the loss, each weight's first-gradient
    norm (AdamW's first moment; ``GRAD_TOL``'s reason) and its change after
    the step."""
    w = weights(5)
    config = tiny_config()
    x, y = inputs(5, batch=2)
    batch = {"image": x, "label": y}
    model = model_of(w, remat=True).train()
    state = TrainState(model, adamw(model.parameters(), CONFIG["train"]["learning_rate"],
                                    CONFIG["train"]["weight_decay"]), 0, torch.Generator())
    from portbench.train import program_readings

    got = program_readings(state, copy.deepcopy(w), make_train_step(model, task="ct"), [batch])
    ref = judge.reference_steps(_Arch, w, config, [batch], "cpu")
    numbers = judge.train_numbers(got, ref)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < GRAD_TOL, numbers
    # Adam's first step moves each element by about lr * sign(g): a gradient
    # element within rounding of 0 may take either sign
    assert numbers["change_gap"] < 2e-2, numbers


def _spans(prof, name: str) -> int:
    return sum(1 for e in prof.events() if e.name == name)


@pytest.mark.parametrize("remat", [False, True])
def test_profiled_step_records_the_encoder_once_and_each_blocks_attention(remat):
    """8 blocks (2 in each of 4 stages): one ``medseg.swin.encoder`` and 8
    ``medseg.swin.attention`` spans a forward; remat's recompute in the
    backward records the 8 attention spans again, and no encoder span."""
    model = model_of(weights(6), remat=remat).train()
    state = TrainState(model, adamw(model.parameters(), 1e-4, 1e-5), 0, torch.Generator())
    step = make_train_step(model, task="ct")
    x, y = inputs(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, {"image": x, "label": y})
    assert _spans(prof, "medseg.swin.encoder") == 1
    assert _spans(prof, "medseg.swin.attention") == (16 if remat else 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    assert (_spans(prof, "medseg.swin.encoder"), _spans(prof, "medseg.swin.attention")) == (1, 8)


def test_the_serving_predicate_answers_false_for_a_swin_unetr():
    model = model_of(weights(7))
    for device in ("cpu", "cuda"):
        assert unetr_of.fast_path_supported(model, (4, 1, 96, 96, 96), device) is False


def test_the_validator_serves_a_swin_unetr_through_its_module_walk():
    w = weights(8)
    config = copy.deepcopy(CONFIG)
    config["model"] = M
    config["serve"].update(roi=EDGE, sw_batch=2)
    s = config["serve"]
    spec = SlidingWindowSpec(roi=(EDGE,) * 3, overlap=s["overlap"], sw_batch=s["sw_batch"],
                             mode=s["mode"], sigma_scale=s["sigma_scale"])
    validator = Validator(model_of(w), CLASSES, "ct", spec, use_fast_path=True, device="cpu")
    assert validator.use_fast_path is False and validator.graphed is None
    volume = torch.rand((40, 36, 44, 1), generator=torch.Generator().manual_seed(8))
    got = validator.infer_volume(volume)
    want = judge.reference_logits(_Arch, w, config, volume, "cpu")
    assert got.shape == want.shape == (40, 36, 44, CLASSES)
    assert logit_gap(got, want) < LOGIT_TOL
