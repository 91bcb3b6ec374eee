"""The fused serving forward split into a body and two exits, and its CUDA
graph runner (``kernels.unetr_of.GraphedForward``).

On the CPU: ``fused_body`` followed by ``outhead_exit`` (K3) or
``outhead_row_exit`` (K4) gives the bits of the chain written as one
function (``_unsplit``, the forward as it stood before the split), at C_in 1
(CT, 14 classes) and C_in 4 (BraTS, 4 outputs); the ``Validator`` never
captures on the CPU and gives the bits of its walks run with
``fast_apply_v3``; and the runner's policy, run against a stand-in for the
graph object (eager at a shape's first batch, capture at its second, replay
after; a graph per shape, a bounded number of them, one shared pool, the
launch counters counting what the host issues and nothing at a replay).

On the card (marked ``cuda``, skipped without one, as
``tests/test_torch_kernels_cuda.py``; run there with
``python -m pytest tests/test_torch_graphed_forward.py --noconftest -q``):
the graphed z-row walk of a 512x512x160 CT volume and the graphed flat walk
of a 240x240x155x4 BraTS volume against the same walks run eagerly, bit for
bit, with one capture per shape; the kernels a graphed volume runs, read
from a profiler trace, are the eager volume's, name by name and count by
count.
"""

from collections import Counter


import numpy as np
import pytest
import torch

from medseg_torch.engine.evaluate import Validator
from medseg_torch.kernels import conv_of
from medseg_torch.kernels.kernel_check import trace_kernels
from medseg_torch.kernels import unetr_of as tuo
from medseg_torch.models import unetr as tunetr
from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference
from medseg_torch.ops.swi_zrow import sliding_window_inference_zrow

ROI = 32
CASES = {"ct": (1, 14), "brats": (4, 4)}  # C_in, classes
ACC = {"fp32": torch.float32, "bf16": torch.bfloat16}
STARTS = torch.tensor([[0, 0, 0], [8, 4, 12]], dtype=torch.int32)  # in a (40, 36, 44) volume
SPEC = SlidingWindowSpec(roi=(ROI,) * 3, overlap=0.5, sw_batch=3, mode="gaussian")
VOLUMES = {"zrow": (40, 36, 44), "flat": (30, 36, 44)}  # odd pad: the flat walk


def _model(case: str, dtype=torch.bfloat16) -> tunetr.UNETR:
    c_in, classes = CASES[case]
    model = tunetr.UNETR(in_channels=c_in, out_channels=classes, img_size=(ROI,) * 3,
                         feature_size=8, hidden_size=24, mlp_dim=48, num_heads=4, num_layers=2,
                         dtype=dtype)
    return tunetr.init_weights(model, torch.Generator().manual_seed(3)).eval()


def _windows(case: str, batch: int = 2, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, CASES[case][0], ROI, ROI, ROI), generator=g)
    wgt = 0.25 + torch.rand((batch, 1, ROI, ROI, ROI), generator=g)
    return x, wgt


def _acc(model, dtype) -> torch.Tensor:
    return torch.zeros((tuo.class_pad(model.out_channels), 40, 36, 44), dtype=dtype)


@torch.no_grad()
def _unsplit(model, x, weights, out_scale, starts=None, acc=None):
    """The fused chain as one function, as ``fast_apply_v3`` had it before
    its body and exits were split."""
    fs, dtype = model.feature_size, model.dtype or torch.float32
    b, c_in, d, h, w = x.shape
    n_valid = d * h * w

    def cw(conv):
        return weights[f"{conv}.conv.weight"]

    enc2, dec2 = tuo._lowres_stages(model, x)
    dec1 = tuo.up_block_of(model, "decoder3", dec2, enc2, weights)
    e1 = model.encoder1.layer
    xd = x.to(dtype).contiguous()
    if c_in == 1:
        y1, s1, ss1 = conv_of.conv3x3x3_of(xd, cw("encoder1.layer.conv1"))
        k3 = e1.conv3.conv.weight.float().reshape(fs)
        xf = x.float()
        sx = xf.sum((1, 2, 3, 4))
        ssx = xf.square().sum((1, 2, 3, 4))
        a3, b3 = tuo._affine(sx[:, None] * k3[None], ssx[:, None] * k3.square()[None], e1.norm3,
                             n_valid)
        ax, bx = a3 * k3[None], b3
        x_stream = xd
    else:
        y1, s1, ss1, x_stream, rs3, rss3 = conv_of.conv3x3x3_of(
            xd, cw("encoder1.layer.conv1"), wres=cw("encoder1.layer.conv3"))
        ax, bx = tuo._affine(rs3, rss3, e1.norm3, n_valid)
    a1, b1 = tuo._affine(s1, ss1, e1.norm1, n_valid)
    y2, s2, ss2 = conv_of.conv3x3x3_of(y1, cw("encoder1.layer.conv2"), a1, b1)
    a2, b2 = tuo._affine(s2, ss2, e1.norm2, n_valid)
    up = tuo._upsample(weights, "decoder2", dec1)
    d2 = model.decoder2.conv_block
    z1, zs1, zss1, res, rs, rss = conv_of.conv3x3x3_of_combine(
        up, y2, x_stream, a2, b2, ax, bx, cw("decoder2.conv_block.conv1"),
        cw("decoder2.conv_block.conv3"))
    za1, zb1 = tuo._affine(zs1, zss1, d2.norm1, n_valid)
    z2, zs2, zss2 = conv_of.conv3x3x3_of(z1, cw("decoder2.conv_block.conv2"), za1, zb1)
    za2, zb2 = tuo._affine(zs2, zss2, d2.norm2, n_valid)
    za3, zb3 = tuo._affine(rs, rss, d2.norm3, n_valid)
    head, bias = weights["out.weight"], weights["out.bias"]
    if acc is not None:
        conv_of.outhead_row_of(z2, res, za2, zb2, za3, zb3, head, bias, out_scale, starts, acc)
        return None
    return conv_of.outhead_of(z2, res, za2, zb2, za3, zb3, head, bias, out_scale)


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the split: body + exit against the unsplit chain (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("exit_", ["k3", "k4-fp32", "k4-bf16"])
def test_body_and_exit_give_the_unsplit_chains_bits(case, exit_):
    model = _model(case)
    weights = tuo.fused_weights(model)
    x, wgt = _windows(case)
    parts = tuo.fused_body(model, x, weights)
    assert len(parts) == 6 and parts[0].dtype == torch.bfloat16
    if exit_ == "k3":
        want = _unsplit(model, x, weights, wgt)
        _same(tuo.outhead_exit(weights, parts, wgt), want)
        _same(tuo.fast_apply_v3(model, x, weights, out_scale=wgt), want)
        return
    dtype = ACC[exit_.split("-")[1]]
    want, got, whole = _acc(model, dtype), _acc(model, dtype), _acc(model, dtype)
    _unsplit(model, x, weights, wgt, STARTS, want)
    tuo.outhead_row_exit(weights, parts, wgt, STARTS, got)
    assert tuo.fast_apply_v3(model, x, weights, out_scale=wgt, starts=STARTS, acc=whole) is None
    assert want.abs().sum() > 0
    _same(got, want)
    _same(whole, want)


# ---------------------------------------------------------------------------
# the Validator on the CPU: no graph, the walks' bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("walk", sorted(VOLUMES))
def test_cpu_validator_never_captures_and_gives_the_walks_bits(walk):
    model = _model("ct")
    weights = tuo.fused_weights(model)
    image = np.random.default_rng(5).normal(size=VOLUMES[walk] + (1,)).astype(np.float32)
    validator = Validator(model, 14, "ct", SPEC, acc_dtype="bf16", device="cpu")
    assert validator.use_fast_path
    got = validator.infer_volume(image)
    got_again = validator.infer_volume(image)  # every shape seen before: still eager
    with torch.no_grad():
        if walk == "zrow":
            want = sliding_window_inference_zrow(
                image, lambda w, g, s, a: tuo.fast_apply_v3(model, w, weights, out_scale=g,
                                                            starts=s, acc=a),
                14, SPEC, device="cpu", acc_dtype="bf16")
        else:
            want = sliding_window_inference(
                image, lambda w, g: tuo.fast_apply_v3(model, w, weights, out_scale=g), 14, SPEC,
                device="cpu", apply_takes_weight=True, acc_dtype="bf16")
    _same(got, want)
    _same(got_again, want)
    assert validator.graphed.captures == validator.graphed.replays == 0


# ---------------------------------------------------------------------------
# the capture policy against a stand-in for the graph object (CPU)
# ---------------------------------------------------------------------------

CAPTURED_LAUNCHES = {(conv_of.conv3x3x3_of, "launches"): 3,
                     (conv_of.conv3x3x3_of, "narrow_launches"): 1,
                     (conv_of.outhead_of, "tc_launches"): 1}


class StandInGraph:
    """Captures by running the chain once; replays by running it again into
    the static outputs (what a CUDA graph's replay leaves there)."""

    def __init__(self) -> None:
        self.fn = self.outs = None

    def replay(self) -> None:
        for static, fresh in zip(_tensors(self.outs), _tensors(self.fn())):
            static.copy_(fresh)

    def pool(self):
        return "the pool"


class StandInGraphs:
    """The runner's backend on the CPU. Its capture also adds what the
    wrappers count while the host issues a chain into a graph on the card
    (``CAPTURED_LAUNCHES``; on the CPU the plain versions count nothing)."""

    def __init__(self) -> None:
        self.pools = []

    @staticmethod
    def captures(x) -> bool:
        return True

    @staticmethod
    def new_graph():
        return StandInGraph()

    def capture(self, graph, fn, pool):
        self.pools.append(pool)
        graph.fn, graph.outs = fn, fn()
        for (wrapper, name), n in CAPTURED_LAUNCHES.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)
        return graph.outs


def _tensors(outs):
    return outs if isinstance(outs, tuple) else (outs,)


def _counters():
    return {key: getattr(*key) for key in CAPTURED_LAUNCHES}


@pytest.fixture
def counters():
    conv_of.reset_launches()
    yield
    conv_of.reset_launches()


@pytest.mark.parametrize("exit_", ["k3", "k4"])
def test_eager_first_capture_second_replay_after(counters, exit_):
    model = _model("brats")
    weights = tuo.fused_weights(model)
    backend = StandInGraphs()
    runner = tuo.GraphedForward(model, weights, graphs=backend)
    eager_acc, acc = _acc(model, torch.float32), _acc(model, torch.float32)
    seen = []
    for seed in range(4):  # a new batch of the same shape each call
        x, wgt = _windows("brats", seed=10 + seed)
        if exit_ == "k3":
            _same(runner(x, wgt), tuo.fast_apply_v3(model, x, weights, out_scale=wgt))
        else:
            assert runner(x, wgt, STARTS, acc) is None
            tuo.fast_apply_v3(model, x, weights, out_scale=wgt, starts=STARTS, acc=eager_acc)
            _same(acc, eager_acc)
        seen.append((runner.captures, runner.replays))
    assert seen == [(0, 0), (1, 1), (1, 2), (1, 3)]
    assert backend.pools == [None]
    (entry,) = runner._captured.values()
    assert (entry.scale is None) == (exit_ == "k4")  # K4's weight goes to its eager launch
    assert len(_tensors(entry.outs)) == (6 if exit_ == "k4" else 1)


def test_each_shape_gets_a_graph_of_its_own_and_their_number_is_bounded(counters, monkeypatch):
    monkeypatch.setattr(tuo, "MAX_GRAPHS", 2)
    model = _model("ct")
    weights = tuo.fused_weights(model)
    backend = StandInGraphs()
    runner = tuo.GraphedForward(model, weights, graphs=backend)
    for batch in (1, 2, 3):
        x, wgt = _windows("ct", batch=batch)
        for _ in range(2):
            _same(runner(x, wgt), tuo.fast_apply_v3(model, x, weights, out_scale=wgt))
    assert runner.captures == 3 and runner.replays == 3
    assert [key[1][0] for key in runner._captured] == [2, 3]  # the oldest went first
    assert backend.pools == [None, "the pool", "the pool"]  # one pool, shared
    x, wgt = _windows("ct", batch=1)  # seen before, evicted: captured again at once
    _same(runner(x, wgt), tuo.fast_apply_v3(model, x, weights, out_scale=wgt))
    assert runner.captures == 4 and len(runner._captured) == 2
    # the accumulating exit is a shape of its own beside the same batch's K3 graph
    acc = _acc(model, torch.float32)
    runner(x, wgt, STARTS[:1], acc)
    assert runner.captures == 4 and len(runner._captured) == 2


@pytest.mark.parametrize("exit_", ["k3", "k4"])
def test_launch_counters_count_what_the_host_issues(counters, exit_):
    model = _model("ct")
    weights = tuo.fused_weights(model)
    runner = tuo.GraphedForward(model, weights, graphs=StandInGraphs())
    x, wgt = _windows("ct")
    acc = _acc(model, torch.float32)
    zero = {key: 0 for key in CAPTURED_LAUNCHES}
    readings = []
    for _ in range(4):
        runner(x, wgt) if exit_ == "k3" else runner(x, wgt, STARTS, acc)
        readings.append(_counters())
    # eager: nothing counted on the CPU; the capture counts what the host
    # issued into the graph; a replay issues nothing from the host
    assert readings == [zero] + [CAPTURED_LAUNCHES] * 3
    assert runner.captures == 1 and runner.replays == 3


def test_a_shape_the_chain_does_not_serve_is_never_captured(counters):
    # C_in == feature_size: encoder1 has no conv3, the chain is not correct
    model = tunetr.init_weights(
        tunetr.UNETR(in_channels=8, out_channels=3, img_size=(ROI,) * 3, feature_size=8,
                     hidden_size=24, mlp_dim=48, num_heads=4, num_layers=2),
        torch.Generator().manual_seed(3)).eval()
    weights = tuo.fused_weights(model)
    runner = tuo.GraphedForward(model, weights, graphs=StandInGraphs())
    x = torch.randn((1, 8, ROI, ROI, ROI), generator=torch.Generator().manual_seed(2))
    wgt = torch.ones((1, 1, ROI, ROI, ROI))
    for _ in range(3):
        _same(runner(x, wgt), tuo.fast_apply_v3(model, x, weights, out_scale=wgt))
    assert runner.captures == runner.replays == 0


# ---------------------------------------------------------------------------
# on the card: the graphed walks against the eager ones, full size
# ---------------------------------------------------------------------------

CARD = {  # walk, volume, model (C_in, classes, roi), spec, K1 launches a volume
    "ct-zrow": ((512, 512, 160, 1), (1, 14, 96), dict(roi=(96,) * 3, overlap=0.5, sw_batch=4,
                                                       mode="gaussian"), "bf16", 200),
    "brats-flat": ((240, 240, 155, 4), (4, 4, 128), dict(roi=(128,) * 3, overlap=0.5,
                                                          sw_batch=4, mode="gaussian"),
                   "bf16", 20),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs of the CUDA kernels")
    return torch.device("cuda", 0)


def _launches() -> dict:
    return {(fn.__name__, name): getattr(fn, name) for fn in conv_of.KERNELS
            for name in ("launches", "tc_launches", "narrow_launches") if hasattr(fn, name)}


def _device_kernels(run) -> Counter:
    """The device kernels of one ``run()`` by name, from a profiler trace."""
    return Counter(e["name"] for e in trace_kernels(run))


TRACE_PAIRS = 3  # the profiler now and then drops records from a trace of ~28,000 kernels


def _same_device_kernels(graphed_run, eager_run) -> None:
    """The device kernels of ``graphed_run()`` are those of ``eager_run()``
    by name and count, in one of ``TRACE_PAIRS`` pairs of traces (a pair
    whose trace lost records differs; a graph that ran other kernels
    differs in every pair)."""
    pairs = []
    for _ in range(TRACE_PAIRS):
        graphed, eager = _device_kernels(graphed_run), _device_kernels(eager_run)
        if graphed == eager:
            return
        pairs.append((sum(graphed.values()), sum(eager.values())))
    raise AssertionError(f"graphed and eager device kernels differ in every pair: {pairs}")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CARD))
def test_graphed_walk_gives_the_eager_walks_bits_on_the_card(device, cell):
    shape, (c_in, classes, roi), spec_kw, acc, k1 = CARD[cell]
    g = torch.Generator().manual_seed(0)
    model = tunetr.init_weights(tunetr.unetr_b16(c_in, classes, roi, dtype=torch.bfloat16),
                                g).to(device).eval()
    spec = SlidingWindowSpec(**spec_kw)
    rng = np.random.default_rng(7)
    volumes = [0.5 * rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]
    validator = Validator(model, classes, "ct" if c_in == 1 else "mri", spec, acc_dtype=acc,
                          device=device)
    weights = tuo.fused_weights(model)
    eager_fn = lambda w, wgt: tuo.fast_apply_v3(model, w, weights, out_scale=wgt)  # noqa: E731

    def eager_acc(w, wgt, starts, a):
        tuo.fast_apply_v3(model, w, weights, out_scale=wgt, starts=starts, acc=a)

    @torch.no_grad()
    def eager_walk(volume):
        if cell == "ct-zrow":
            return sliding_window_inference_zrow(volume, eager_acc, classes, spec, device=device,
                                                 acc_dtype=acc)
        return sliding_window_inference(volume, eager_fn, classes, spec, device=device,
                                        apply_takes_weight=True, acc_dtype=acc)

    # the out head the host still launches at every batch: K4 on the z-row walk
    eager_head = "outhead_row_of" if cell == "ct-zrow" else None
    for i, volume in enumerate(volumes):
        conv_of.reset_launches()
        want = eager_walk(volume)
        torch.cuda.synchronize()
        eager = _launches()
        conv_of.reset_launches()
        got = validator.infer_volume(volume)
        torch.cuda.synchronize()
        host = _launches()
        assert eager[("conv3x3x3_of", "launches")] == k1
        _same(got, want)
        assert validator.graphed.captures == 1  # one shape, captured in the first volume
        if i:  # every batch replayed: the host issued the eager out head alone
            assert {k: n for k, n in host.items() if n} == {
                k: n for k, n in eager.items() if n and k[0] == eager_head}
        _same_device_kernels(lambda: validator.infer_volume(volume), lambda: eager_walk(volume))
    assert validator.graphed.replays > 0 and len(validator.graphed._captured) == 1
    conv_of.reset_launches()
