"""The plain reference against medseg_torch's modules on the CPU at a tiny
size, from the same weights: the forward, the blended volume and the
training step, all in float32, for every configuration of
``BENCHMARK.json`` through its architecture's file."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from portbench import inputs, judge, manifest, params, program
from portbench.reference import swi
from portbench.reference.precision import round_operand
from portbench.tests.tiny import REPO
from portbench.tests.tiny import tiny_config as cut

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in BENCH["configs"]]


def config_file(name: str) -> dict:
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    return json.loads((REPO / entry["file"]).read_text())


def architecture(config: dict):
    return manifest.architecture(REPO / "portbench", config["model"]["architecture"])


def tiny_config(name: str) -> dict:
    config = cut(config_file(name))
    config["precision"]["compute"] = "float32"
    return config


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_table_is_the_programs_state_dict(name):
    config = config_file(name)
    arch = architecture(config)
    for model_cfg in (config["model"], tiny_config(name)["model"]):
        cfg = dict(config, model=model_cfg)
        table = arch.parameter_table(model_cfg)
        with torch.device("meta"):
            weights = {n: torch.empty(s) for n, s, _, _ in table}
            model = program.build_model(arch, cfg, weights, "meta", remat=False)
        got = {n: tuple(p.shape) for n, p in model.state_dict().items()}
        assert got == {n: tuple(s) for n, s, _, _ in table}


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_module(name):
    torch.manual_seed(0)
    config = tiny_config(name)
    arch = architecture(config)
    m = config["model"]
    weights = params.make_weights(arch, m, 5, "cpu")
    model = program.build_model(arch, config, weights, "cpu", remat=False).eval()
    x = torch.randn(2, m["in_channels"], *(config["train"]["crop"],) * 3)
    with torch.no_grad():  # as the Validator and the train step call the program's model
        want = model(x, return_encoder_features=False)
        got = arch.forward(weights, m, x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_blended_volume_matches_the_module_walk(name):
    config = tiny_config(name)
    arch = architecture(config)
    m = config["model"]
    weights = params.make_weights(arch, m, 6, "cpu")
    model = program.build_model(arch, config, weights, "cpu", remat=False)
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    s = config["serve"]
    spec = SlidingWindowSpec(roi=(s["roi"],) * 3, overlap=s["overlap"], sw_batch=s["sw_batch"],
                             mode=s["mode"], sigma_scale=s["sigma_scale"],
                             bucket_multiple=s["bucket_multiple"])
    validator = Validator(model, m["out_channels"], config["task"], spec, use_fast_path=False,
                          device="cpu")
    volume = inputs.serve_pool(config, {"pool": 1}, 6, "cpu")[0]
    want = validator.infer_volume(volume)
    got = judge.reference_logits(arch, weights, config, volume, "cpu")
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_training_steps_match_the_programs_step(name):
    """Three fp32 steps of ``make_train_step`` on the benchmark's batches
    against the reference's: losses, first gradients and changes."""
    config = tiny_config(name)
    arch = architecture(config)
    m = config["model"]
    weights = params.make_weights(arch, m, 7, "cpu")
    model = program.build_model(arch, config, weights, "cpu", remat=True).train()
    state = program.train_state(config, model, 1)
    step = program.train_step(config, model)
    traffic = {"crops_per_step": 2, "pool": 3}
    batches = inputs.train_pool(config, traffic, 7, "cpu")
    from portbench.train import program_readings

    got = program_readings(state, copy.deepcopy(weights), step, batches)
    ref = judge.reference_steps(arch, weights, config, batches, "cpu")
    numbers = judge.train_numbers(got, ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3
    # Adam's first steps are near sign(g) * lr: elements whose fp32 gradients
    # are near zero may take another sign under a different summation order
    assert numbers["change_gap"] < 2e-2


def test_window_starts_and_importance_by_hand():
    assert swi.starts_1d(512, 96, 0.5) == [0, 48, 96, 144, 192, 240, 288, 336, 384, 416]
    assert swi.starts_1d(160, 96, 0.5) == [0, 48, 64]
    assert swi.starts_1d(155, 128, 0.5) == [0, 27]
    assert swi.starts_1d(240, 128, 0.5) == [0, 64, 112]
    imp = swi.importance(96, "gaussian", 0.125, "cpu")
    assert imp.max() == 1.0 and imp[47, 47, 47] == imp[48, 48, 48]  # centred at 47.5
    from portbench.serve import windows_per_volume

    for name, want in (("unetr_b16_btcv", 300), ("unetr_b16_brats", 18)):
        assert windows_per_volume(config_file(name)) == want


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, -300.0, 448.0])
    y = round_operand(x, "fp8")
    assert y[0] == 1.0 and y[1] in (1.0, 1.125) and y[4] == 448.0
    assert round_operand(x, "fp32") is x
