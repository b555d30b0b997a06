"""`correct` at CPU test size: the reference agrees with the port's CPU
route (f32, plain attention) on both configurations; with the timed path
broken underneath (a step that leaves the state unchanged, half of the
batch left out, a token altered where it is produced, a sampler that
ignores top-p) a whole run reports
`correct` false; and so does each cell's control, the reference at the
next precision down put in the program's place (TF32 only on a card)."""
import json

import pytest
import torch

from portbench import calibrate, run
from portbench.harness import compare, registry
from portbench.tests import tiny


def run_cell(name, capsys, seed=2 ** 31 + 5, trace=0):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.3",
                   "--trace", str(trace)], device="cpu", cell=tiny.cell(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["flagship-train", "encoder-train", "flagship-gen"])
def test_reference_agrees_with_the_cpu_route(name, capsys):
    result = run_cell(name, capsys)
    assert result["correct"] is True
    assert all(c["value"] < 1e-4 for c in result["checks"].values()), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ["flagship-train", "encoder-train"])
def test_a_run_reports_its_cells_metrics(name, capsys):
    """--trace 0 prints the cell's end-to-end metrics and no other; --trace 1
    the per-layer metrics listed for the cell whose readers find something
    (on the CPU, those read from the window: the device ones find no
    device operation). The step's p95 is end to end in encoder-train and
    per layer in flagship-train."""
    cell = registry.cell(name)
    plain = run_cell(name, capsys)["metrics"]
    assert set(plain) == {m["name"] for m in cell["end_to_end"]}
    assert ("train_step_p95_ms" in plain) == (name == "encoder-train")
    traced = run_cell(name, capsys, trace=1)["metrics"]
    assert set(traced) <= {m["name"] for m in cell["per_layer"]}
    assert "mfu.train" in traced
    assert ("step_p95_ms.train" in traced) == (name == "flagship-train")
    assert all(v["value"] > 0 for v in traced.values())


def _unchanged_state(monkeypatch):
    from vqcpcb_tpu_torch.training import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self: torch.zeros(()))


def _half_batch(monkeypatch):
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    dec, enc = DecoderTrainer.train_step, VQCPCEncoderTrainer.train_step
    monkeypatch.setattr(DecoderTrainer, "train_step",
                        lambda self, x: dec(self, x[: x.shape[0] // 2]))
    monkeypatch.setattr(VQCPCEncoderTrainer, "train_step",
                        lambda self, b, *a: enc(self, {k: v[: v.shape[0] // 2]
                                                       for k, v in b.items()}, *a))


def _altered_token(monkeypatch):
    from vqcpcb_tpu_torch.models import decoder
    draw = decoder.sample_categorical

    def altered(generator, logits, *args, **kwargs):
        return (draw(generator, logits, *args, **kwargs) + 1) % 28
    monkeypatch.setattr(decoder, "sample_categorical", altered)


def _top_p_ignored(monkeypatch):
    from vqcpcb_tpu_torch.models import decoder
    draw = decoder.sample_categorical

    def whole(generator, logits, temperature, top_k, top_p, *args):
        return draw(generator, logits, temperature, top_k, 0.0, *args)
    monkeypatch.setattr(decoder, "sample_categorical", whole)


@pytest.mark.parametrize("name,fault", [
    ("flagship-train", _unchanged_state), ("flagship-train", _half_batch),
    ("encoder-train", _unchanged_state), ("encoder-train", _half_batch),
    ("flagship-gen", _altered_token), ("flagship-gen", _top_p_ignored)])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, capsys):
    fault(monkeypatch)
    assert run_cell(name, capsys)["correct"] is False


@pytest.mark.parametrize("name", ["flagship-train", "flagship-gen"])
def test_the_control_is_not_correct(name):
    cell = tiny.cell(name)
    system = registry.module("systems", cell["entry"]["config"])
    one = calibrate.train_seed if name.endswith("train") else calibrate.generate_seed
    for seed in (3, 4, 5):
        out = one(cell, system, seed, torch.device("cpu"), True)
        assert compare.verdict(out["program"], cell["workload"]["limits"])
        assert not compare.verdict(out["control"], cell["workload"]["limits"]), out


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_a_card(card):
    cell = tiny.cell("encoder-train")
    system = registry.module("systems", cell["entry"]["config"])
    for seed in (3, 4, 5):
        out = calibrate.train_seed(cell, system, seed, card, True)
        assert not compare.verdict(out["control"], cell["workload"]["limits"]), out
