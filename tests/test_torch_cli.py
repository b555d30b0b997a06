"""The port's CLIs end to end on the CPU (`--device cpu`), on copies of the
smoke configs in an isolated working directory (the pattern of
tests/test_cli.py): encoder -t, -l, -t -l; the student encoder -t, -l and
-t -l resuming a mid-epoch step checkpoint exactly; decoder -t over the
trained encoder, -l -r, -l --num_examples 1; the prior -t and -l -g through
a trained decoder; and the device rule: without CUDA, no --device means an
error. (The score-writing re-harmonisation is held
against the JAX trainer's in tests/test_torch_generation.py, beside the JAX
trainer whose sampler is compiled there.)"""
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from vqcpcb_tpu_torch import main_decoder, main_encoder, main_prior
from vqcpcb_tpu_torch.data import dataset as port_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_torch_checkpoints  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores (many-fold slower for ops this
    size)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    for name in ("encoder_smoke.py", "decoder_smoke.py",
                 "encoder_student_smoke.py", "prior_smoke.py"):
        shutil.copy(os.path.join(REPO, "tests", "configs", name), cfg_dir / name)
    monkeypatch.chdir(tmp_path)
    # the corpus windows are cached here, not in the checkout's data/
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    return tmp_path


def _model_dir(workdir, savename):
    (path,) = glob.glob(str(workdir / "models" / f"{savename}_*"))
    return path


def _epochs(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        assert np.isfinite(row["loss/train"]) and np.isfinite(row["loss/val"])
    return [row["epoch"] for row in rows]


def _train_encoder(workdir):
    assert main_encoder.main(["-t", "-c", "configs/encoder_smoke.py",
                              "--device", "cpu"]) == 0
    return _model_dir(workdir, "encoder_smoke")


def test_encoder_cli_train_load_and_continue(workdir, capsys):
    model_dir = _train_encoder(workdir)
    for name in ("config.py", "overfitted", "early_stopped", "clusters_train",
                 "clusters_val"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    assert glob.glob(os.path.join(model_dir, "clusters_train", "*.mid"))
    assert glob.glob(os.path.join(model_dir, "events.out.tfevents.*"))
    assert _epochs(model_dir) == [0]
    config = os.path.join(model_dir, "config.py")
    capsys.readouterr()
    assert main_encoder.main(["-l", "-c", config, "--device", "cpu"]) == 0
    assert "Nearest neighbours list:" in capsys.readouterr().out
    assert _epochs(model_dir) == [0]
    assert main_encoder.main(["-t", "-l", "-c", config, "--device", "cpu"]) == 0
    assert _epochs(model_dir) == [0, 1]


def test_decoder_cli_train_reharmonise_and_generate(workdir):
    encoder_dir = _train_encoder(workdir)
    cfg = workdir / "configs" / "decoder_smoke.py"
    cfg.write_text(cfg.read_text().replace(
        "os.path.join(os.path.dirname(__file__), 'encoder_smoke.py')",
        repr(os.path.join(encoder_dir, "config.py"))))
    assert main_decoder.main(["-t", "-c", "configs/decoder_smoke.py",
                              "--device", "cpu"]) == 0
    model_dir = _model_dir(workdir, "decoder_smoke")
    for name in ("config.py", "overfitted", "early_stopped"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    assert _epochs(model_dir) == [0]
    config = os.path.join(model_dir, "config.py")
    assert main_decoder.main(["-l", "-r", "-c", config, "--device", "cpu"]) == 0
    scores = sorted(glob.glob(os.path.join(model_dir, "reharmonisations", "*.mid")))
    assert [os.path.basename(p) for p in scores] == [
        f"score0_{k}.mid" for k in range(3)]
    with open(scores[0].replace(".mid", ".json")) as f:
        voices = json.load(f)
    assert len(voices) == 4 and all(voices)
    assert main_decoder.main(["-l", "--num_examples", "1", "-c", config,
                              "--device", "cpu"]) == 0
    # the template, tiled to the batch of 3, and its 3 generations
    assert len(glob.glob(os.path.join(model_dir, "generations", "*.mid"))) == 6


def test_clis_need_the_card_unless_told_cpu(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_encoder.main(["-t", "-c", "configs/encoder_smoke.py"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_decoder.main(["-t", "-c", "configs/decoder_smoke.py"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_prior.main(["-t", "-c", "configs/prior_smoke.py"])
    assert not os.path.exists(workdir / "models")


def test_prior_cli_train_load_and_generate(workdir):
    """decoder -t on decoder_smoke.py, then the prior CLI on prior_smoke.py
    with config_decoder set to that decoder (both over encoder_smoke.py's
    fresh encoder): -t writes the model directory, both slots and one
    metrics row; -l -g reloads the prior, samples 6 codes and decodes them
    with the decoder's 4-code window, writing one score under
    generations/."""
    assert main_decoder.main(["-t", "-c", "configs/decoder_smoke.py",
                              "--device", "cpu"]) == 0
    decoder_config = os.path.join(_model_dir(workdir, "decoder_smoke"), "config.py")
    cfg = workdir / "configs" / "prior_smoke.py"
    encoder_config = str(workdir / "configs" / "encoder_smoke.py")
    cfg.write_text(cfg.read_text().replace(
        "'config_decoder': None", f"'config_decoder': {decoder_config!r}").replace(
        "os.path.join(os.path.dirname(__file__), 'encoder_smoke.py')",
        repr(encoder_config)))
    assert main_prior.main(["-t", "-c", "configs/prior_smoke.py",
                            "--device", "cpu"]) == 0
    model_dir = _model_dir(workdir, "prior_smoke")
    for name in ("config.py", "overfitted", "early_stopped"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    assert _epochs(model_dir) == [0]
    assert main_prior.main(["-l", "-g", "-c", os.path.join(model_dir, "config.py"),
                            "--device", "cpu"]) == 0
    (score,) = glob.glob(os.path.join(model_dir, "generations", "*.mid"))
    with open(score.replace(".mid", ".json")) as f:
        voices = json.load(f)
    assert len(voices) == 4 and all(voices)
    assert _epochs(model_dir) == [0]


def _student_rows(model_dir):
    """metrics.jsonl's rows, each with the student's four losses finite."""
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        for name in ("loss_teacher", "loss_quantization", "loss_reconstruction",
                     "loss_encdec"):
            assert np.isfinite(row[f"{name}/train"]) and np.isfinite(row[f"{name}/val"])
    return rows


def test_student_encoder_cli_train_load_and_resume(workdir, monkeypatch, capsys):
    """-t on encoder_student_smoke.py (step checkpoints every batch): the
    model directory, one metrics row with the student's losses, the cluster
    dumps; -l reloads it, and the decoder CLI's load_encoder_stack reads its
    encoder. A second run under another savename crashes in
    its second train step, leaving a step checkpoint; -t -l on its model
    directory resumes there and ends in the state of the first run's
    overfitted slot, both optimizers and every generator included, bit for
    bit."""
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.training.student_trainer import StudentEncoderTrainer
    monkeypatch.setenv("VQCPCB_CKPT_EVERY_STEPS", "1")
    cfg = workdir / "configs" / "encoder_student_smoke.py"
    shutil.copy(cfg, workdir / "configs" / "encoder_student_smoke_crash.py")
    assert main_encoder.main(["-t", "-c", "configs/encoder_student_smoke.py",
                              "--device", "cpu"]) == 0
    model_dir = _model_dir(workdir, "encoder_student_smoke")
    for name in ("config.py", "overfitted", "early_stopped", "clusters_train"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    (row,) = _student_rows(model_dir)
    assert row["epoch"] == 0
    capsys.readouterr()
    assert main_encoder.main(["-l", "-c", os.path.join(model_dir, "config.py"),
                              "--device", "cpu"]) == 0
    assert "Nearest neighbours list:" in capsys.readouterr().out
    # the decoder CLI's frozen encoder: the student's encoder entries
    encoder, _ = main_decoder.load_encoder_stack(
        {"config_encoder": os.path.join(model_dir, "config.py")})
    saved = checkpoints.load_state(model_dir, early_stopped=False)["model"]
    for name, value in encoder.state_dict().items():
        assert torch.equal(value, saved[f"encoder.{name}"]), name

    step = StudentEncoderTrainer.train_step
    calls = []

    def crashing(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return step(self, *args, **kwargs)

    monkeypatch.setattr(StudentEncoderTrainer, "train_step", crashing)
    with pytest.raises(RuntimeError, match="simulated crash"):
        main_encoder.main(["-t", "-c", "configs/encoder_student_smoke_crash.py",
                           "--device", "cpu"])
    monkeypatch.setattr(StudentEncoderTrainer, "train_step", step)
    crashed = _model_dir(workdir, "encoder_student_smoke_crash")
    assert checkpoints.read_step_sidecar(crashed)["batches_done"] == 1
    assert main_encoder.main(["-t", "-l", "-c", os.path.join(crashed, "config.py"),
                              "--device", "cpu"]) == 0
    assert [r["epoch"] for r in _student_rows(crashed)] == [0]
    want, got = (checkpoints.load_state(d, early_stopped=False)
                 for d in (model_dir, crashed))
    assert set(got) == {"model", "optimizer_teacher", "optimizer_encdec", "step",
                        "generators"}
    assert got["step"] == want["step"] == 2
    test_torch_checkpoints.assert_states_equal(got, want)
