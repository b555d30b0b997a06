"""The port's CLIs end to end on the CPU (`--device cpu`), on copies of the
smoke configs in an isolated working directory (the pattern of
tests/test_cli.py): encoder -t, -l, -t -l; decoder -t over the trained
encoder, -l -r, -l --num_examples 1; and the device rule: without CUDA, no
--device means an error. (The score-writing re-harmonisation is held
against the JAX trainer's in tests/test_torch_generation.py, beside the JAX
trainer whose sampler is compiled there.)"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from vqcpcb_tpu_torch import main_decoder, main_encoder
from vqcpcb_tpu_torch.data import dataset as port_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
                 "encoder_student_smoke.py"):
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
    assert not os.path.exists(workdir / "models")


def test_student_encoder_waits_for_its_slice(workdir):
    with pytest.raises(NotImplementedError, match=r"M6 \(c\)"):
        main_encoder.main(["-t", "-c", "configs/encoder_student_smoke.py",
                           "--device", "cpu"])
