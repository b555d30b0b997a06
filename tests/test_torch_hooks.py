"""The port's profiling and debug hooks (vqcpcb_tpu_torch/training/
profiling.py, the counterparts of vqcpcb_tpu/training/profiling.py) on the
CPU: with VQCPCB_PROFILE_DIR set, a train epoch of the decoder CLI writes a
Chrome trace there that holds the epoch's span; unset, nothing is written;
with VQCPCB_DEBUG_NANS=1, enable_debug_checks turns on autograd's anomaly
mode and a train step whose loss is NaN raises, where without it the step
returns the NaN."""
import glob
import json
import os
import shutil

import pytest
import torch

from vqcpcb_tpu_torch import main_decoder
from vqcpcb_tpu_torch.data import dataset as port_dataset
from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.training import profiling
from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    for name in ("encoder_smoke.py", "decoder_smoke.py"):
        shutil.copy(os.path.join(REPO, "tests", "configs", name), cfg_dir / name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    return tmp_path


@pytest.fixture
def checks_off(monkeypatch):
    """Leaves the debug checks off after the test, whatever it set."""
    yield
    monkeypatch.delenv("VQCPCB_DEBUG_NANS", raising=False)
    profiling.enable_debug_checks()
    assert not torch.is_anomaly_enabled()


def test_profile_dir_gets_a_trace_of_the_train_epoch(workdir, monkeypatch):
    trace_dir = workdir / "traces"
    monkeypatch.setenv("VQCPCB_PROFILE_DIR", str(trace_dir))
    assert main_decoder.main(["-t", "-c", "configs/decoder_smoke.py",
                              "--device", "cpu"]) == 0
    (path,) = glob.glob(str(trace_dir / "epoch_0_train.*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "epoch_0_train" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_no_profile_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("VQCPCB_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_profile("epoch_0_train"):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())


def _nan_prior_trainer():
    """A tiny prior whose logits hold a NaN, over a tiny encoder."""
    torch.manual_seed(0)
    encoder = Encoder(BachCPCDataProcessor(8, 16, [5, 5, 5, 5], 16),
                      GruDownscaler(8, 3, [16], 8, 1, 0.0, True),
                      ProductVectorQuantizer(4, 3, 0.25, 1))
    prior = PriorRelative(4, 16, 1, 2, 24, 8, 1, 4, 0.0)
    with torch.no_grad():
        prior.pre_softmax.bias[0] = float("nan")
    return PriorTrainer(encoder, prior, 4, device="cpu").init_state(1e-3)


@pytest.mark.parametrize("flag", ["1", None])
def test_debug_nans_raises_on_a_nan_loss(monkeypatch, checks_off, flag):
    if flag is None:
        monkeypatch.delenv("VQCPCB_DEBUG_NANS", raising=False)
    else:
        monkeypatch.setenv("VQCPCB_DEBUG_NANS", flag)
    assert profiling.enable_debug_checks() is (flag == "1")
    assert torch.is_anomaly_enabled() is (flag == "1")
    trainer = _nan_prior_trainer()
    x = torch.randint(0, 5, (2, 16, 4))
    if flag == "1":
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            trainer.train_step(x)
    else:
        assert torch.isnan(trainer.train_step(x)["loss"])
