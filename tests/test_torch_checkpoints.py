"""The port's checkpoints, epoch loop and metrics on the CPU, at the smoke
configs' sizes: a save / load round trip of the whole trainer state, exact
mid-epoch resume from a step checkpoint (encoder trainer, and decoder
trainer with dropout on), the stale-sidecar rule, and the JAX package's
readers on the port's metrics.jsonl, TensorBoard events and MIDI bytes."""
import glob
import json
import os

import pytest
import torch

from vqcpcb_tpu_torch import getters
from vqcpcb_tpu_torch.training import checkpoints
from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
from vqcpcb_tpu_torch.training.metrics import MetricsWriter
from vqcpcb_tpu_torch.utils import load_config_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_CONFIG = os.path.join(REPO, "tests", "configs", "encoder_smoke.py")
DECODER_CONFIG = os.path.join(REPO, "tests", "configs", "decoder_smoke.py")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores (many-fold slower for ops this
    size)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def encoder_config(quantizer="commitment"):
    """encoder_smoke.py with every random draw of encoder training switched
    on: dropout in the 2-layer context GRU and the upscaler; `quantizer`
    'commitment' (with BatchNorm and label corruption) or 'ema' (which takes
    no label corruption)."""
    config = load_config_module(ENCODER_CONFIG)
    config["upscaler_kwargs"]["dropout"] = 0.1
    config["auxiliary_networks_kwargs"]["c_net_kwargs"].update(num_layers=2,
                                                               dropout=0.1)
    config["quantizer_regularization"]["corrupt_labels"] = quantizer == "commitment"
    config["quantizer_type"] = quantizer
    config["quantizer_kwargs"]["use_batch_norm"] = quantizer == "commitment"
    return config


def decoder_config(dropout=0.1):
    config = load_config_module(DECODER_CONFIG)
    config["decoder_kwargs"]["dropout"] = dropout
    return config


class CrashingGenerator:
    """Delegates to a data loader generator; the first dataloaders() call's
    train stream raises at batch `crash_after` (a kill inside epoch 0)."""

    def __init__(self, inner, crash_after: int):
        self._inner = inner
        self._crash_after = crash_after
        self._armed = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def reseed(self, epoch_id):
        self._inner.reseed(epoch_id)

    def dataloaders(self, **kwargs):
        train, val, test = self._inner.dataloaders(**kwargs)
        if self._armed:
            self._armed = False
            train = self._crashing(train)
        return train, val, test

    def _crashing(self, it):
        for i, batch in enumerate(it):
            if i == self._crash_after:
                raise RuntimeError("simulated mid-epoch crash")
            yield batch


def build_encoder_trainer(tmp_path, name, config, crash_after=None,
                          init_seed=0, seed=0, device="cpu"):
    gen = getters.get_dataloader_generator(
        config["dataset"], "vqcpc", config["dataloader_generator_kwargs"],
        config, cache_root=str(tmp_path / "data"))
    if crash_after is not None:
        gen = CrashingGenerator(gen, crash_after)
    torch.manual_seed(init_seed)
    return VQCPCEncoderTrainer(getters.get_vqcpc_model(gen, config),
                               device=device, seed=seed,
                               model_dir=str(tmp_path / name),
                               dataloader_generator=gen)


def build_decoder_trainer(tmp_path, name, config, crash_after=None,
                          init_seed=0, seed=0, device="cpu"):
    """A decoder trainer over the fresh (seeded) encoder of
    encoder_smoke.py."""
    gen = getters.get_dataloader_generator(
        config["dataset"], "decoder", config["dataloader_generator_kwargs"],
        config, cache_root=str(tmp_path / "data"))
    enc_config = load_config_module(ENCODER_CONFIG)
    enc_gen = getters.get_dataloader_generator(
        enc_config["dataset"], "vqcpc", enc_config["dataloader_generator_kwargs"],
        enc_config, cache_root=str(tmp_path / "data"))
    torch.manual_seed(0)
    encoder = getters.get_encoder(enc_gen, enc_config)
    torch.manual_seed(init_seed)
    decoder = getters.get_decoder(
        gen, getters.get_data_processor(gen, "bach", config["data_processor_kwargs"]),
        encoder, enc_config, config["decoder_type"], config["decoder_kwargs"])
    if crash_after is not None:
        gen = CrashingGenerator(gen, crash_after)
    return DecoderTrainer(encoder, decoder,
                          enc_config["quantizer_kwargs"]["codebook_size"],
                          device=device, seed=seed, model_dir=str(tmp_path / name),
                          dataloader_generator=gen)


def assert_states_equal(a, b, path="state"):
    """Nested dicts / lists of tensors and numbers equal, bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.cpu(), b.cpu()), path
    else:
        assert a == b, path


def metric_rows(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---- save / load round trip -------------------------------------------------

def _train_batches(trainer, n):
    train = trainer.dataloader_generator.dataloaders(batch_size=16)[0]
    return [next(train) for _ in range(n)]


@pytest.mark.parametrize("quantizer", ["commitment", "ema"])
def test_encoder_trainer_round_trip_restores_the_whole_state(tmp_path, quantizer):
    """Parameters, BatchNorm statistics or EMA buffers, Adam's moments, step
    and schedule position, and the generator: equal after load, and the
    next step is the same step bit for bit."""
    config = encoder_config(quantizer)
    a = build_encoder_trainer(tmp_path, "a", config)
    batches = _train_batches(a, 4)
    a.init_state(batches[0], lr=1e-3, schedule_lr=True, warmup_steps=4)
    corrupt = config["quantizer_regularization"]["corrupt_labels"]
    for b in batches[:3]:
        a.train_step(b, corrupt_labels=corrupt)
    a.save(early_stopped=False)
    assert checkpoints.latest_slot(a.model_dir) == "overfitted"

    b = build_encoder_trainer(tmp_path, "a", config, init_seed=1, seed=5)
    b.init_state(batches[0], lr=1e-3, schedule_lr=True, warmup_steps=4,
                 initialize=False)
    assert not torch.equal(b.model.encoder.quantizer.codebooks,
                           a.model.encoder.quantizer.codebooks)
    b.load(early_stopped=False)
    assert_states_equal(b.state_dict(), a.state_dict())
    assert b.step == 3 and b.optimizer.count == 3
    a.train_step(batches[3], corrupt_labels=corrupt)
    b.train_step(batches[3], corrupt_labels=corrupt)
    assert_states_equal(b.state_dict(), a.state_dict())


def test_decoder_trainer_round_trip_restores_the_whole_state(tmp_path):
    config = decoder_config(dropout=0.1)
    a = build_decoder_trainer(tmp_path, "d", config)
    train = a.dataloader_generator.dataloaders(batch_size=8)[0]
    batches = [next(train)["x"] for _ in range(3)]
    a.init_state(lr=1e-3, schedule_lr=True, warmup_steps=4)
    for x in batches[:2]:
        a.train_step(x)
    a.save(early_stopped=True)
    assert checkpoints.latest_slot(a.model_dir) == "early_stopped"

    b = build_decoder_trainer(tmp_path, "d", config, init_seed=1, seed=5)
    b.init_state(lr=1e-3, schedule_lr=True, warmup_steps=4)
    b.load(early_stopped=True)
    assert_states_equal(b.state_dict(), a.state_dict())
    a.train_step(batches[2])
    b.train_step(batches[2])
    assert_states_equal(b.state_dict(), a.state_dict())


def test_load_needs_init_state_first(tmp_path):
    trainer = build_decoder_trainer(tmp_path, "d", decoder_config())
    with pytest.raises(RuntimeError, match="init_state"):
        trainer.load(early_stopped=False)


def test_checkpoint_files_load_weights_only(tmp_path):
    """The slot holds state_dicts, tensors and numbers only: torch.load
    with weights_only=True reads it."""
    trainer = build_decoder_trainer(tmp_path, "d", decoder_config())
    trainer.init_state(lr=1e-3)
    trainer.save(early_stopped=False)
    path = os.path.join(checkpoints.slot_dir(trainer.model_dir, False),
                        checkpoints.STATE_FILE)
    state = torch.load(path, weights_only=True)
    assert set(state) == {"model", "optimizer", "step", "generators"}
    assert not glob.glob(os.path.join(trainer.model_dir, "**", "*.tmp"),
                         recursive=True)


# ---- mid-epoch resume ---------------------------------------------------------

def _resume_matches_uninterrupted(tmp_path, build, config, kwargs):
    a = build(tmp_path, "a", config)
    a.train_model(**kwargs)
    assert [r["epoch"] for r in metric_rows(a.model_dir)] == [0, 1]
    assert checkpoints.read_step_sidecar(a.model_dir) is None

    # killed at batch 3 of epoch 0: the last step checkpoint holds 2 batches
    b = build(tmp_path, "b", config, crash_after=3)
    with pytest.raises(RuntimeError, match="simulated mid-epoch crash"):
        b.train_model(**kwargs)
    sidecar = checkpoints.read_step_sidecar(b.model_dir)
    assert sidecar["epoch"] == 0 and sidecar["batches_done"] == 2
    assert sidecar["metric_count"] == 2 and sidecar["generators"]
    assert not os.path.exists(os.path.join(b.model_dir, "metrics.jsonl"))

    # a new process: a fresh trainer over the same model directory
    b2 = build(tmp_path, "b", config, init_seed=1)
    b2.train_model(**kwargs)
    assert checkpoints.read_step_sidecar(b2.model_dir) is None
    assert_states_equal(b2.state_dict(), a.state_dict())
    for ra, rb in zip(metric_rows(a.model_dir), metric_rows(b2.model_dir)):
        assert {k: v for k, v in ra.items() if "tokens" not in k and k != "time"} \
            == {k: v for k, v in rb.items() if "tokens" not in k and k != "time"}


def test_encoder_resume_from_step_checkpoint_is_exact(tmp_path):
    """Dropout, label corruption and BatchNorm on: the resumed run ends with
    the uninterrupted run's parameters, buffers, optimizer and generator,
    bit for bit, and the same metrics rows."""
    _resume_matches_uninterrupted(
        tmp_path, build_encoder_trainer, encoder_config("commitment"),
        dict(batch_size=16, num_batches=5, num_epochs=2, lr=1e-3,
             schedule_lr=True, corrupt_labels=True, checkpoint_every_steps=2))


def test_decoder_resume_from_step_checkpoint_is_exact(tmp_path):
    """Dropout 0.1 in every layer and in the attention weights."""
    _resume_matches_uninterrupted(
        tmp_path, build_decoder_trainer, decoder_config(dropout=0.1),
        dict(batch_size=8, num_batches=5, num_epochs=2, lr=1e-3,
             schedule_lr=True, checkpoint_every_steps=2))


def test_checkpoint_every_steps_reads_the_environment(tmp_path, monkeypatch):
    """VQCPCB_CKPT_EVERY_STEPS, as the JAX loop reads it: a step slot is
    written inside the epoch (seen by a crash at batch 3)."""
    monkeypatch.setenv("VQCPCB_CKPT_EVERY_STEPS", "2")
    t = build_decoder_trainer(tmp_path, "e", decoder_config(), crash_after=3)
    with pytest.raises(RuntimeError, match="simulated mid-epoch crash"):
        t.train_model(batch_size=8, num_batches=5, num_epochs=1, lr=1e-3)
    assert checkpoints.read_step_sidecar(t.model_dir)["batches_done"] == 2


def test_stale_sidecar_from_completed_epoch_is_cleared(tmp_path):
    """A sidecar whose epoch already has a metrics row is not resumed from:
    training continues at the next epoch and the slot is cleared."""
    config = decoder_config()
    kwargs = dict(batch_size=8, num_batches=3, num_epochs=1, lr=1e-3)
    t = build_decoder_trainer(tmp_path, "m", config)
    t.train_model(**kwargs)
    state = t.state_dict()
    generators = state.pop("generators")
    checkpoints.save_step_state(t.model_dir, state, {
        "epoch": 0, "batches_done": 1, "metric_sums": {}, "metric_count": 1,
        "generators": {k: {"device": g["device"], "state": g["state"].tolist()}
                       for k, g in generators.items()}})
    assert checkpoints.read_step_sidecar(t.model_dir) is not None
    t2 = build_decoder_trainer(tmp_path, "m", config)
    t2.init_state(lr=1e-3)
    t2.load(early_stopped=False)
    t2.train_model(**kwargs)
    assert [r["epoch"] for r in metric_rows(t2.model_dir)] == [0, 1]
    assert checkpoints.read_step_sidecar(t2.model_dir) is None
    assert not os.path.exists(os.path.join(t2.model_dir,
                                           checkpoints.STEP_SLOT))


# ---- the JAX package's readers on the port's files -------------------------

def test_jax_metrics_reader_and_tb_reader_read_the_port_files(tmp_path):
    from vqcpcb_tpu.training import tb_writer as jax_tb
    from vqcpcb_tpu.training.metrics import MetricsWriter as JaxMetricsWriter
    from vqcpcb_tpu_torch.training import tb_writer
    writer = MetricsWriter(str(tmp_path), plot=True)
    writer.write(0, {"loss": 2.5, "accuracy": [0.1, 0.3]}, {"loss": 2.0})
    writer.write(1, {"loss": 1.5, "accuracy": [0.2, 0.4]}, {"loss": 2.25})
    writer.write(2, {"loss": 1.25, "accuracy": [0.5, 0.6]}, None)
    jax_reader = JaxMetricsWriter(str(tmp_path))
    assert jax_reader.epochs_logged() == writer.epochs_logged() == 3
    assert jax_reader.best_val("loss") == writer.best_val("loss") == 2.0
    assert jax_reader.best_val("accuracy") == writer.best_val("accuracy") == 1e8
    row = metric_rows(str(tmp_path))[1]
    assert row["accuracy_1/train"] == 0.4 and row["loss/val"] == 2.25
    (events,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    got = jax_tb.read_scalars(events)
    assert got == tb_writer.read_scalars(events)
    assert (1, "accuracy_0/train", pytest.approx(0.2)) in got
    assert len(got) == 3 * 3 + 2


def test_midi_bytes_equal_the_jax_writer(tmp_path):
    """The same grid through each package's to_neutral and
    neutral_events_to_smf gives the same bytes; `write` gives the JAX
    package's .mid and .json (music21 is absent there too)."""
    from vqcpcb_tpu.data.dataloaders import \
        BachDataloaderGenerator as JaxBachDataloaderGenerator
    from vqcpcb_tpu.data.corpora import SyntheticChoraleCorpus as JaxCorpus
    from vqcpcb_tpu.data.midi import neutral_events_to_smf as jax_smf
    from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
    from vqcpcb_tpu_torch.data.dataloaders import BachDataloaderGenerator
    from vqcpcb_tpu_torch.data.midi import neutral_events_to_smf
    from vqcpcb_tpu_torch.data.vocab import START_SYMBOL
    kw = dict(num_chorales=6, min_beats=10, max_beats=14, seed=0)
    jax_gen = JaxBachDataloaderGenerator(4, corpus=JaxCorpus(**kw),
                                         cache_root=str(tmp_path / "jax"))
    gen = BachDataloaderGenerator(4, corpus=SyntheticChoraleCorpus(**kw),
                                  cache_root=str(tmp_path / "port"))
    grid = next(gen.dataloaders(batch_size=2)[0])["x"][0]
    vocab = gen.dataset.vocabulary
    grid = grid.copy()
    grid[3] = vocab.symbol_indices(START_SYMBOL)    # symbols render as silence
    events = gen.to_neutral(grid)
    assert events == jax_gen.to_neutral(grid)
    assert neutral_events_to_smf(events) == jax_smf(events)
    got = gen.write(grid, str(tmp_path / "port_score"))
    want = jax_gen.write(grid, str(tmp_path / "jax_score"))
    assert got.endswith(".mid") and want.endswith(".mid")
    for ext in (".mid", ".json"):
        with open(tmp_path / f"port_score{ext}", "rb") as f, \
                open(tmp_path / f"jax_score{ext}", "rb") as g:
            assert f.read() == g.read()
