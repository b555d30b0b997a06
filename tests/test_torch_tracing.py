"""The port's spans and counters (vqcpcb_tpu_torch/training/profiling.py).

CPU: with no profiler recording a span does nothing and the counters stay
empty; under a CPU torch.profiler a decoder and an encoder training step
and a KV-cached sampling call show their spans, nested and in order, and
count their steps and positions; the ops run inside a span nest in its
range (the gradient clip's inside vqcpcb.optimizer); the counters count
only while a profiler records; `maybe_profile`'s trace file holds the
spans. The host syncs inside the spans are read from the trace's runtime
calls (portbench/metrics/host_syncs_per_step.train.py, tested on the card
in portbench/tests/test_portbench_spans.py)."""
import glob
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.training import profiling
from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer

SIZES = [5, 5, 5, 5]
EVENTS, VOICES, BLOCK = 8, 4, 16


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def tiny_encoder(ticks=EVENTS):
    return Encoder(BachCPCDataProcessor(8, ticks, SIZES, num_tokens_per_block=BLOCK),
                   GruDownscaler(8, 3, [BLOCK], 16, num_layers=1, dropout=0.0,
                                 bidirectional=True),
                   ProductVectorQuantizer(4, 3, 0.25, 1),
                   MlpUpscaler(3, 8, 16, 0.0))


def tiny_decoder():
    return Decoder(BachDataProcessor(8, EVENTS, SIZES), "anticausal", d_model=16,
                   num_encoder_layers=1, num_decoder_layers=1, n_head=2,
                   dim_feedforward=24, positional_embedding_size=4,
                   num_channels_encoder=1,
                   num_events_encoder=EVENTS * VOICES // BLOCK,
                   num_channels_decoder=VOICES, num_events_decoder=EVENTS,
                   total_upscaling=BLOCK, source_vocab_size=4, dropout=0.0,
                   transformer_type="relative", cross_attention_type="diagonal")


def tokens(*shape, seed=0):
    return torch.randint(0, 5, shape, generator=torch.Generator().manual_seed(seed))


def decoder_trainer():
    torch.manual_seed(0)
    return DecoderTrainer(tiny_encoder(), tiny_decoder(), 4, device="cpu").init_state(lr=1e-3)


def encoder_trainer():
    torch.manual_seed(0)
    model = VQCPCModel(tiny_encoder(ticks=2 * 2 * BLOCK // VOICES),
                       CModule(8, 16, 8, 1, 0.0), FksModule(8, 8, 2),
                       quantization_weighting=0.5)
    batch = {"x_left": tokens(2, 8, VOICES), "x_right": tokens(2, 8, VOICES, seed=1),
             "negative_samples": tokens(2, 3, 2, BLOCK // VOICES, VOICES, seed=2)}
    trainer = VQCPCEncoderTrainer(model, device="cpu", seed=0)
    return trainer.init_state(batch, lr=1e-3, initialize=False), batch


def spans_of(prof):
    """The profiled vqcpcb.* host ranges, by start: (name, outermost-first
    names of the vqcpcb.* ranges around it)."""
    found = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("vqcpcb.") and e.device_type == torch.autograd.DeviceType.CPU:
            chain, parent = [], e.cpu_parent
            while parent is not None:
                if parent.name.startswith("vqcpcb."):
                    chain.insert(0, parent.name)
                parent = parent.cpu_parent
            found.append((e.name, tuple(chain)))
    return found


def test_span_without_a_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("vqcpcb.train_step") as s:
        profiling.count("steps")
    assert s is None
    assert profiling.span("vqcpcb.sample") is profiling._OFF
    assert profiling.counters() == {}


def test_decoder_train_step_spans_in_order():
    trainer = decoder_trainer()
    x = tokens(2, EVENTS, VOICES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            trainer.train_step(x)
    root = ("vqcpcb.train_step",)
    step = [("vqcpcb.train_step", ()), ("vqcpcb.encode", root), ("vqcpcb.forward", root),
            ("vqcpcb.backward", root), ("vqcpcb.optimizer", root)]
    assert spans_of(prof) == step * 2
    assert profiling.counters() == {"steps": 2}


def test_encoder_train_step_spans_in_order():
    trainer, batch = encoder_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch)
    root = ("vqcpcb.train_step",)
    assert spans_of(prof) == [("vqcpcb.train_step", ()), ("vqcpcb.forward", root),
                              ("vqcpcb.backward", root), ("vqcpcb.optimizer", root)]
    assert profiling.counters() == {"steps": 1}


@pytest.mark.parametrize("start,num_steps", [(0, 5), (3, 2)])
def test_sample_range_spans_a_position(start, num_steps):
    torch.manual_seed(0)
    decoder = tiny_decoder().eval()
    source = tokens(2, EVENTS * VOICES // BLOCK).clamp(max=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decoder.sample_range(source, tokens(2, EVENTS, VOICES), start, num_steps,
                             torch.Generator().manual_seed(0), top_p=0.8,
                             device="cpu")
    root = ("vqcpcb.sample_range",)
    want = ([("vqcpcb.sample_range", ()), ("vqcpcb.prefill", root)]
            + [("vqcpcb.decode_step", root), ("vqcpcb.sample", root)] * num_steps)
    assert spans_of(prof) == want
    assert profiling.counters() == {"positions": num_steps}


def test_maybe_profile_trace_holds_the_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("VQCPCB_PROFILE_DIR", str(tmp_path))
    trainer = decoder_trainer()
    with profiling.maybe_profile("epoch_0_train"):
        trainer.train_step(tokens(2, EVENTS, VOICES))
    (path,) = glob.glob(str(tmp_path / "epoch_0_train.*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vqcpcb.train_step", "vqcpcb.encode", "vqcpcb.forward",
            "vqcpcb.backward", "vqcpcb.optimizer"} <= names


def chain_of(e):
    names, parent = [], e.cpu_parent
    while parent is not None:
        names.append(parent.name)
        parent = parent.cpu_parent
    return names


def test_ops_run_inside_a_span_nest_in_its_range():
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("vqcpcb.sample"):
            x * 2
        x + 1
    (mul,) = [e for e in prof.events() if e.name == "aten::mul"]
    (add,) = [e for e in prof.events() if e.name == "aten::add"]
    assert chain_of(mul) == ["vqcpcb.sample"]
    assert chain_of(add) == []


def test_the_gradient_clip_runs_inside_the_optimizer_span():
    trainer = decoder_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(tokens(2, EVENTS, VOICES))
    norms = [e for e in prof.events() if e.name == "aten::linalg_vector_norm"]
    assert norms
    assert all(chain_of(e)[-2:] == ["vqcpcb.optimizer", "vqcpcb.train_step"]
               for e in norms)


def test_counters_count_only_while_a_profiler_records():
    profiling.count("positions", 3)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("positions", 3)
        profiling.count("positions")
        profiling.count("steps")
    copy = profiling.counters()
    copy["steps"] = 10
    assert profiling.counters() == {"positions": 4, "steps": 1}
    profiling.reset_counters()
    assert profiling.counters() == {}
