"""VQCPCB_REMAT=1 in the port (ops/transformer.py remat_layer): each layer of
a transformer stack in train mode is recomputed in the backward. At dropout
> 0 the losses and gradients equal those without it bit for bit on the CPU
-- the encoder stack, both decoder stacks, and two steps of each trainer
(VQ-CPC with the transformer downscaler, decoder, prior, student) -- the
explicit generators end where they end without it, and the dropout masks
still change from step to step. A recompute that drew fresh seeds or masks
would break the equality."""
import copy
import os
import sys

import pytest
import torch

from vqcpcb_tpu_torch import getters, main_decoder, main_encoder, make_midi_corpus
from vqcpcb_tpu_torch.data import dataset as port_dataset
from vqcpcb_tpu_torch.ops import transformer
from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
from vqcpcb_tpu_torch.utils import default_compute_dtype, load_config_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_corpora import _TINY, _TINY_DECODER, _tiny_copy  # noqa: E402

D, HEADS, FF, DROPOUT = 32, 2, 48, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def remat_calls(monkeypatch):
    """Counts the layers run through torch.utils.checkpoint."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", counting)
    return calls


def _stack(kind):
    """A two-layer stack in train mode at dropout DROPOUT, and a function of
    it giving its output on fixed inputs that require grad (the "bf16 scope"
    encoder's forward in the decoder trainer's default_compute_dtype scope;
    its backward, and so its recompute, runs outside it)."""
    torch.manual_seed(0)
    if kind == "encoder in a bf16 scope":
        stack, inputs, run = _stack("encoder")

        def scoped(m):
            with default_compute_dtype(torch.bfloat16):
                return run(m).float()
        return stack, inputs, scoped
    if kind == "encoder":
        stack = transformer.TransformerEncoder(
            2, D, HEADS, "relative_attention", 4, 4, FF, dropout=DROPOUT)
        x = torch.randn(3, 16, D, requires_grad=True)
        return stack, [x], lambda m: m(x, anticausal_mask(16))
    aligned = kind == "aligned decoder"
    kwargs = dict(d_model=D, n_head=HEADS, attention_bias_type_self="relative_attention",
                  num_channels_encoder=1, num_events_encoder=4,
                  num_channels_decoder=4, num_events_decoder=16,
                  dim_feedforward=FF, dropout=DROPOUT)
    if not aligned:
        kwargs["attention_bias_type_cross"] = "relative_attention_target_source"
    stack = transformer.TransformerDecoder(2, aligned=aligned, **kwargs)
    tgt = torch.randn(3, 64, D, requires_grad=True)
    memory = torch.randn(3, 4, D, requires_grad=True)
    mem_mask = None if aligned else anticausal_mask(4, sz_tgt=64)
    return stack, [tgt, memory], lambda m: m(tgt, memory, causal_mask(64), mem_mask)


def _two_steps(stack, inputs, run):
    """Two forward + backward passes of a copy of `stack` wired to fresh
    generators: the losses, every gradient and the generators' end states."""
    stack = copy.deepcopy(stack).train()
    gen, seed_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    transformer.wire_generators(stack, gen, seed_gen)
    weight = torch.linspace(-1.0, 1.0, D)
    out = []
    for _ in range(2):
        loss = (run(stack) * weight).sum()
        leaves = list(stack.parameters()) + inputs
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    return out, (gen.get_state(), seed_gen.get_state())


@pytest.mark.parametrize("kind", ["encoder", "encoder in a bf16 scope",
                                  "aligned decoder", "attention decoder"])
def test_stack_gradients_bit_equal_with_remat(kind, monkeypatch, remat_calls):
    stack, inputs, run = _stack(kind)
    monkeypatch.delenv("VQCPCB_REMAT", raising=False)
    plain, plain_gens = _two_steps(stack, inputs, run)
    assert not remat_calls
    monkeypatch.setenv("VQCPCB_REMAT", "1")
    remat, remat_gens = _two_steps(stack, inputs, run)
    assert len(remat_calls) == 4                    # 2 layers x 2 steps
    for (loss, grads), (rloss, rgrads) in zip(plain, remat):
        assert torch.equal(loss, rloss)
        assert all(torch.equal(g, r) for g, r in zip(grads, rgrads))
    assert all(torch.equal(a, b) for a, b in zip(plain_gens, remat_gens))
    assert not torch.equal(plain[0][0], plain[1][0])   # new masks each step
    with torch.no_grad():                          # no recompute without grads
        run(stack.train())
    assert len(remat_calls) == 4


# ---- one trainer step each ------------------------------------------------------

_TINY_PRIOR = (("d_model=512", "d_model=32"), ("num_layers=6", "num_layers=2"),
               ("n_head=8", "n_head=2"), ("dim_feedforward=1024", "dim_feedforward=48"),
               ("embedding_size=32", "embedding_size=8"),
               ("sequences_size=24", "sequences_size=4"))


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """Tiny copies of the scale-up MIDI configs over a written corpus, and
    the student smoke config with dropout DROPOUT."""
    tmp = tmp_path_factory.mktemp("remat")
    root = str(tmp / "midi_corpus")
    make_midi_corpus.write_corpus(root, num=6, min_beats=16, max_beats=24)
    encoder = _tiny_copy("encoder_scaleup_midi.py", _TINY, root, tmp / "encoder.py")
    decoder = _tiny_copy("decoder_scaleup_midi.py", _TINY_DECODER, root,
                         tmp / "decoder.py")
    prior = _tiny_copy("prior_scaleup_midi.py", _TINY_PRIOR, root, tmp / "prior.py")
    return dict(encoder=encoder, decoder=decoder, prior=prior, tmp=tmp)


def _vqcpc(configs):
    config = load_config_module(configs["encoder"])
    gen = getters.get_dataloader_generator(
        config["dataset"], "vqcpc", config["dataloader_generator_kwargs"], config)
    trainer = VQCPCEncoderTrainer(getters.get_vqcpc_model(gen, config), device="cpu")
    batch = next(gen.dataloaders(batch_size=4)[0])
    trainer.init_state(batch, lr=1e-3, schedule_lr=True, warmup_steps=2)
    return trainer, trainer.model, lambda: trainer.train_step(batch)


def _decoder(configs):
    config = load_config_module(configs["decoder"])
    encoder, encoder_config = main_decoder.load_encoder_stack(config)
    trainer = main_decoder.build_decoder_trainer(
        config, encoder, encoder_config, "cpu", str(configs["tmp"] / "decoder"))
    x = next(trainer.dataloader_generator.dataloaders(batch_size=2)[0])["x"]
    return trainer, trainer.decoder, lambda: trainer.train_step(x)


def _prior(configs):
    config = load_config_module(configs["prior"])
    gen = getters.get_dataloader_generator(
        config["dataset"], "prior", config["dataloader_generator_kwargs"], config)
    encoder, encoder_config = main_decoder.load_encoder_stack(config)
    prior = getters.get_prior(gen, encoder, encoder_config, "transformer_relative",
                              config["prior_kwargs"])
    trainer = PriorTrainer(encoder, prior, 16, device="cpu").init_state(lr=1e-3)
    x = next(gen.dataloaders(batch_size=2)[0])["x"]
    return trainer, trainer.prior, lambda: trainer.train_step(x)


def _student(configs):
    config = load_config_module(os.path.join(REPO, "tests", "configs",
                                             "encoder_student_smoke.py"))
    config["downscaler_kwargs"]["dropout"] = DROPOUT
    for name in ("teacher_kwargs", "auxiliary_decoder_kwargs"):
        config["auxiliary_networks_kwargs"][name]["dropout"] = DROPOUT
    gen = getters.get_dataloader_generator(
        config["dataset"], "student", config["dataloader_generator_kwargs"], config)
    encoder = getters.get_encoder(gen, config)
    trainer = main_encoder.student_trainer(config, gen, encoder, "cpu",
                                           str(configs["tmp"] / "student"))
    x = next(gen.dataloaders(batch_size=4)[0])["x"]
    trainer.init_state(x, lr=1e-3)
    return trainer, trainer.model, lambda: trainer.train_step(x, 3)


TRAINERS = {"vqcpc": _vqcpc, "decoder": _decoder, "prior": _prior,
            "student": _student}


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_trainer_steps_bit_equal_with_remat(kind, configs, monkeypatch, remat_calls):
    """Two steps from the same weights and seeds, without and with remat:
    the step's metrics and every parameter after each step bit for bit."""
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(configs["tmp"] / "data"))
    monkeypatch.setenv("VQCPCB_MIDI_ENCODER_CONFIG", configs["encoder"])
    runs = []
    for remat in ("0", "1"):
        monkeypatch.setenv("VQCPCB_REMAT", remat)
        torch.manual_seed(0)
        trainer, model, step = TRAINERS[kind](configs)
        history = []
        for _ in range(2):
            metrics = step()
            history.append(({k: v.clone() for k, v in metrics.items()},
                            [p.detach().clone() for p in model.parameters()]))
        runs.append(history)
        if remat == "0":
            assert not remat_calls
    assert remat_calls
    for (metrics, params), (rmetrics, rparams) in zip(*runs):
        assert metrics.keys() == rmetrics.keys()
        for key in metrics:
            assert torch.equal(metrics[key], rmetrics[key]), key
        assert all(torch.equal(p, r) for p, r in zip(params, rparams))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0][0][1], runs[0][1][1]))
