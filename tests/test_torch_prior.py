"""The port's prior slice against the JAX package on the CPU, at a small
size (2 layers, d_model 32, 2 heads, FF 48, embedding 8, a vocabulary of
11 codes, 12 events, batch 3): PriorRelative's logits and loss, every
parameter's gradient against jax.grad, the greedy KV-cached sampler's codes
bit for bit (from 0 and from a fixed prefix, against JAX's one-pass and
chunked scans); the port's own sampler invariants (the KV sampler against a
full forward per code, zero caches from position 0 against prefilled ones,
int8 caches, the temperature rule); generate_codes' sliding windows against
a naive greedy loop; and the PriorTrainer's step, save / load round trip
and exact mid-epoch resume.

The JAX side takes its XLA route here (the Pallas gates need a TPU); its
params are the shapes of jax.eval_shape filled from a seeded numpy
generator and go through vqcpcb_tpu_torch.convert (strict loads). Nothing
of the JAX trainer is compiled: prior.apply only."""
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.ops.sampling import sample_categorical
from vqcpcb_tpu_torch.training import checkpoints
from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_checkpoints as tc  # noqa: E402

VOCAB = 11
EVENTS = 12
BATCH = 3
GEOMETRY = dict(code_vocab_size=VOCAB, d_model=32, num_layers=2, n_head=2,
                dim_feedforward=48, embedding_size=8, num_channels=1,
                num_events=EVENTS, dropout=0.0)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def f32_caches(monkeypatch):
    """f32 KV caches on both sides (the CPU default of both packages,
    stated so an environment setting cannot change it)."""
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "float32")


@pytest.fixture(scope="module")
def priors():
    """(the JAX prior, its params, the port's prior with them): N(0, 0.2)
    from a numpy seed (LayerNorm scales 1 + N(0, 0.1))."""
    jprior = JaxPrior(**GEOMETRY)
    shapes = jax.eval_shape(functools.partial(jprior.init),
                            {"params": KEY, "dropout": KEY},
                            jnp.zeros((BATCH, EVENTS), jnp.int32))["params"]
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * noise
        return 0.2 * noise
    params = jax.tree_util.tree_map_with_path(fill, shapes)
    prior = PriorRelative(**GEOMETRY)
    prior.load_state_dict(convert.prior_state_dict(params), strict=True)
    return jprior, params, prior


def _codes(seed, batch=BATCH, events=EVENTS):
    return np.random.RandomState(seed).randint(0, VOCAB, (batch, events)).astype(np.int32)


def _greedy(prior, x, start, num_steps):
    """A full forward per code, argmax at each position (the reference's
    sampling strategy, prior_relative.py:327-353, at top_k 1)."""
    x = torch.as_tensor(x).long().clone()
    with torch.no_grad():
        for t in range(start, start + num_steps):
            x[:, t] = prior.eval().logits(x)[:, t].argmax(-1)
    return x


# ---- the model against JAX -----------------------------------------------------

def test_logits_and_loss_match_jax(priors):
    """Eval mode: logits within 1e-5 of max |logit|, the loss within 1e-6
    relative."""
    jprior, params, prior = priors
    x = _codes(1)
    want_logits = jax.jit(functools.partial(jprior.apply, method=JaxPrior.logits))(
        {"params": params}, jnp.asarray(x))
    want_loss = jax.jit(jprior.apply)({"params": params}, jnp.asarray(x))["loss"]
    with torch.no_grad():
        out = prior.eval()(torch.from_numpy(x))
    want_logits = np.asarray(want_logits)
    err = np.abs(out["weights_per_category"][0].numpy() - want_logits).max()
    assert err <= 1e-5 * np.abs(want_logits).max(), err
    np.testing.assert_allclose(out["loss"].item(), float(want_loss), rtol=1e-6)
    assert out["monitored_quantities"]["loss"] is out["loss"]


def test_gradients_match_jax_grad(priors):
    """Train mode (the attention's training route) at dropout 0: every
    parameter's gradient, sos and the relative tables included, within 1e-5
    of that tensor's max |gradient| of jax.grad of the JAX loss."""
    jprior, params, prior = priors
    x = _codes(2)
    grads = jax.jit(jax.grad(lambda p, inp: jprior.apply(
        {"params": p}, inp, training=True, rngs={"dropout": KEY})["loss"]))(
            params, jnp.asarray(x))
    want = convert.prior_state_dict(jax.device_get(grads))
    prior.train()
    prior.zero_grad(set_to_none=True)
    prior(torch.from_numpy(x))["loss"].backward()
    names = dict(prior.named_parameters())
    assert set(names) == set(want)
    assert any(".attn_bias.e1" in n for n in names) and "sos" in names
    for name, p in names.items():
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("chunk", ["0", "5"])
@pytest.mark.parametrize("start", [0, 8])
def test_greedy_sample_window_matches_jax(priors, monkeypatch, start, chunk):
    """Greedy (top_k 1) KV-cached codes equal JAX's bit for bit, from
    position 0 (the port's caches start as zeros, JAX's from a prefill) and
    from 8 with a fixed prefix, against JAX's sampler at
    VQCPCB_SAMPLER_CHUNK 0 (one scan) and 5 (prefix caches grown in chunks,
    a knob of the JAX scan that the port has no need of)."""
    jprior, params, prior = priors
    monkeypatch.setenv("VQCPCB_SAMPLER_CHUNK", chunk)
    x0 = _codes(7) if start else np.zeros((BATCH, EVENTS), np.int32)
    x0[:, start:] = 0
    want = jprior.apply({"params": params}, jnp.asarray(x0), start,
                        EVENTS - start, KEY, 1.0, 1,
                        method=JaxPrior.sample_window)
    got = prior.sample_window(x0, start, EVENTS - start,
                              torch.Generator().manual_seed(0), top_k=1,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, :start], x0[:, :start])


# ---- the port's sampler ---------------------------------------------------------

@pytest.mark.parametrize("start", [0, 8])
def test_kv_sampler_matches_full_forward_per_code(priors, start):
    _, _, prior = priors
    x0 = _codes(7)
    x0[:, start:] = 0
    got = prior.sample_window(x0, start, EVENTS - start,
                              torch.Generator().manual_seed(0), top_k=1,
                              device="cpu")
    assert torch.equal(got, _greedy(prior, x0, start, EVENTS - start))


def test_kv_sampler_from_zero_caches_equals_prefilled(priors, monkeypatch):
    """A window sampled from position 0 (no filter) starts from zero caches
    and draws the codes of the same window over prefilled caches from the
    same generator state: every row is written before it is read."""
    _, _, prior = priors
    x0 = _codes(5)
    want = prior.sample_window(x0, 0, EVENTS, torch.Generator().manual_seed(3),
                               device="cpu")
    monkeypatch.setattr(prior, "_empty_caches",
                        lambda b, length, dt: prior.prefill(
                            torch.from_numpy(x0).long(), dt))
    got = prior.sample_window(x0, 0, EVENTS, torch.Generator().manual_seed(3),
                              device="cpu")
    assert torch.equal(got, want)


def test_kv_sampler_int8_caches_agree(priors, monkeypatch):
    """VQCPCB_KV_DTYPE=int8 (the card's default) through in-format updates:
    greedy codes agree with the f32 caches' at more than 90% of the
    positions."""
    _, _, prior = priors
    x0 = np.zeros((8, EVENTS), np.int32)
    want = prior.sample_window(x0, 0, EVENTS, torch.Generator(), top_k=1,
                               device="cpu")
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "int8")
    got = prior.sample_window(x0, 0, EVENTS, torch.Generator(), top_k=1,
                              device="cpu")
    assert (got == want).float().mean().item() > 0.9


def test_temperature_sharpens(priors):
    """The prior's rule multiplies the logits by the temperature
    (p ~ softmax(logits) ** T, prior_relative.py:335-339): a high T
    approaches greedy decoding, a low one the uniform distribution."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(256, 1)
    assert (sample_categorical(gen, logits * 50.0) == 0).all()
    assert len(sample_categorical(gen, logits * 0.01).unique()) >= 3
    _, _, prior = priors
    x0 = np.zeros((16, EVENTS), np.int32)
    cold = prior.sample_window(x0, 0, EVENTS, gen, temperature=1e-3, device="cpu")
    assert len(cold.unique()) >= 8
    assert torch.equal(prior.sample_window(x0, 0, EVENTS, gen, temperature=1e6,
                                           device="cpu"),
                       _greedy(prior, x0, 0, EVENTS))


@pytest.mark.parametrize("chunk", [1, None])
def test_generate_codes_slides_its_window_as_jax(priors, chunk):
    """generate_codes at temperature 1e3 (argmax sampling) over 2 windows
    and a code: equal to a naive greedy loop over the same sliding windows
    (prior_trainer.py:217-226), with chunk 1 and the default, half the
    window."""
    _, _, prior = priors
    trainer = PriorTrainer(torch.nn.Identity(), prior, VOCAB, device="cpu")
    num_tokens = 2 * EVENTS + 1
    got = trainer.generate_codes(num_tokens, num_generated_codes=2,
                                 temperature=1e3, chunk=chunk)
    step = chunk or EVENTS // 2
    want = _greedy(prior, np.zeros((2, EVENTS), np.int32), 0, EVENTS).numpy()
    want = np.concatenate([want, np.zeros((2, num_tokens - EVENTS), np.int64)], 1)
    pos = EVENTS
    while pos < num_tokens:
        n = min(step, num_tokens - pos)
        window = np.concatenate([want[:, pos - (EVENTS - n):pos],
                                 np.zeros((2, n), np.int64)], 1)
        want[:, pos:pos + n] = _greedy(prior, window, EVENTS - n, n).numpy()[:, EVENTS - n:]
        pos += n
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---- the trainer ------------------------------------------------------------------

def test_trainer_step_loss_is_the_forward_loss(tmp_path):
    """One CPU step of tests/configs/prior_smoke.py at dropout 0: its loss is
    the training forward's on the frozen encoder's codes, and the step
    changes every parameter but the anticausal tables e2, which the causal
    mask leaves without a gradient."""
    trainer = tc.build_prior_trainer(tmp_path, "p", tc.prior_config(dropout=0.0))
    x = next(trainer.dataloader_generator.dataloaders(batch_size=8)[0])["x"]
    codes = trainer.encode_codes(x)
    assert codes.shape == (8, trainer.prior.num_tokens)
    with torch.no_grad():
        want = trainer.prior.train()(codes)["loss"]
    before = {k: v.clone() for k, v in trainer.prior.state_dict().items()}
    trainer.init_state(lr=1e-3)
    assert torch.equal(trainer.train_step(x)["loss"], want)
    assert trainer.step == 1
    for name, value in trainer.prior.state_dict().items():
        assert torch.equal(value, before[name]) == name.endswith(".attn_bias.e2"), name


def test_trainer_round_trip_restores_the_whole_state(tmp_path):
    """Dropout 0.1: parameters, Adam's moments, step and both generators
    equal after load, and the next step is the same step bit for bit."""
    config = tc.prior_config(dropout=0.1)
    a = tc.build_prior_trainer(tmp_path, "p", config)
    train = a.dataloader_generator.dataloaders(batch_size=8)[0]
    batches = [next(train)["x"] for _ in range(3)]
    a.init_state(lr=1e-3)
    for x in batches[:2]:
        a.train_step(x)
    a.save(early_stopped=True)
    assert checkpoints.latest_slot(a.model_dir) == "early_stopped"
    b = tc.build_prior_trainer(tmp_path, "p", config, init_seed=1, seed=5)
    b.init_state(lr=1e-3)
    b.load(early_stopped=True)
    tc.assert_states_equal(b.state_dict(), a.state_dict())
    assert b.step == 2 and b.optimizer.count == 2
    a.train_step(batches[2])
    b.train_step(batches[2])
    tc.assert_states_equal(b.state_dict(), a.state_dict())


def test_trainer_resume_from_step_checkpoint_is_exact(tmp_path):
    """Dropout 0.1 in every layer and in the attention weights: the resumed
    run ends with the uninterrupted run's prior, optimizer, step and
    generators, bit for bit, and the same metrics rows."""
    tc._resume_matches_uninterrupted(
        tmp_path, tc.build_prior_trainer, tc.prior_config(dropout=0.1),
        dict(batch_size=8, num_batches=5, num_epochs=2, lr=1e-3,
             checkpoint_every_steps=2))
