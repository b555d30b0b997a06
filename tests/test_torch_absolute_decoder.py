"""The absolute decoder of configs/decoder_random.py (decoder_type
'transformer': absolute transformer, anticausal encoder, full
cross-attention, getters.py:283) against the JAX package on the CPU, at
d_model 32, 2 + 2 layers, 2 heads: logits, loss and every gradient, the
prefill, greedy KV-cached sampling, generate_from_code_long and one train
step. Also the relative decoder with an attention cross branch (AC/AC/C),
which the attention decoder layer now builds, and the explicit-bias route
(VQCPCB_PALLAS_RELBIAS=0) against the in-kernel route. Weights come from
the JAX init through vqcpcb_tpu_torch.convert; inputs are made with numpy
from a seed."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_generation import CODEBOOK, build_decoder_trainer, port_generator
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import BachDataProcessor
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
from vqcpcb_tpu_torch.training.decoder_trainer import \
    DecoderTrainer as PortDecoderTrainer

VOCABS = [7, 9, 6, 8]
NUM_EVENTS = 16          # 64 target tokens from 4 codes
CODE_VOCAB = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(transformer_type, cross_attention_type, layers=2):
    """A JAX decoder and the port's with the same weights, and a batch."""
    rng = np.random.RandomState(3)
    source = rng.randint(0, CODE_VOCAB, size=(2, NUM_EVENTS * 4 // 16)).astype(np.int32)
    target = np.stack([rng.randint(0, v, size=(2, NUM_EVENTS)) for v in VOCABS],
                      axis=-1).astype(np.int32)
    geometry = dict(d_model=32, num_encoder_layers=layers,
                    num_decoder_layers=layers, n_head=2, dim_feedforward=48,
                    positional_embedding_size=4, num_channels_encoder=1,
                    num_events_encoder=NUM_EVENTS * 4 // 16,
                    num_channels_decoder=4, num_events_decoder=NUM_EVENTS,
                    total_upscaling=16, source_vocab_size=CODE_VOCAB)
    jdec = JaxDecoder(
        data_processor=JaxProcessor(embedding_size=16, num_events=NUM_EVENTS,
                                    num_tokens_per_channel=VOCABS),
        transformer_type=transformer_type, encoder_attention_type="anticausal",
        cross_attention_type=cross_attention_type, dropout=0.0, **geometry)
    params = jax.jit(jdec.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(source), jnp.asarray(target))["params"]
    dec = Decoder(BachDataProcessor(16, NUM_EVENTS, VOCABS), "anticausal",
                  transformer_type=transformer_type,
                  cross_attention_type=cross_attention_type, **geometry)
    dec.load_state_dict(convert.decoder_state_dict(jax.device_get(params)), strict=True)
    return jdec, params, dec.eval(), source, target


@pytest.fixture(scope="module")
def absolute():
    return _pair("absolute", "full")


@pytest.fixture(scope="module")
def relative_cross():
    return _pair("relative", "anticausal", layers=1)


def test_absolute_decoder_builds_the_reference_layout(absolute):
    """Absolute embeddings (source d_model - p wide), no relative tables,
    and an attention cross branch under the reference name."""
    _, _, dec, _, _ = absolute
    sd = dec.state_dict()
    assert sd["source_embeddings.weight"].shape == (CODE_VOCAB, 32 - 4)
    assert sd["source_positional_embeddings"].shape == (1, NUM_EVENTS * 4 // 16, 4)
    assert sd["target_positional_embeddings"].shape == (1, NUM_EVENTS * 4, 4)
    assert not any("attn_bias" in k or "target_channel" in k or "cross_attn" in k
                   for k in sd)
    assert "transformer.decoder.layers.1.multihead_attn.in_proj_weight" in sd


@pytest.mark.parametrize("kind", ["absolute", "relative_cross"])
def test_decoder_forward_matches_jax(kind, request):
    """Per-channel logits and CE, eval mode, to 1e-4 (f32 sums in two
    orders through the layers)."""
    jdec, params, dec, source, target = request.getfixturevalue(kind)
    out = jdec.apply({"params": params}, jnp.asarray(source), jnp.asarray(target))
    with torch.no_grad():
        got = dec(_t(source), _t(target))
    for g, w in zip(got["weights_per_category"], out["weights_per_category"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"].item(), float(out["loss"]), rtol=1e-4)


def test_absolute_decoder_training_loss_and_gradients_match_jax(absolute):
    """Decoder.__call__(training=True) at dropout 0 and its gradient against
    the port's train-mode forward (K6's plain version with the placeholder
    bias in all 6 attentions, f32): loss to 1e-5 relative, every parameter's
    gradient within 1e-4 of its max |value|."""
    jdec, params, dec, source, target = absolute
    dec = copy.deepcopy(dec).train()

    def jloss(p):
        return jdec.apply({"params": p}, jnp.asarray(source), jnp.asarray(target),
                          training=True, rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = convert.decoder_state_dict(jax.device_get(jgrads))
    loss = dec(_t(source), _t(target))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    names = dict(dec.named_parameters())
    assert set(names) == set(want_grads)
    for name, p in names.items():
        w = want_grads[name].numpy()
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-3), (name, err)


def test_absolute_decoder_prefill_matches_jax(absolute):
    """f32 self caches and the memory's K/V of every layer to 1e-4."""
    jdec, params, dec, source, target = absolute
    caches, crosses = jdec.apply({"params": params}, jnp.asarray(source),
                                 jnp.asarray(target), method=JaxDecoder.prefill)
    with torch.no_grad():
        got_caches, got_crosses = dec.prefill(_t(source), _t(target), None)
    for got, want in ((got_caches, caches), (got_crosses, crosses)):
        for (gk, gv), (k, v) in zip(got, want):
            np.testing.assert_allclose(gk.numpy(), np.asarray(k), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(gv.numpy(), np.asarray(v), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,start,forbidden", [
    ("absolute", 0, False), ("absolute", 37, True), ("relative_cross", 21, False)])
def test_sample_range_greedy_matches_jax(kind, start, forbidden, request):
    """Greedy (top_k=1) KV-cached sampling with f32 caches, the cross
    attention stepping over the memory's K/V (anticausal key mask for
    AC/AC/C): tokens exactly equal."""
    jdec, params, dec, source, target = request.getfixturevalue(kind)
    num_steps = NUM_EVENTS * 4 - start
    forb = (np.array([[0, 1, 2], [3, 4, 5], [0, 2, 4], [1, 3, 5]], np.int32)
            if forbidden else None)
    want = jdec.apply({"params": params}, jnp.asarray(source), jnp.asarray(target),
                      start, num_steps, jax.random.PRNGKey(0), 1.0, 1, 0.0,
                      None if forb is None else jnp.asarray(forb),
                      method=JaxDecoder.sample_range)
    got = dec.sample_range(source, target, start, num_steps,
                           torch.Generator().manual_seed(0), top_k=1,
                           forbidden_indices=forb, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_absolute_kv_cached_greedy_matches_teacher_forced_argmax(absolute):
    _, _, dec, source, _ = absolute
    tokens = np.zeros((2, NUM_EVENTS, 4), np.int32)
    got = dec.sample_range(source, tokens, 0, NUM_EVENTS * 4,
                           torch.Generator().manual_seed(0), top_k=1,
                           device="cpu").numpy()
    with torch.no_grad():
        logits = dec(_t(source), _t(got))["weights_per_category"]
    for c in range(4):
        np.testing.assert_array_equal(logits[c].argmax(-1).numpy(), got[..., c])


# ---- the slice through the trainers ---------------------------------------------

@pytest.fixture(scope="module")
def trainer_pair(tmp_path_factory):
    """The JAX DecoderTrainer of the absolute decoder ('transformer') and
    the port's DecoderGenerator with its weights."""
    trainer, x0 = build_decoder_trainer(tmp_path_factory.mktemp("absolute"),
                                        "transformer")
    return trainer, port_generator(trainer), np.asarray(x0)


def test_absolute_generate_from_code_long_greedy_matches_jax(trainer_pair):
    trainer, port, _ = trainer_pair
    assert port.decoder.transformer_type == "absolute"
    codes = np.random.RandomState(1).randint(0, CODEBOOK, size=(1, 9)).astype(np.int32)
    kwargs = dict(temperature=1.0, top_k=1, num_decodings=2, code_index_start=1,
                  code_index_end=8, exclude_meta_symbols=True, codes_per_window=2)
    want = trainer.generate_from_code_long(codes, **kwargs)
    got = port.generate_from_code_long(codes, **kwargs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_absolute_train_step_matches_jax(trainer_pair):
    """One DecoderTrainer.train_step against the JAX trainer's (f32,
    dropout 0, Adam lr 1e-3 with the clip), as test_torch_generation.py
    holds the relative decoder's: loss to 1e-5 relative, every parameter
    within 1e-6 of JAX's, or within 2 * lr where |grad| < 1e-5 (Adam's
    first step is ill-conditioned there)."""
    trainer, port, x0 = trainer_pair
    lr = 1e-3
    ours = PortDecoderTrainer(copy.deepcopy(port.encoder), copy.deepcopy(port.decoder),
                              CODEBOOK, device="cpu", seed=0).init_state(lr)
    state = jax.tree.map(jnp.array, trainer.state)     # train_step donates it
    state, metrics = trainer._train_step(state, trainer.encoder_variables,
                                         jnp.asarray(x0), jax.random.PRNGKey(5))
    got = ours.train_step(x0)
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    want = convert.decoder_state_dict(jax.device_get(state.params))
    for name, p in ours.decoder.named_parameters():
        small = p.grad.abs() < 1e-5
        err = (p.detach() - want[name]).abs()
        assert bool((err[~small] <= 1e-6).all()), (name, float(err[~small].max()))
        assert bool((err[small] <= 2 * lr).all()), name


# ---- the explicit-bias route ------------------------------------------------------

@pytest.mark.parametrize("cross", ["diagonal", "anticausal"])
def test_explicit_bias_route_matches_the_in_kernel_route(monkeypatch, cross):
    """A relative decoder in train mode at dropout 0, f32 on the CPU: with
    VQCPCB_PALLAS_RELBIAS=0 each relative layer builds its (B*H, T, S) bias
    in PyTorch and runs K6 (the bias's gradient, ds, flows back to e1 and
    e2 through autograd); with the default it runs the relative-bias
    kernels. Loss to 1e-6 relative, every gradient within 1e-5 of its max
    |value|. Only K6 runs on the explicit route."""
    _, _, dec, source, target = _pair("relative", cross, layers=1)
    dec.train()
    grads = {}
    for gate in ("1", "0"):
        monkeypatch.setenv("VQCPCB_PALLAS_RELBIAS", gate)
        dec.zero_grad(set_to_none=True)
        loss = dec(_t(source), _t(target))["loss"]
        loss.backward()
        grads[gate] = (loss.item(), {n: p.grad.clone() for n, p in dec.named_parameters()})
    np.testing.assert_allclose(grads["0"][0], grads["1"][0], rtol=1e-6)
    for name, want in grads["1"][1].items():
        err = float((grads["0"][1][name] - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1e-3), (name, err)
    assert grads["0"][1]["transformer.decoder.layers.0.self_attn.attn_bias.e1"].abs().max() > 0
