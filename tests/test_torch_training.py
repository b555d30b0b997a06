"""The port's decoder-training slice against the JAX package on the CPU, in
f32 at dropout 0: the MHA training route, the losses, the whole Decoder's
loss and gradients, and the optimizer against optax (one
DecoderTrainer.train_step against JAX's is in test_torch_generation.py,
beside the JAX trainer it reuses). Weights come from the JAX init
through vqcpcb_tpu_torch.convert; inputs are made with numpy from a seed."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.ops import losses as jax_losses
from vqcpcb_tpu.ops.attention import MultiheadAttention as JaxMHA
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
from vqcpcb_tpu.training import optim as jax_optim
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import BachDataProcessor
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.ops import losses
from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
from vqcpcb_tpu_torch.training import optim

VOCABS = [7, 9, 6, 8]
NUM_EVENTS = 24          # 96 target tokens from 6 codes
CODE_VOCAB = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    """max |got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# ---- attention training route -------------------------------------------------

@pytest.mark.parametrize("t,s,self_attn", [(16, 16, True), (32, 8, False)])
def test_mha_training_route_matches_jax(t, s, self_attn):
    """Output and the gradients of the inputs and of every parameter
    (in_proj, out_proj, e1, e2): f32 on both sides, sums in other orders,
    within 1e-5 of each result's scale."""
    jm = JaxMHA(embed_dim=32, num_heads=2, attention_bias_type="relative_attention",
                num_channels_k=1, num_events_k=s, num_channels_q=1, num_events_q=t,
                dropout=0.0)
    rng = np.random.RandomState(7)
    xq = rng.randn(2, t, 32).astype(np.float32)
    xk = xq if self_attn else rng.randn(2, s, 32).astype(np.float32)
    g = rng.randn(2, t, 32).astype(np.float32)
    mask = np.asarray(jax_causal(t) if self_attn else jax_anticausal(s, sz_tgt=t))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xk))["params"])

    def jloss(p, q_in, k_in):
        k_in = q_in if self_attn else k_in
        out, _ = jm.apply({"params": p}, q_in, k_in, k_in, attn_mask=jnp.asarray(mask),
                          training=True)
        return (out * g).sum(), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(xq), jnp.asarray(xk))
    m = MultiheadAttention(32, 2, "relative_attention", 1, s, 1, t)
    m.load_state_dict(convert._attention(params, ""), strict=True)
    q_in = _t(xq).requires_grad_(True)
    k_in = q_in if self_attn else _t(xk).requires_grad_(True)
    m.train()
    out, weights = m(q_in, k_in, attn_mask=_t(mask))
    assert weights is None
    out.backward(_t(g))
    _close(out, want, 1e-5, "out")
    _close(q_in.grad, jgrads[1], 1e-5, "d query")
    if not self_attn:
        _close(k_in.grad, jgrads[2], 1e-5, "d key")
    want_grads = convert._attention(jax.tree.map(np.asarray, jgrads[0]), "")
    for name, p in m.named_parameters():
        _close(p.grad, want_grads[name], 1e-5, name)


# ---- losses -------------------------------------------------------------------

def test_losses_match_jax():
    """Per-channel and stacked cross entropy with a ragged mask (each channel
    normalised by its own count): 1e-6 relative."""
    rng = np.random.RandomState(1)
    target = np.stack([rng.randint(0, v, (3, 5)) for v in VOCABS], -1).astype(np.int32)
    logits = [rng.randn(3, 5, v).astype(np.float32) * 3 for v in VOCABS]
    mask = (rng.rand(3, 5, 4) > 0.3).astype(np.float32)
    want = jax_losses.categorical_crossentropy([jnp.asarray(x) for x in logits],
                                               jnp.asarray(target), jnp.asarray(mask))
    got = losses.categorical_crossentropy([_t(x) for x in logits], _t(target), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    stacked = rng.randn(3, 5, 4, sum(VOCABS)).astype(np.float32) * 3
    want = jax_losses.stacked_categorical_crossentropy(
        jnp.asarray(stacked), jnp.asarray(target), VOCABS, jnp.asarray(mask))
    got = losses.stacked_categorical_crossentropy(_t(stacked), _t(target), VOCABS, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---- the decoder as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def decoder_pair():
    """A 2+2-layer, d_model 32, 2-head AC/D/C decoder in both frameworks with
    the same weights, and a batch of codes and tokens."""
    rng = np.random.RandomState(3)
    source = rng.randint(0, CODE_VOCAB, size=(2, NUM_EVENTS * 4 // 16)).astype(np.int32)
    target = np.stack([rng.randint(0, v, size=(2, NUM_EVENTS)) for v in VOCABS],
                      axis=-1).astype(np.int32)
    jdec = JaxDecoder(
        data_processor=JaxProcessor(embedding_size=16, num_events=NUM_EVENTS,
                                    num_tokens_per_channel=VOCABS),
        transformer_type="relative", encoder_attention_type="anticausal",
        cross_attention_type="diagonal", d_model=32, num_encoder_layers=2,
        num_decoder_layers=2, n_head=2, dim_feedforward=48,
        positional_embedding_size=4, num_channels_encoder=1,
        num_events_encoder=NUM_EVENTS * 4 // 16, num_channels_decoder=4,
        num_events_decoder=NUM_EVENTS, dropout=0.0, total_upscaling=16,
        source_vocab_size=CODE_VOCAB)
    params = jax.jit(jdec.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(source), jnp.asarray(target))["params"]
    dec = Decoder(
        BachDataProcessor(16, NUM_EVENTS, VOCABS), "anticausal", d_model=32,
        num_encoder_layers=2, num_decoder_layers=2, n_head=2, dim_feedforward=48,
        positional_embedding_size=4, num_channels_encoder=1,
        num_events_encoder=NUM_EVENTS * 4 // 16, num_channels_decoder=4,
        num_events_decoder=NUM_EVENTS, total_upscaling=16,
        source_vocab_size=CODE_VOCAB, dropout=0.0)
    dec.load_state_dict(convert.decoder_state_dict(jax.device_get(params)), strict=True)
    return jdec, params, dec, source, target


def test_decoder_training_loss_and_gradients_match_jax(decoder_pair):
    """Decoder.__call__(training=True) and its gradient against the port's
    train-mode forward (the relbias training route in all 4 attention
    layers, the fused output head): loss to 1e-5 relative, every parameter's
    gradient within 1e-4 of its max |value| (f32 sums in other orders
    through 4 post-LN layers)."""
    jdec, params, dec, source, target = decoder_pair

    def jloss(p):
        return jdec.apply({"params": p}, jnp.asarray(source), jnp.asarray(target),
                          training=True, rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = convert.decoder_state_dict(jax.device_get(jgrads))
    dec.train()
    loss = dec(_t(source), _t(target))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    names = dict(dec.named_parameters())
    assert set(names) == set(want_grads)
    for name, p in names.items():
        w = want_grads[name].numpy()
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-3), (name, err)


def test_decoder_eval_forward_matches_training_forward_at_dropout_0(decoder_pair):
    """In eval mode the inference route and the fused head give the training
    route's loss (f32 on the CPU): 1e-6 relative."""
    _, _, dec, source, target = decoder_pair
    with torch.no_grad():
        train_loss = dec.train()(_t(source), _t(target))["loss"]
        eval_loss = dec.eval()(_t(source), _t(target))["loss"]
    np.testing.assert_allclose(eval_loss.item(), train_loss.item(), rtol=1e-6)


# ---- optimizer -------------------------------------------------------------------

def test_trapezoid_schedule_matches_jax(monkeypatch):
    monkeypatch.setenv("VQCPCB_WARMUP_STEPS", "40")
    want = jax_optim.trapezoid_schedule(3e-4)
    got = optim.trapezoid_schedule(3e-4, warmup_steps=40)
    for step in (0, 1, 20, 40, 41, 200, 400, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("schedule", [False, True])
def test_clipped_adam_matches_optax(monkeypatch, schedule):
    """clip_by_global_norm(5) then Adam over 5 steps, with gradients below
    and above the clip norm: parameters within 1e-6 after every step."""
    monkeypatch.setenv("VQCPCB_WARMUP_STEPS", "3")
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = jax_optim.make_optimizer(1e-2, schedule_lr=schedule)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(_t(p)) for p in init]
    opt = optim.Adam(params, optim.trapezoid_schedule(1e-2, 3) if schedule else 1e-2)
    for step, scale in enumerate((0.1, 10.0, 1.0, 30.0, 0.01)):
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = _t(g)
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)),
                                   rtol=1e-5)
        for p, w in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=f"step {step}")


def test_clip_leaves_small_gradients_alone():
    g = [torch.full((3,), 1.0), torch.full((2,), 2.0)]
    norm = optim.clip_by_global_norm(g)
    assert norm.item() == pytest.approx(np.sqrt(11.0))
    assert g[0].tolist() == [1.0] * 3 and g[1].tolist() == [2.0] * 2
