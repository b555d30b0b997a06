"""The port's modules against their JAX counterparts on the CPU, at small
widths. Weights are made by the JAX init and carried across by
vqcpcb_tpu_torch.convert; inputs are made with numpy from a seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.models.data_processor import BachCPCDataProcessor as JaxCPCProcessor
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.models.downscalers import GruDownscaler as JaxGruDownscaler
from vqcpcb_tpu.models.encoder import Encoder as JaxEncoder
from vqcpcb_tpu.models.upscalers import MlpUpscaler as JaxMlpUpscaler
from vqcpcb_tpu.ops.attention import MultiheadAttention as JaxMHA
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.quantizer import ProductVectorQuantizer as JaxPVQ
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer

VOCABS = [7, 9, 6, 8]
EMB = 16
GRU = 32
NUM_EVENTS = 24          # decoder window: 96 target tokens, 6 codes
CODE_VOCAB = 8


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- encoder ------------------------------------------------------------------

def _jax_encoder(num_codebooks=1, codebook_dim=3):
    return JaxEncoder(
        data_processor=JaxCPCProcessor(embedding_size=EMB, num_events=NUM_EVENTS,
                                       num_tokens_per_channel=VOCABS,
                                       num_tokens_per_block=16),
        downscaler=JaxGruDownscaler(output_dim=codebook_dim,
                                    downscale_factors=[16], hidden_size=GRU,
                                    num_layers=2, dropout=0.0,
                                    bidirectional=True),
        quantizer=JaxPVQ(codebook_size=CODE_VOCAB, codebook_dim=codebook_dim,
                         commitment_cost=0.25, num_codebooks=num_codebooks),
        upscaler=JaxMlpUpscaler(output_dim=32, hidden_size=GRU, dropout=0.0))


def _torch_encoder(num_codebooks=1, codebook_dim=3):
    return Encoder(
        BachCPCDataProcessor(EMB, NUM_EVENTS, VOCABS, num_tokens_per_block=16),
        GruDownscaler(EMB, codebook_dim, [16], GRU, num_layers=2, dropout=0.0,
                      bidirectional=True),
        ProductVectorQuantizer(CODE_VOCAB, codebook_dim, 0.25, num_codebooks),
        MlpUpscaler(codebook_dim, 32, GRU, 0.0)).eval()


def _tokens(rng, batch, events):
    return np.stack([rng.randint(0, v, size=(batch, events)) for v in VOCABS],
                    axis=-1).astype(np.int32)


def _encoder_pair(num_codebooks=1, codebook_dim=3):
    """JAX and port encoders with the same weights. The codebooks are taken
    from the downscaler's outputs (the reference's data-dependent init), so
    the codes spread over the codebook instead of all landing on the code
    nearest the origin."""
    rng = np.random.RandomState(0)
    x = _tokens(rng, 3, NUM_EVENTS)
    jenc = _jax_encoder(num_codebooks, codebook_dim)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = jax.tree.map(np.asarray, params)
    z = np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                              method=JaxEncoder.downscale)).reshape(-1, codebook_dim)
    rows = z[rng.permutation(len(z))[:CODE_VOCAB]]
    params["quantizer"]["codebooks"] = rows.reshape(
        CODE_VOCAB, num_codebooks, -1).transpose(1, 0, 2).astype(np.float32)
    enc = _torch_encoder(num_codebooks, codebook_dim)
    enc.load_state_dict(convert.encoder_state_dict(params), strict=True)
    return jenc, params, enc, x


def test_gru_downscaler_matches_jax():
    """The two independent GRUs (not torch's bidirectional GRU): z to 1e-5."""
    jenc, params, enc, x = _encoder_pair()
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                                 method=JaxEncoder.downscale))
    with torch.no_grad():
        got = enc.downscaler(enc.embed_tokens(_t(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unidirectional_gru_downscaler_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 48, EMB).astype(np.float32)
    jds = JaxGruDownscaler(output_dim=3, downscale_factors=[16], hidden_size=GRU,
                           num_layers=2, dropout=0.0, bidirectional=False)
    params = jds.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ds = GruDownscaler(EMB, 3, [16], GRU, 2, 0.0, bidirectional=False)
    sd = convert.encoder_state_dict({
        "data_processor": {}, "downscaler": params,
        "quantizer": {"codebooks": np.zeros((1, 1, 3))}})
    ds.load_state_dict({k[len("downscaler."):]: v for k, v in sd.items()
                        if k.startswith("downscaler.")}, strict=True)
    with torch.no_grad():
        got = ds(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jds.apply({"params": params}, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_encoder_matches_jax():
    """Indices exactly equal; z and the commitment loss to 1e-5."""
    jenc, params, enc, x = _encoder_pair()
    zq, idx, loss = jenc.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_zq, got_idx, got_loss = enc(_t(x))
    assert len(np.unique(np.asarray(idx))) > 2
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_zq.numpy(), np.asarray(zq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        merge_codes(got_idx, CODE_VOCAB).numpy(),
        np.asarray(idx)[..., 0])


@pytest.mark.parametrize("squared", [True, False])
def test_product_quantizer_matches_jax(squared):
    """Two sub-codebooks: indices exactly equal, outputs and loss to 1e-5."""
    rng = np.random.RandomState(1)
    z = rng.randn(5, 6, 4).astype(np.float32)
    jq = JaxPVQ(codebook_size=CODE_VOCAB, codebook_dim=4, commitment_cost=0.25,
                num_codebooks=2, squared_l2_norm=squared)
    params = {"codebooks": rng.randn(2, CODE_VOCAB, 2).astype(np.float32)}
    zq, idx, loss = jq.apply({"params": params}, jnp.asarray(z))
    q = ProductVectorQuantizer(CODE_VOCAB, 4, 0.25, 2, squared_l2_norm=squared)
    q.load_state_dict({f"embeddings.{k}": _t(params["codebooks"][k]) for k in range(2)})
    with torch.no_grad():
        got_zq, got_idx, got_loss = q(_t(z))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_zq.numpy(), np.asarray(zq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss), rtol=1e-5, atol=1e-5)


# ---- attention --------------------------------------------------------------

def _mha_pair(t=32, s=8):
    jm = JaxMHA(embed_dim=32, num_heads=4, attention_bias_type="relative_attention",
                num_channels_k=1, num_events_k=s, num_channels_q=1, num_events_q=t)
    rng = np.random.RandomState(2)
    xq = rng.randn(2, t, 32).astype(np.float32)
    xk = rng.randn(2, s, 32).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xk))["params"])
    m = MultiheadAttention(32, 4, "relative_attention", 1, s, 1, t).eval()
    m.load_state_dict(convert._attention(params, ""), strict=True)
    return jm, params, m, xq, xk


def test_multihead_attention_forward_matches_jax():
    """Cross attention at ratio 4 with the anticausal mask: output and
    weights to 1e-5."""
    jm, params, m, xq, xk = _mha_pair()
    mask = jax_anticausal(8, sz_tgt=32)
    out, w = jm.apply({"params": params}, jnp.asarray(xq), jnp.asarray(xk),
                      jnp.asarray(xk), attn_mask=mask)
    with torch.no_grad():
        got, got_w = m(_t(xq), _t(xk), attn_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [0, 13, 31])
def test_multihead_attention_step_matches_jax(t):
    """One decode position over f32 caches, causal rule: 1e-5."""
    jm, params, m, xq, _ = _mha_pair(t=32, s=32)
    xt = xq[:, t:t + 1]
    k, v = jm.apply({"params": params}, jnp.asarray(xq), method=JaxMHA.project_kv)
    want = jm.apply({"params": params}, jnp.asarray(xt), k, v, jnp.int32(t), 32,
                    method=JaxMHA.step)
    with torch.no_grad():
        got = m.step(_t(xt), _t(k), _t(v), t, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_encoder_layer_capture_and_step_match_jax():
    """TransformerEncoderLayer.capture (full forward + K/V) and one
    KV-cached step at a middle position, causal mask: 1e-5."""
    from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
    from vqcpcb_tpu.ops.transformer import TransformerEncoderLayer as JaxLayer
    from vqcpcb_tpu_torch.ops.transformer import TransformerEncoderLayer
    jl = JaxLayer(d_model=32, n_head=4, attention_bias_type="relative_attention",
                  num_channels=1, num_events=16, dim_feedforward=48, dropout=0.0)
    x = np.random.RandomState(5).randn(2, 16, 32).astype(np.float32)
    mask = jax_causal(16)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    out, (k, v) = jl.apply({"params": params}, jnp.asarray(x), mask,
                           method=JaxLayer.capture)
    step = jl.apply({"params": params}, jnp.asarray(x[:, 9:10]), k, v,
                    jnp.int32(9), 16, method=JaxLayer.step)
    layer = TransformerEncoderLayer(32, 4, "relative_attention", 1, 16, 48)
    layer.load_state_dict(convert._transformer_layer(params, ""), strict=True)
    with torch.no_grad():
        got, (gk, gv) = layer.capture(_t(x), _t(mask))
        got_step = layer.step(_t(x[:, 9:10]), gk, gv, 9, 16)
    for g, w in ((got, out), (gk, k), (gv, v), (got_step, step)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ---- decoder ----------------------------------------------------------------

def _jax_decoder():
    return JaxDecoder(
        data_processor=JaxProcessor(embedding_size=EMB, num_events=NUM_EVENTS,
                                    num_tokens_per_channel=VOCABS),
        transformer_type="relative", encoder_attention_type="anticausal",
        cross_attention_type="diagonal", d_model=32, num_encoder_layers=1,
        num_decoder_layers=1, n_head=2, dim_feedforward=48,
        positional_embedding_size=4, num_channels_encoder=1,
        num_events_encoder=NUM_EVENTS * 4 // 16, num_channels_decoder=4,
        num_events_decoder=NUM_EVENTS, dropout=0.0, total_upscaling=16,
        source_vocab_size=CODE_VOCAB)


def _torch_decoder():
    return Decoder(
        BachDataProcessor(EMB, NUM_EVENTS, VOCABS), "anticausal", d_model=32,
        num_encoder_layers=1, num_decoder_layers=1, n_head=2,
        dim_feedforward=48, positional_embedding_size=4,
        num_channels_encoder=1, num_events_encoder=NUM_EVENTS * 4 // 16,
        num_channels_decoder=4, num_events_decoder=NUM_EVENTS,
        total_upscaling=16, source_vocab_size=CODE_VOCAB).eval()


@pytest.fixture(scope="module")
def decoder_pair():
    rng = np.random.RandomState(3)
    source = rng.randint(0, CODE_VOCAB, size=(2, NUM_EVENTS * 4 // 16)).astype(np.int32)
    target = _tokens(rng, 2, NUM_EVENTS)
    jdec = _jax_decoder()
    params = jdec.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(source), jnp.asarray(target))["params"]
    dec = _torch_decoder()
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    return jdec, params, dec, source, target


def test_decoder_forward_matches_jax(decoder_pair):
    """Per-channel logits and CE to 1e-4 (6 layers of f32 sums in two
    orders)."""
    jdec, params, dec, source, target = decoder_pair
    out = jdec.apply({"params": params}, jnp.asarray(source), jnp.asarray(target))
    with torch.no_grad():
        got = dec(_t(source), _t(target))
    for g, w in zip(got["weights_per_category"], out["weights_per_category"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"].item(), float(out["loss"]), rtol=1e-4)


def test_decoder_prefill_matches_jax(decoder_pair):
    """f32 caches and the aligned cross branch to 1e-4."""
    jdec, params, dec, source, target = decoder_pair
    caches, crosses = jdec.apply({"params": params}, jnp.asarray(source),
                                 jnp.asarray(target), method=JaxDecoder.prefill)
    with torch.no_grad():
        got_caches, got_crosses = dec.prefill(_t(source), _t(target), None)
    for (gk, gv), (k, v) in zip(got_caches, caches):
        np.testing.assert_allclose(gk.numpy(), np.asarray(k), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gv.numpy(), np.asarray(v), rtol=1e-4, atol=1e-4)
    for g, w in zip(got_crosses, crosses):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _forbidden():
    return np.array([[0, 1, 2], [3, 4, 5], [0, 2, 4], [1, 3, 5]], np.int32)


@pytest.mark.parametrize("start,forbidden", [(0, False), (37, True)])
def test_sample_range_greedy_matches_jax(decoder_pair, start, forbidden):
    """Greedy (top_k=1) KV-cached sampling with f32 caches: tokens exactly
    equal, from position 0 and from a mid start with forbidden tokens."""
    jdec, params, dec, source, target = decoder_pair
    num_steps = NUM_EVENTS * 4 - start
    forb = _forbidden() if forbidden else None
    want = jdec.apply({"params": params}, jnp.asarray(source), jnp.asarray(target),
                      start, num_steps, jax.random.PRNGKey(0), 1.0, 1, 0.0,
                      None if forb is None else jnp.asarray(forb),
                      method=JaxDecoder.sample_range)
    got = dec.sample_range(source, target, start, num_steps,
                           torch.Generator().manual_seed(0), top_k=1,
                           forbidden_indices=forb, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = got.numpy().reshape(2, -1)
    np.testing.assert_array_equal(flat[:, :start], target.reshape(2, -1)[:, :start])
    if forbidden:
        for t in range(start, NUM_EVENTS * 4):
            assert not np.isin(flat[:, t], forb[t % 4]).any()


def test_kv_cached_greedy_matches_teacher_forced_argmax(decoder_pair):
    """The KV-cached tokens equal a full forward's argmax at each position,
    given the tokens before it (the port's twin of
    tests/test_decoder.py:test_kv_cached_sampler_matches_full_forward)."""
    _, _, dec, source, _ = decoder_pair
    tokens = np.zeros((2, NUM_EVENTS, 4), np.int32)
    got = dec.sample_range(source, tokens, 0, NUM_EVENTS * 4,
                           torch.Generator().manual_seed(0), top_k=1,
                           device="cpu").numpy()
    with torch.no_grad():
        logits = dec(_t(source), _t(got))["weights_per_category"]
    for c in range(4):
        np.testing.assert_array_equal(logits[c].argmax(-1).numpy(), got[..., c])


def test_sample_range_needs_the_card_unless_told_cpu(decoder_pair, monkeypatch):
    _, _, dec, source, target = decoder_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dec.sample_range(source, target, 0, 1, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dec.sample_range(source, target, 0, 1, torch.Generator(), device="cuda")
