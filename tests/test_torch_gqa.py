"""Grouped-query attention in the port (MultiheadAttention's num_kv_heads,
the decoder's and the prior's n_head_kv) against the JAX package on the
CPU, at a small size: d_model 32, 4 heads of 8, n_head_kv 1 and 2, 2 + 2
decoder layers, FF 48.

- The grouped MHA, relative and absolute, against JAX's grouped MHA in eval
  (output and weights) and in train mode at dropout 0 (output, and every
  parameter's gradient against jax.grad): the port's plain route expands k
  and v to 4 heads, JAX's grouped einsum does not; the same function in f32.
- The grouped MHA against an ungrouped one whose K/V rows are tied within
  each group (the anchor of tests/test_gqa.py), and its kv_proj gradient
  against the tied rows' gradients summed over each group.
- The cached `step` over H_kv-head caches against the full forward and
  JAX's step; the caches' shape (B, H_kv, S, hd).
- Grouped decoders (the flagship AC/D/C and the absolute decoder): logits
  and loss against JAX, the prefill's cache shape, greedy KV-cached tokens
  equal to the teacher-forced argmax; the grouped prior's greedy codes bit
  for bit against JAX's grouped sampler, its zero caches' shape, and one
  PriorTrainer step and generate_codes over it.
- The decoder and prior CLIs on grouped copies of the test configs.

Tolerances: 1e-5 of the largest |value| for forwards, 1e-4 for gradients
(tests/test_torch_models.py's), equal ints for tokens and codes. JAX params
are jax.eval_shape's shapes filled from a seeded numpy generator
(tests/test_torch_getters.py's random_params); nothing of a JAX trainer is
compiled."""
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu.ops.attention import MultiheadAttention as JaxMHA
from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import BachDataProcessor
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_getters import random_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
RNGS = {"params": KEY, "dropout": KEY}
E, H, HD = 32, 4, 8
T = 12
VOCABS = [7, 9, 6, 8]
NUM_EVENTS = 16          # 64 target tokens, 4 codes of 16
CODES = NUM_EVENTS * 4 // 16
CODE_VOCAB = 8
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


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


def close(got, want, tol):
    """got within tol of want's largest |value|."""
    got, want = (x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
                 for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the attention module ---------------------------------------------------------

def mha_pair(relative: bool, kv_heads: int, seed: int = 0):
    """(JAX grouped MHA, its params, the port's with them, x (2, T, E)):
    self-attention over T = 12 positions, with the relative bias or none."""
    kw = dict(attention_bias_type="relative_attention" if relative else None,
              num_channels_k=1, num_events_k=T, num_channels_q=1,
              num_events_q=T)
    x = np.random.RandomState(seed + 1).randn(2, T, E).astype(np.float32)
    jm = JaxMHA(embed_dim=E, num_heads=H, num_kv_heads=kv_heads, **kw)
    params = random_params(jm.init, KEY, jnp.asarray(x), jnp.asarray(x),
                           jnp.asarray(x), seed=seed)
    m = MultiheadAttention(E, H, num_kv_heads=kv_heads, **kw)
    m.load_state_dict(convert._attention(params, ""), strict=True)
    return jm, params, m, x


CASES = [(rel, kv) for rel in (True, False) for kv in (1, 2)]
IDS = [f"{'relative' if rel else 'absolute'}-kv{kv}" for rel, kv in CASES]


@pytest.mark.parametrize("relative,kv_heads", CASES, ids=IDS)
def test_grouped_mha_eval_matches_jax(relative, kv_heads):
    """Eval, causal mask: the output and the (B, H, T, T) weights."""
    jm, params, m, x = mha_pair(relative, kv_heads)
    assert m.grouped and not hasattr(m, "in_proj_weight")
    mask = jax_causal(T)
    out, w = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(x),
                      jnp.asarray(x), attn_mask=mask)
    with torch.no_grad():
        got, got_w = m.eval()(_t(x), _t(x), attn_mask=_t(mask))
    close(got, out, FWD_TOL)
    close(got_w, w, FWD_TOL)


@pytest.mark.parametrize("relative,kv_heads", CASES, ids=IDS)
def test_grouped_mha_train_matches_jax(relative, kv_heads):
    """Train mode at dropout 0, causal mask (the port's training route, its
    plain versions here): the output, and the gradient of <out, g> for
    every parameter (q_proj, kv_proj, out_proj, the relative tables)."""
    jm, params, m, x = mha_pair(relative, kv_heads)
    g = np.random.RandomState(9).randn(2, T, E).astype(np.float32)
    mask = jax_causal(T)

    def loss(p):
        out, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(x),
                          jnp.asarray(x), attn_mask=mask, training=True)
        return jnp.sum(out * g), out
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = convert._attention(jax.device_get(grads), "")
    m.train()
    xt = _t(x)
    got, _ = m(xt, xt, attn_mask=_t(mask))
    close(got, out, FWD_TOL)
    (got * _t(g)).sum().backward()
    names = dict(m.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        close(p.grad, want[name].numpy(), GRAD_TOL)


def _tied_ungrouped(m: MultiheadAttention) -> MultiheadAttention:
    """An ungrouped MHA whose in_proj rows repeat each KV head's rows over
    its group of query heads (query head h reads KV head h // g)."""
    g = H // m.num_kv_heads
    u = MultiheadAttention(E, H, "relative_attention" if m.attn_bias else None,
                           1, T, 1, T)

    def tie(w):              # (H_kv * hd, ...) -> (H * hd, ...)
        return w.view(m.num_kv_heads, HD, *w.shape[1:]).repeat_interleave(
            g, dim=0).reshape(E, *w.shape[1:])
    k_w, v_w = m.kv_proj.weight.chunk(2)
    k_b, v_b = m.kv_proj.bias.chunk(2)
    sd = {"in_proj_weight": torch.cat([m.q_proj.weight, tie(k_w), tie(v_w)]),
          "in_proj_bias": torch.cat([m.q_proj.bias, tie(k_b), tie(v_b)])}
    sd.update({k: v for k, v in m.state_dict().items()
               if not k.startswith(("q_proj", "kv_proj"))})
    u.load_state_dict({k: v.detach().clone() for k, v in sd.items()},
                      strict=True)
    return u


@pytest.mark.parametrize("relative,kv_heads", CASES, ids=IDS)
def test_grouped_mha_equals_tied_ungrouped(relative, kv_heads):
    """The grouped MHA equals the ungrouped one with tied K/V (1e-5), in
    eval (output, weights) and in train mode; the grouped kv_proj's
    gradient is the tied rows' gradients summed over each group (1e-4):
    autograd sums dk and dv over the expansion."""
    _, _, m, x = mha_pair(relative, kv_heads)
    u = _tied_ungrouped(m)
    xt, mask = _t(x), _t(jax_causal(T))
    with torch.no_grad():
        got, got_w = m.eval()(xt, xt, attn_mask=mask)
        want, want_w = u.eval()(xt, xt, attn_mask=mask)
    close(got, want, FWD_TOL)
    close(got_w, want_w, FWD_TOL)
    g = torch.randn(2, T, E, generator=torch.Generator().manual_seed(3))
    outs = []
    for mod in (m, u):
        mod.train()
        out, _ = mod(xt, xt, attn_mask=mask)
        (out * g).sum().backward()
        outs.append(out)
    close(outs[0], outs[1], FWD_TOL)
    kv_rows = u.in_proj_weight.grad[E:].view(2, kv_heads, H // kv_heads, HD, E)
    close(m.kv_proj.weight.grad, kv_rows.sum(2).reshape(-1, E), GRAD_TOL)
    close(m.q_proj.weight.grad, u.in_proj_weight.grad[:E], GRAD_TOL)


@pytest.mark.parametrize("relative,kv_heads", CASES, ids=IDS)
def test_grouped_step_matches_full_forward_and_jax(relative, kv_heads):
    """`step` at positions 0, 5 and 11 over the H_kv-head caches (shape (B,
    H_kv, T, hd)): the full causal forward's row t and JAX's grouped step,
    1e-5."""
    jm, params, m, x = mha_pair(relative, kv_heads)
    k, v = jm.apply({"params": params}, jnp.asarray(x), method=JaxMHA.project_kv)
    with torch.no_grad():
        gk, gv = m.eval().project_kv(_t(x))
        full, _ = m(_t(x), _t(x), attn_mask=_t(jax_causal(T)))
    assert gk.shape == gv.shape == (2, kv_heads, T, HD)
    close(gk, k, FWD_TOL)
    close(gv, v, FWD_TOL)
    for t in (0, 5, 11):
        xt = x[:, t:t + 1]
        want = jm.apply({"params": params}, jnp.asarray(xt), k, v, jnp.int32(t),
                        T, method=JaxMHA.step)
        with torch.no_grad():
            got = m.step(_t(xt), gk, gv, t, T)
        close(got, want, FWD_TOL)
        close(got, full[:, t:t + 1].numpy(), FWD_TOL)


# ---- grouped decoders -----------------------------------------------------------

DECODER_KINDS = {"flagship": dict(transformer_type="relative",
                                  cross_attention_type="diagonal"),
                 "absolute": dict(transformer_type="absolute",
                                  cross_attention_type="full")}


def decoder_pair(kind: str, n_head_kv=None, source_dim: int = 0):
    """(JAX decoder, its params, the port's with them, source, target): the
    decoder of DECODER_KINDS[kind] at d_model 32, 4 heads, 2 + 2 layers,
    over merged codes (source_dim 0) or over z of width source_dim; the
    source (2, 4) codes or (2, 4, source_dim) z and the target (2, 16, 4)
    tokens from a numpy seed."""
    geometry = dict(
        d_model=E, num_encoder_layers=2, num_decoder_layers=2, n_head=H,
        dim_feedforward=48, positional_embedding_size=4,
        num_channels_encoder=1, num_events_encoder=CODES,
        num_channels_decoder=4, num_events_decoder=NUM_EVENTS, dropout=0.0,
        total_upscaling=16, source_vocab_size=0 if source_dim else CODE_VOCAB,
        source_dim=source_dim, n_head_kv=n_head_kv, **DECODER_KINDS[kind])
    rng = np.random.RandomState(3)
    source = (rng.randn(2, CODES, source_dim).astype(np.float32) if source_dim
              else rng.randint(0, CODE_VOCAB, (2, CODES)).astype(np.int32))
    target = np.stack([rng.randint(0, v, (2, NUM_EVENTS)) for v in VOCABS],
                      -1).astype(np.int32)
    jdec = JaxDecoder(data_processor=JaxProcessor(
        embedding_size=12, num_events=NUM_EVENTS,
        num_tokens_per_channel=VOCABS), encoder_attention_type="anticausal",
        **geometry)
    params = jax.tree.map(jnp.asarray, random_params(
        jdec.init, RNGS, jnp.asarray(source), jnp.asarray(target)))
    dec = Decoder(BachDataProcessor(12, NUM_EVENTS, VOCABS), "anticausal",
                  **geometry).eval()
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    return jdec, params, dec, source, target


def check_forward(jdec, params, dec, source, target) -> None:
    """Eval logits (1e-5 of the largest) and the loss (1e-5 relative)."""
    out = jax.jit(jdec.apply)({"params": params}, jnp.asarray(source),
                              jnp.asarray(target))
    with torch.no_grad():
        got = dec.eval()(_t(source), _t(target))
    for g, w in zip(got["weights_per_category"], out["weights_per_category"]):
        close(g, w, FWD_TOL)
    np.testing.assert_allclose(got["loss"].item(), float(out["loss"]),
                               rtol=FWD_TOL)


def check_greedy(jdec, params, dec, source, target, start: int) -> None:
    """Greedy (top_k 1) KV-cached tokens from `start` equal JAX's."""
    steps = NUM_EVENTS * 4 - start
    sample = jax.jit(functools.partial(jdec.apply,
                                       method=JaxDecoder.sample_range),
                     static_argnums=(3, 4, 6, 7, 8))
    want = sample({"params": params}, jnp.asarray(source), jnp.asarray(target),
                  start, steps, KEY, 1.0, 1, 0.0)
    got = dec.sample_range(source, target, start, steps,
                           torch.Generator().manual_seed(0), top_k=1,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_teacher_forced(dec, source) -> None:
    """Greedy KV-cached tokens from position 0 equal the argmax of a full
    forward over them at every position."""
    got = dec.sample_range(source, np.zeros((2, NUM_EVENTS, 4), np.int32), 0,
                           NUM_EVENTS * 4, torch.Generator().manual_seed(0),
                           top_k=1, device="cpu")
    with torch.no_grad():
        logits = dec(_t(source), got)["weights_per_category"]
    forced = torch.stack([lg.argmax(-1) for lg in logits], -1)
    np.testing.assert_array_equal(forced.numpy(), got.numpy())


@pytest.mark.parametrize("kind,kv_heads", [("flagship", 2), ("absolute", 1)])
def test_grouped_decoder_matches_jax(kind, kv_heads):
    """A grouped decoder: logits and loss against JAX; the prefill's caches
    (B, H_kv, T, hd) (and the absolute cross memory's (B, H_kv, S, hd));
    greedy KV-cached tokens equal to the teacher-forced argmax (JAX's
    grouped sampler is held bit for bit through the prior's below and the
    unquantized decoder's in tests/test_torch_unquantized.py)."""
    jdec, params, dec, source, target = decoder_pair(kind, kv_heads)
    check_forward(jdec, params, dec, source, target)
    with torch.no_grad():
        caches, crosses = dec.prefill(_t(source), _t(target))
    for k, v in caches:
        assert k.shape == v.shape == (2, kv_heads, NUM_EVENTS * 4, HD)
    if kind == "absolute":
        assert crosses[0][0].shape == (2, kv_heads, CODES, HD)
    check_teacher_forced(dec, source)


# ---- the grouped prior ----------------------------------------------------------

PRIOR = dict(code_vocab_size=11, d_model=E, num_layers=2, n_head=H,
             dim_feedforward=48, embedding_size=8, num_channels=1,
             num_events=T, dropout=0.0, n_head_kv=2)


@pytest.fixture(scope="module")
def priors():
    jprior = JaxPrior(**PRIOR)
    params = random_params(jprior.init, RNGS, jnp.zeros((3, T), jnp.int32))
    prior = PriorRelative(**PRIOR)
    prior.load_state_dict(convert.prior_state_dict(params), strict=True)
    return jprior, params, prior


@pytest.mark.parametrize("start", [0, 5])
def test_grouped_prior_greedy_codes_match_jax(priors, start):
    """Greedy KV-cached codes of the grouped prior equal JAX's bit for bit,
    from position 0 (zero caches of (B, H_kv, T, hd)) and after a fixed
    prefix (prefilled caches)."""
    jprior, params, prior = priors
    x0 = np.random.RandomState(7).randint(0, 11, (3, T)).astype(np.int32)
    x0[:, start:] = 0
    sample = jax.jit(functools.partial(jprior.apply,
                                       method=JaxPrior.sample_window),
                     static_argnums=(2, 3, 5, 6))
    want = sample({"params": params}, jnp.asarray(x0), start, T - start, KEY,
                  1.0, 1)
    got = prior.sample_window(x0, start, T - start,
                              torch.Generator().manual_seed(0), top_k=1,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for caches in (prior._empty_caches(3, T, None),
                   prior.prefill(torch.from_numpy(x0).long())):
        for k, v in caches:
            assert k.shape == v.shape == (3, 2, T, HD)


def test_prior_trainer_over_a_grouped_prior(priors):
    """PriorTrainer needs no change for a grouped prior: one step's loss and
    every gradient against jax.grad (1e-4), and generate_codes' codes in
    the vocabulary."""
    jprior, params, _ = priors
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
    torch.manual_seed(0)
    encoder = Encoder(BachCPCDataProcessor(8, 3 * 4, VOCABS, 16),
                      GruDownscaler(8, 3, [16], 16, 1, 0.0, True),
                      ProductVectorQuantizer(11, 3, 0.25, 1))
    prior = PriorRelative(**PRIOR)
    prior.load_state_dict(convert.prior_state_dict(params), strict=True)
    trainer = PriorTrainer(encoder, prior, 11, device="cpu").init_state(1e-3)
    x = np.stack([np.random.RandomState(c).randint(0, v, (3, T * 4))
                  for c, v in enumerate(VOCABS)], -1).astype(np.int32)
    codes = trainer.encode_codes(x)
    grads = jax.jit(jax.grad(lambda p, c: jprior.apply(
        {"params": p}, c, training=True, rngs={"dropout": KEY})["loss"]))(
            params, jnp.asarray(codes.numpy()))
    want = convert.prior_state_dict(jax.device_get(grads))
    trainer.optimizer.step = lambda: None          # keep the weights
    loss = trainer.train_step(x)["loss"]
    assert np.isfinite(loss.item())
    for name, p in prior.named_parameters():
        close(p.grad, want[name].numpy(), GRAD_TOL)
    sampled = trainer.generate_codes(T + T // 2, num_generated_codes=2)
    assert sampled.shape == (2, T + T // 2)
    assert (sampled >= 0).all() and (sampled < 11).all()


def test_grouped_decoder_and_prior_through_the_clis(tmp_path, monkeypatch):
    """The CLIs on grouped copies of the test configs (the port's twin of
    tests/test_cli.py::test_main_decoder_gqa_train_and_reharmonize):
    decoder_smoke.py with n_head_kv 1 of 2 heads -t, then -l -r (three
    re-harmonisations through the 1-head caches); prior_smoke.py with
    n_head_kv 1 -t over that decoder, then -l -g (one score); each reloads
    its grouped weights strictly."""
    import glob
    from vqcpcb_tpu_torch import main_decoder, main_prior
    from vqcpcb_tpu_torch.data import dataset as port_dataset
    from vqcpcb_tpu_torch.utils import load_config_module
    root = os.path.dirname(os.path.abspath(__file__))
    encoder = os.path.join(root, "configs", "encoder_smoke.py")
    decoder = load_config_module(os.path.join(root, "configs", "decoder_smoke.py"))
    decoder.update(config_encoder=encoder, savename="decoder_gqa",
                   decoder_kwargs=dict(decoder["decoder_kwargs"], n_head_kv=1))
    (tmp_path / "decoder_gqa.py").write_text(f"config = {decoder!r}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    assert main_decoder.main(["-t", "-c", "decoder_gqa.py", "--device", "cpu"]) == 0
    (decoder_dir,) = glob.glob(str(tmp_path / "models" / "decoder_gqa_*"))
    decoder_config = os.path.join(decoder_dir, "config.py")
    assert main_decoder.main(["-l", "-r", "-c", decoder_config,
                              "--device", "cpu"]) == 0
    assert len(glob.glob(os.path.join(decoder_dir, "reharmonisations", "*.mid"))) == 3
    prior = load_config_module(os.path.join(root, "configs", "prior_smoke.py"))
    prior.update(config_encoder=encoder, config_decoder=decoder_config,
                 savename="prior_gqa",
                 prior_kwargs=dict(prior["prior_kwargs"], n_head_kv=1))
    (tmp_path / "prior_gqa.py").write_text(f"config = {prior!r}\n")
    assert main_prior.main(["-t", "-c", "prior_gqa.py", "--device", "cpu"]) == 0
    (prior_dir,) = glob.glob(str(tmp_path / "models" / "prior_gqa_*"))
    assert main_prior.main(["-l", "-g", "-c", os.path.join(prior_dir, "config.py"),
                            "--device", "cpu"]) == 0
    assert len(glob.glob(os.path.join(prior_dir, "generations", "*.mid"))) == 1
