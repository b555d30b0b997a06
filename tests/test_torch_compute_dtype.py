"""VQCPCB_COMPUTE_DTYPE=bfloat16 in the port against the JAX package under
the same variable, on the CPU, at the small sizes of test_torch_student.py,
test_torch_prior.py and test_torch_models.py: each transformer stack
computes its attention projections and feed-forward linears (and the
decoder its training head) in bf16 and everything else in f32, as JAX's
dtype=compute_dtype() layers do. Held per stack: the port in bf16 within a
stated fraction of the largest JAX bf16 value, and at least CONTRAST times
closer to JAX's bf16 result than the port's f32 result is (so a stack left
in f32 fails). JAX is compiled with XLA's excess precision off, so it
rounds to bf16 where flax's layers say (each Dense's product, then its
bias add), as op-by-op dispatch does; by default XLA's CPU fusions keep
f32 between those points, which moves JAX's own bf16 results by about
1e-2 of their largest. Stacks: the prior (logits; loss and gradients in train
mode), the teacher, the relative auxiliary decoder, the linear transformer
downscaler and its encoder (z in f32, codes), decoder generation (the
prefill's caches and one decode step's logits) and prior generation (the
same). Without the variable the port computes in f32 and its codes equal
JAX's bit for bit. The scoped default of the decoder trainer is held in
test_torch_generation.py and test_torch_ops.py."""
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu.ops import compute_dtype as jax_compute_dtype
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models import auxiliary_decoder
from vqcpcb_tpu_torch.utils import default_compute_dtype, layer_compute_dtype

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import (VOCABS as DECODER_VOCABS, _jax_decoder,  # noqa: E402
                               _tokens as _decoder_tokens, _torch_decoder)
from test_torch_prior import _codes, priors  # noqa: E402,F401
from test_torch_student import (BOTTLENECK, CODE_DIM, D_MODEL, EMB, FACTORS,  # noqa: E402
                                FF, HEADS, VOCABS, _apply, _downscaler_pair,
                                _encoder_pair, _rngs, _spread_codebooks, _sub,
                                _t, _teacher_pair, _tokens, random_params)
from vqcpcb_tpu.models import auxiliary_decoder as jax_aux  # noqa: E402
from vqcpcb_tpu.training import student_trainer as jax_student  # noqa: E402

# the port in bf16 against JAX in bf16, as a fraction of the largest |value|
# of each result: 0 to 6.7e-7 measured on the CPU (f32 sums in other
# orders; the caches are equal); 5e-4 leaves room for a sum that rounds one
# entry to the neighbouring bf16 value, and stays 6x below the smallest gap
# between the port in f32 and JAX in bf16 (3.2e-3)
TOL = 5e-4
# the port in bf16 must sit this many times closer to JAX's bf16 result
# than the port in f32 does
CONTRAST = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def bf16(monkeypatch):
    """Runs `fn` with VQCPCB_COMPUTE_DTYPE=bfloat16, then unset."""
    monkeypatch.delenv("VQCPCB_KV_DTYPE", raising=False)

    def run(fn, dtype="bfloat16"):
        if dtype is None:
            monkeypatch.delenv("VQCPCB_COMPUTE_DTYPE", raising=False)
        else:
            monkeypatch.setenv("VQCPCB_COMPUTE_DTYPE", dtype)
        try:
            return fn()
        finally:
            monkeypatch.delenv("VQCPCB_COMPUTE_DTYPE", raising=False)
    return run


def _strict(fn, *args):
    """fn(*args) compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _eager(module, params, *args, **static):
    """module.apply in bf16 rounding (_strict), with the dropout key."""
    return _strict(functools.partial(module.apply, rngs={"dropout": _rngs()["dropout"]},
                                     **static), {"params": params}, *args)


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float64)


def _hold(what, got, got32, want, tol):
    """got (port, bf16) within tol of max |want| (JAX, bf16), and CONTRAST
    times closer to it than got32 (port, f32)."""
    got, got32, want = _np(got), _np(got32), _np(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    gap = np.abs(got32 - want).max() / scale
    print(f"{what}: bf16 err {err:.3e}, f32 gap {gap:.3e}")
    assert err <= tol, (what, err, tol)
    assert err * CONTRAST <= gap, (what, err, gap)


def test_the_variable_reaches_both_packages(bf16):
    assert bf16(lambda: (layer_compute_dtype(), jax_compute_dtype())) == (
        torch.bfloat16, jnp.bfloat16)
    assert bf16(lambda: layer_compute_dtype(), None) == torch.float32
    with default_compute_dtype(torch.bfloat16):
        assert bf16(lambda: layer_compute_dtype(), "float32") == torch.float32
        assert bf16(lambda: layer_compute_dtype(), None) == torch.bfloat16


# ---- the stacks -------------------------------------------------------------------

def test_prior_logits_loss_and_gradients_in_bf16(priors, bf16):
    """Eval logits to TOL of the largest; in train mode (dropout 0) the loss
    to 1e-4 relative (2.3e-5 measured: the training route's plain version
    keeps the softmax weights in f32 before w.v on the CPU, where JAX's XLA
    route rounds them to bf16) and each gradient's cosine to JAX's >= 0.999
    (0.99985 measured at the lowest, e1's; e2's, under the causal mask, 0 on
    both sides)."""
    jprior, params, prior = priors
    x = _codes(1)
    logits = functools.partial(jprior.apply, method=JaxPrior.logits)
    want = bf16(lambda: _strict(logits, {"params": params}, jnp.asarray(x)))
    assert want.dtype == jnp.float32               # the head stays f32
    with torch.no_grad():
        got = bf16(lambda: prior.eval().logits(_t(x)))
        got32 = prior.logits(_t(x))
    assert got.dtype == torch.float32
    _hold("prior logits", got, got32, want, TOL)

    def jax_loss(p):
        return jprior.apply({"params": p}, jnp.asarray(x), training=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})["loss"]
    want_loss, want_grads = bf16(lambda: _strict(jax.value_and_grad(jax_loss), params))
    prior.train().zero_grad()
    loss = bf16(lambda: prior(_t(x))["loss"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got_grads = dict(prior.named_parameters())
    for name, w in convert.prior_state_dict(want_grads).items():
        g, w = _np(got_grads[name].grad).ravel(), _np(w).ravel()
        if not w.any():                  # e2 under the causal mask
            assert not g.any(), name
            continue
        cos = g @ w / max(np.linalg.norm(g) * np.linalg.norm(w), 1e-30)
        assert cos >= 0.999, (name, cos)


def test_teacher_logits_in_bf16(bf16):
    """Each channel's logits to TOL of the largest."""
    jdp, jteacher, teacher = _teacher_pair()
    x, _ = jax_student.mask_batch(jnp.asarray(_tokens(3)), jnp.int32(5), 2, VOCABS)
    dp_params = random_params(jdp.init, _rngs(), x, seed=1)
    embedded = jdp.apply({"params": dp_params}, x)
    params = random_params(jteacher.init, _rngs(), embedded)
    teacher.load_state_dict(convert.teacher_state_dict(params, dp_params), strict=True)
    want = bf16(lambda: _eager(jteacher, params, embedded, training=False))
    teacher.eval()
    with torch.no_grad():
        got = bf16(lambda: teacher(teacher.data_processor(_t(x))))
        got32 = teacher(teacher.data_processor(_t(x)))
    for c in range(len(VOCABS)):
        _hold(f"teacher channel {c}", got[c], got32[c], want[c], TOL)


def test_relative_auxiliary_decoder_in_bf16(bf16):
    """Each channel's logits to TOL of the largest."""
    kwargs = dict(num_tokens_per_channel=VOCABS, codebook_dim=CODE_DIM,
                  upscale_factors=FACTORS, list_of_num_layers=[1, 1], n_head=HEADS,
                  d_model=D_MODEL, dim_feedforward=FF,
                  num_tokens_bottleneck=BOTTLENECK, dropout=0.0)
    jmod = jax_aux.AuxiliaryDecoderRelative(**kwargs)
    mod = auxiliary_decoder.AuxiliaryDecoderRelative(**kwargs).eval()
    z = np.random.RandomState(4).randn(2, BOTTLENECK, CODE_DIM).astype(np.float32)
    params = random_params(jmod.init, _rngs(), jnp.asarray(z))
    mod.load_state_dict(convert.auxiliary_decoder_state_dict(params), strict=True)
    want = bf16(lambda: _eager(jmod, params, jnp.asarray(z), training=False))
    with torch.no_grad():
        got = bf16(lambda: mod(_t(z)))
        got32 = mod(_t(z))
    for c in range(len(VOCABS)):
        _hold(f"auxiliary decoder channel {c}", got[c], got32[c], want[c], TOL)


def test_transformer_downscaler_and_encoder_in_bf16(bf16):
    """The linear downscaler's output to TOL of the largest; through the
    encoder, z reaches the quantizer in f32 and the codes equal JAX's bf16
    codes wherever the two nearest codes are not within the bf16 error of
    each other; without the variable, the codes equal JAX's f32 codes bit
    for bit."""
    jds, ds = _downscaler_pair("linear")
    x = np.random.RandomState(2).randn(3, 32, EMB).astype(np.float32)
    params = random_params(jds.init, _rngs(), jnp.asarray(x))
    sd = _sub(convert.encoder_state_dict({"data_processor": {}, "downscaler": params}),
              "downscaler.")
    ds.load_state_dict(sd, strict=True)
    want = bf16(lambda: _eager(jds, params, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = bf16(lambda: ds(_t(x), training=False))
        got32 = ds(_t(x), training=False)
    assert got.dtype == torch.float32
    _hold("linear downscaler", got, got32, want, TOL)

    jenc, enc = _encoder_pair("linear")
    x = _tokens(5, batch=4)
    params = _spread_codebooks(jenc, random_params(jenc.init, _rngs(), jnp.asarray(x)), x)
    enc.load_state_dict(convert.encoder_state_dict(params), strict=True)
    enc.eval()
    with torch.no_grad():
        z = bf16(lambda: enc.downscale(_t(x)))
        zq, idx, _ = bf16(lambda: enc(_t(x)))
        _, idx32, _ = enc(_t(x))
    assert z.dtype == zq.dtype == torch.float32
    _, want_idx, _ = bf16(lambda: _eager(jenc, params, jnp.asarray(x), training=False))
    _, want32, _ = _apply(jenc, params, jnp.asarray(x), training=False)
    np.testing.assert_array_equal(idx32.numpy(), np.asarray(want32))
    codebook = enc.quantizer.codebooks[0].detach().numpy().astype(np.float64)
    dist = ((z.numpy().reshape(-1, 1, CODE_DIM) - codebook[None]) ** 2).sum(-1)
    two = np.sort(dist, axis=-1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > TOL * two.max()
    same = idx.numpy().ravel() == np.asarray(want_idx).ravel()
    assert same[clear].all() and clear.mean() > 0.5


# ---- generation -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_pair():
    """test_torch_models' AC/D/C decoder pair, its params seeded fills."""
    rng = np.random.RandomState(3)
    source = rng.randint(0, 8, size=(2, 6)).astype(np.int32)
    target = _decoder_tokens(rng, 2, 24)
    jdec = _jax_decoder()
    params = random_params(jdec.init, _rngs(), jnp.asarray(source),
                           jnp.asarray(target), seed=5)
    dec = _torch_decoder()
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    return jdec, params, dec, source, target


def test_decoder_generation_in_bf16(decoder_pair, bf16):
    """The prefill's bf16 caches and the logits of one decode step at
    position 37, each to TOL of its largest, as JAX's prefill,
    _decode_one and _head_logits_at give them."""
    jdec, params, dec, source, target = decoder_pair
    t = 37

    def jax_step(m, src, tgt):
        caches, crosses = m.prefill(src, tgt)
        x_t = m._embed_input_at(tgt.reshape(tgt.shape[0], -1)[:, t - 1], t)
        out, _ = m._decode_one(x_t[:, None], caches, crosses, t)
        return caches, m._head_logits_at(out[:, 0], t)

    def port_step():
        caches, crosses = dec.prefill(_t(source), _t(target), None)
        flat = _t(target).reshape(target.shape[0], -1)
        x_t = dec._embed_input_at(flat[:, t - 1], t)
        out = dec._decode_one(x_t[:, None], caches, crosses, t)
        return caches, dec._head_logits_at(out[:, 0], t)

    want_caches, want = bf16(lambda: _strict(
        functools.partial(jdec.apply, method=jax_step), {"params": params},
        jnp.asarray(source), jnp.asarray(target)))
    dec.eval()
    with torch.no_grad():
        got_caches, got = bf16(port_step)
        caches32, got32 = port_step()
    assert caches32[0][0].dtype == torch.float32
    for layer, ((k, v), (k32, v32), (wk, wv)) in enumerate(
            zip(got_caches, caches32, want_caches)):
        assert k.dtype == torch.bfloat16 and wk.dtype == jnp.bfloat16
        _hold(f"decoder cache k, layer {layer}", k, k32, wk, TOL)
        _hold(f"decoder cache v, layer {layer}", v, v32, wv, TOL)
    _hold("decoder step logits", got, got32, want, TOL)
    assert got.shape == (2, max(DECODER_VOCABS))


def test_prior_generation_in_bf16(priors, bf16):
    """The prefill's bf16 caches and the logits of one decode step at
    position 5, each to TOL of its largest."""
    jprior, params, prior = priors
    x = _codes(2)
    t = 5

    def jax_step(m, codes):
        caches = m.prefill(codes)
        out = m._embed_input_at(codes[:, t - 1])[:, None]
        for layer, (k_cache, v_cache) in zip(m.transformer.layers, caches):
            k_t, v_t = layer.self_attn.project_kv(out)
            k_cache = k_cache.at[:, :, t:t + 1].set(k_t.astype(k_cache.dtype))
            v_cache = v_cache.at[:, :, t:t + 1].set(v_t.astype(v_cache.dtype))
            out = layer.step(out, k_cache, v_cache, t, codes.shape[1])
        return caches, m.pre_softmax(out[:, 0])

    def port_step():
        from vqcpcb_tpu_torch.ops.kv_cache import cache_update
        caches = prior.prefill(_t(x), None)
        out = prior._embed_input_at(_t(x)[:, t - 1])[:, None]
        for layer, (k_cache, v_cache) in zip(prior.transformer.layers, caches):
            k_t, v_t = layer.self_attn.project_kv(out)
            cache_update(k_cache, k_t, t)
            cache_update(v_cache, v_t, t)
            out = layer.step(out, k_cache, v_cache, t, x.shape[1])
        return caches, prior.pre_softmax(out[:, 0])

    want_caches, want = bf16(lambda: _strict(
        functools.partial(jprior.apply, method=jax_step), {"params": params},
        jnp.asarray(x)))
    prior.eval()
    with torch.no_grad():
        got_caches, got = bf16(port_step)
        caches32, got32 = port_step()
    for layer, ((k, v), (k32, v32), (wk, wv)) in enumerate(
            zip(got_caches, caches32, want_caches)):
        assert k.dtype == torch.bfloat16 and wk.dtype == jnp.bfloat16
        _hold(f"prior cache k, layer {layer}", k, k32, wk, TOL)
        _hold(f"prior cache v, layer {layer}", v, v32, wv, TOL)
    _hold("prior step logits", got, got32, want, TOL)
