"""The port's VQ-CPC encoder-training slice against the JAX package on the
CPU, at a small size (GRU hidden 16, batch 3, 2 + 2 blocks of 16 tokens, 3
negatives, dropout 0, no label corruption unless a test says so): the CPC
losses, the three quantizers in training and eval, the codebook init, the
whole VQCPCModel's loss, metrics and gradients, and one trainer step. Weights
come from the JAX init through vqcpcb_tpu_torch.convert; inputs are made with
numpy from a seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.models.cpc import CModule as JaxCModule
from vqcpcb_tpu.models.cpc import FksModule as JaxFksModule
from vqcpcb_tpu.models.cpc import VQCPCModel as JaxVQCPCModel
from vqcpcb_tpu.models.data_processor import BachCPCDataProcessor as JaxCPCProcessor
from vqcpcb_tpu.models.downscalers import GruDownscaler as JaxGruDownscaler
from vqcpcb_tpu.models.downscalers import (
    RelativeTransformerDownscaler as JaxTransformerDownscaler)
from vqcpcb_tpu.models.encoder import Encoder as JaxEncoder
from vqcpcb_tpu.models.upscalers import MlpUpscaler as JaxMlpUpscaler
from vqcpcb_tpu.ops import losses as jax_losses
from vqcpcb_tpu.ops import quantizer as jax_quantizer
from vqcpcb_tpu.parallel import mesh as mesh_lib
from vqcpcb_tpu.training.encoder_trainer import VQCPCEncoderTrainer as JaxTrainer
from vqcpcb_tpu.training.train_state import TrainState
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.downscalers import (
    RelativeTransformerDownscaler as TransformerDownscaler)
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.ops import losses, quantizer
from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer

VOCABS = [7, 9, 6, 8]
EMB = 8
HIDDEN = 16
BLOCK = 16               # tokens per block: 4 ticks x 4 voices
BLOCKS = 2               # left and right
NUM_NEG = 3
BATCH = 3
CODES = 8
Z = 8                    # upscaler output, the CPC feature size
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(rng, shape):
    return np.stack([rng.randint(0, v, size=shape) for v in VOCABS],
                    axis=-1).astype(np.int32)


def _batch(seed):
    rng = np.random.RandomState(seed)
    ticks = BLOCKS * BLOCK // 4
    neg_shape = (BATCH, NUM_NEG, BLOCKS, BLOCK // 4)
    return {"x_left": _tokens(rng, (BATCH, ticks)),
            "x_right": _tokens(rng, (BATCH, ticks)),
            "negative_samples": _tokens(rng, neg_shape),
            "negative_samples_back": _tokens(rng, neg_shape)}


def _jax_quantizer(kind, dim=3, num_codebooks=1):
    if kind == "ema":
        return jax_quantizer.EMAProductVectorQuantizer(
            codebook_size=CODES, codebook_dim=dim, commitment_cost=0.25,
            num_codebooks=num_codebooks, ema_decay=0.99)
    if kind == "none":
        return jax_quantizer.NoQuantization(codebook_dim=dim)
    return jax_quantizer.ProductVectorQuantizer(
        codebook_size=CODES, codebook_dim=dim, commitment_cost=0.25,
        num_codebooks=num_codebooks, use_batch_norm=kind == "bn")


def _port_quantizer(kind, dim=3, num_codebooks=1):
    if kind == "ema":
        return quantizer.EMAProductVectorQuantizer(CODES, dim, 0.25, num_codebooks,
                                                   ema_decay=0.99)
    if kind == "none":
        return quantizer.NoQuantization(dim)
    return quantizer.ProductVectorQuantizer(CODES, dim, 0.25, num_codebooks,
                                            use_batch_norm=kind == "bn")


def _downscalers(layers, transformer):
    """The JAX and the port downscaler: the bidirectional GRU of `layers`
    layers, or (transformer) the strided relative-transformer downscaler,
    factors [4, 4] over the block, d_model 16, 2 heads, `layers` layers a
    stage."""
    if transformer:
        kwargs = dict(downscale_factors=[4, 4], num_channels=4, d_model=16,
                      n_head=2, list_of_num_layers=[layers, layers],
                      dim_feedforward=24, dropout=0.0, positional_embedding_size=4)
        return (JaxTransformerDownscaler(output_dim=3, **kwargs),
                TransformerDownscaler(EMB, 3, **kwargs))
    return (JaxGruDownscaler(output_dim=3, downscale_factors=[BLOCK],
                             hidden_size=HIDDEN, num_layers=layers, dropout=0.0,
                             bidirectional=True),
            GruDownscaler(EMB, 3, [BLOCK], HIDDEN, layers, 0.0, bidirectional=True))


def _models(kind, bidirectional, layers=2, transformer=False):
    """The JAX and the port VQCPCModel of one configuration (random init),
    GRUs of `layers` layers, the downscaler of _downscalers."""
    jax_downscaler, downscaler = _downscalers(layers, transformer)

    def jax_c():
        return JaxCModule(hidden_size=HIDDEN, output_dim=Z, num_layers=layers,
                          dropout=0.0)

    jmodel = JaxVQCPCModel(
        encoder=JaxEncoder(
            data_processor=JaxCPCProcessor(
                embedding_size=EMB, num_events=2 * BLOCKS * BLOCK // 4,
                num_tokens_per_channel=VOCABS, num_tokens_per_block=BLOCK),
            downscaler=jax_downscaler,
            quantizer=_jax_quantizer(kind),
            upscaler=JaxMlpUpscaler(output_dim=Z, hidden_size=HIDDEN, dropout=0.0)),
        c_module=jax_c(),
        fks_module=JaxFksModule(z_dim=Z, c_dim=Z, k_max=BLOCKS),
        c_module_back=jax_c() if bidirectional else None,
        fks_module_back=(JaxFksModule(z_dim=Z, c_dim=Z, k_max=BLOCKS)
                         if bidirectional else None),
        quantization_weighting=0.5)
    model = VQCPCModel(
        Encoder(BachCPCDataProcessor(EMB, 2 * BLOCKS * BLOCK // 4, VOCABS,
                                     num_tokens_per_block=BLOCK),
                downscaler,
                _port_quantizer(kind), MlpUpscaler(3, Z, HIDDEN, 0.0)),
        CModule(Z, HIDDEN, Z, layers, 0.0), FksModule(Z, Z, BLOCKS),
        CModule(Z, HIDDEN, Z, layers, 0.0) if bidirectional else None,
        FksModule(Z, Z, BLOCKS) if bidirectional else None,
        quantization_weighting=0.5)
    return jmodel, model


def _jax_perms(seed, n, num_codebooks=1):
    """The permutations JAX's init_state draws for the codebook init
    (encoder_trainer.py:75, quantizer.py:50-52)."""
    rng = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    perms = []
    for _ in range(num_codebooks):
        rng, sub = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    return perms


def _jax_trainer(jmodel, batch, seed=0):
    # the same init, compiled once rather than traced op by op (a tenth of
    # the time on the CPU)
    object.__setattr__(jmodel, "init", jax.jit(jmodel.init,
                                               static_argnames="training"))
    trainer = JaxTrainer(model_dir="unused", dataloader_generator=None,
                         model=jmodel, seed=seed,
                         mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    trainer.init_state(batch, lr=LR)
    return trainer


def _close_to_max(got, want, tol, what):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _rel_close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               err_msg=what)


# ---- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("back", [False, True])
def test_cpc_losses_match_jax(back):
    """nce_loss and quantization_loss_aggregate: 1e-6 relative."""
    rng = np.random.RandomState(1)
    pos = rng.randn(4, 3).astype(np.float32) * 3
    neg = rng.randn(4, 3, 5).astype(np.float32) * 3
    left, right = (rng.rand(4, 2).astype(np.float32) for _ in range(2))
    negs = [rng.rand(4, 5, 3, 1).astype(np.float32) for _ in range(2)]
    _rel_close(losses.nce_loss(_t(pos), _t(neg)).item(),
               jax_losses.nce_loss(jnp.asarray(pos), jnp.asarray(neg)), 1e-6, "nce")
    back_arg = negs[1] if back else None
    got = losses.quantization_loss_aggregate(
        _t(left), _t(negs[0]), _t(right), None if back_arg is None else _t(back_arg))
    want = jax_losses.quantization_loss_aggregate(
        jnp.asarray(left), jnp.asarray(negs[0]), jnp.asarray(right),
        None if back_arg is None else jnp.asarray(back_arg))
    _rel_close(got.item(), want, 1e-6, "quantization loss")


# ---- GRU dropout ------------------------------------------------------------------------

def test_gru_dropout_between_layers_draws_from_the_generator():
    """A training GRU with dropout runs its layers one call each with a
    mask from the generator between them: the same seed gives the same
    output, another seed another; with every element kept the layers give
    torch's fused multi-layer GRU (1e-6); eval, and a one-layer GRU, apply
    none."""
    from vqcpcb_tpu_torch.ops.gru import GRU as PortGRU
    torch.manual_seed(0)
    gru = PortGRU(5, 7, 3, dropout=0.5)
    x = torch.randn(4, 6, 5)
    fused = gru(x, training=False)

    def run(seed):
        return gru(x, training=True, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.allclose(run(1), run(2))
    gru.layer_dropout = 1e-30                         # keeps every element
    torch.testing.assert_close(run(1), fused, rtol=0, atol=1e-6)
    one_layer = PortGRU(5, 7, 1, dropout=0.5)
    assert torch.equal(one_layer(x, training=True), one_layer(x, training=False))


# ---- quantizers ---------------------------------------------------------------------

def _quantizer_case(kind, num_codebooks):
    """JAX and port quantizers with the same codebooks (rows of the inputs,
    so the codes spread), inputs (2, 40, dim)."""
    dim = 3 * num_codebooks
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 40, dim) * 2 + 0.5).astype(np.float32)
    jq = _jax_quantizer(kind, dim, num_codebooks)
    variables = jax.tree.map(np.asarray, jq.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    variables = jax.tree.map(lambda a: a, dict(variables))
    rows = x.reshape(-1, dim)[rng.permutation(80)[:CODES]]
    codebooks = rows.reshape(CODES, num_codebooks, 3).transpose(1, 0, 2).copy()
    if kind == "ema":
        ema = dict(variables["ema"])
        ema["codebooks"], ema["ema_sums"] = codebooks, codebooks.copy()
        variables["ema"] = ema
    elif kind != "none":
        params = dict(variables["params"])
        params["codebooks"] = codebooks
        variables["params"] = params
    q = _port_quantizer(kind, dim, num_codebooks)
    params = variables.get("params", {})
    sd = {f"embeddings.{k}": _t(t) for k, t in enumerate(params.get("codebooks", []))}
    if kind == "ema":
        sd.update({k: _t(variables["ema"][k]) for k in
                   ("codebooks", "cluster_size", "ema_sums")})
    if kind == "bn":
        bn = variables["batch_stats"]["batch_norm"]
        sd.update({"batch_norm.weight": _t(params["batch_norm"]["scale"]),
                   "batch_norm.bias": _t(params["batch_norm"]["bias"]),
                   "batch_norm.running_mean": _t(bn["mean"]),
                   "batch_norm.running_var": _t(bn["var"])})
    q.load_state_dict(sd, strict=True)
    return jq, variables, q, x


@pytest.mark.parametrize("kind,num_codebooks,training", [
    ("commitment", 2, False), ("commitment", 2, True),
    ("bn", 1, False), ("bn", 1, True), ("ema", 1, False), ("ema", 2, True),
    ("none", 1, True)])
def test_quantizer_matches_jax(kind, num_codebooks, training):
    """Indices equal, loss and the straight-through output to 1e-6
    relative; after one training forward the BatchNorm running statistics
    to 1e-6 and the EMA buffers to 1e-5 relative."""
    jq, variables, q, x = _quantizer_case(kind, num_codebooks)
    mutable = training and [k for k in variables if k != "params"] or False
    out = jq.apply(variables, jnp.asarray(x), training=training, mutable=mutable)
    (jz, jidx, jloss), new_vars = out if mutable else (out, {})
    z, idx, loss = q(_t(x), training=training)
    if kind == "none":
        assert idx is None and jidx is None
        assert not loss.any() and z is not None
    else:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert len(np.unique(idx.numpy())) > 1
    _rel_close(loss.detach().numpy(), jloss, 1e-6, "loss")
    _rel_close(z.detach().numpy(), jz, 1e-6, "quantized")
    if kind == "bn" and training:
        bn = new_vars["batch_stats"]["batch_norm"]
        np.testing.assert_allclose(q.batch_norm.running_mean.numpy(), bn["mean"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(q.batch_norm.running_var.numpy(), bn["var"],
                                   rtol=0, atol=1e-6)
    if kind == "ema":
        want = new_vars["ema"] if training else variables["ema"]
        for name in ("codebooks", "cluster_size", "ema_sums"):
            _rel_close(getattr(q, name).numpy(), want[name], 1e-5, name)
        if training:
            assert not np.allclose(q.codebooks.numpy(), variables["ema"]["codebooks"])


def test_ema_quantizer_rejects_label_corruption():
    q = quantizer.EMAProductVectorQuantizer(CODES, 3, 0.25, 1)
    with pytest.raises(NotImplementedError):
        q(torch.randn(4, 3), training=True, corrupt_labels=True)


def test_label_corruption_rate():
    """5% of the indices replaced by uniform draws in training: over 10^5
    indices the rate, estimated from the changed indices over the share a
    uniform draw changes (1 - 1/S), lies within 0.05 +- 0.005; eval and
    corrupt_labels=False leave every index alone."""
    q = quantizer.ProductVectorQuantizer(64, 1, 0.25, 1)
    x = torch.randn(100_000, 1, generator=torch.Generator().manual_seed(0)) * 4
    clean = q(x, training=True)[1]
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(q(x, training=False, corrupt_labels=True, generator=gen)[1], clean)
    corrupted = q(x, training=True, corrupt_labels=True, generator=gen)[1]
    rate = (corrupted != clean).float().mean().item() / (1 - 1 / 64)
    assert abs(rate - 0.05) <= 0.005, rate


@pytest.mark.parametrize("num_codebooks", [1, 2])
def test_initialize_codebooks_matches_jax(num_codebooks):
    """With JAX's permutations passed in, the codebooks equal JAX's."""
    rng = np.random.RandomState(3)
    flat = rng.randn(50, 3 * num_codebooks).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jax_quantizer.initialize_codebooks(key, jnp.asarray(flat), num_codebooks,
                                              CODES)
    perms = []
    for _ in range(num_codebooks):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, 50)))
    got = quantizer.initialize_codebooks(_t(flat), num_codebooks, CODES, perms=perms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = quantizer.initialize_codebooks(
        _t(flat), num_codebooks, CODES, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape


# ---- the model ---------------------------------------------------------------------

FLOAT_METRICS = ("loss", "loss_quantize", "loss_contrastive", "codebook_perplexity")
COUNT_METRICS = ("num_codewords", "num_codewords_negative")
SCORERS = ("fks_module", "fks_module_back")


@pytest.fixture(scope="module", params=[("commitment", False), ("bn", True)],
                ids=["commitment-unidirectional", "bn-bidirectional"])
def model_pair(request):
    """JAX and port models with JAX's init, its codebooks (or EMA buffers)
    taken from the downscaler's latents of the negatives as the trainer's
    init_state takes them, moved into the port."""
    kind, bidirectional = request.param
    jmodel, model = _models(kind, bidirectional)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    variables = jax.tree.map(np.asarray, variables)
    neg = batch["negative_samples"]
    z = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, x: m.encoder.downscale(x)))(
            variables, neg.reshape((-1,) + neg.shape[3:]))
    codebooks = np.asarray(jax_quantizer.initialize_codebooks(
        jax.random.PRNGKey(1), z.reshape(-1, 3), 1, CODES))
    params = variables["params"]
    if kind == "ema":
        quant = variables["ema"]["encoder"]["quantizer"]
        quant["codebooks"], quant["ema_sums"] = codebooks, codebooks.copy()
    else:
        params["encoder"]["quantizer"]["codebooks"] = codebooks
    collections = {k: v for k, v in variables.items() if k != "params"}
    model.load_state_dict(convert.vqcpc_state_dict(params, collections), strict=True)
    return jmodel, TrainState(params=params, opt_state=None,
                              batch_stats=collections, step=0), model


def _jax_forward(jmodel, state, batch, training):
    """JAX's loss and metrics, the new collections and the scorers' outputs
    (positive (B, k) and negatives (B, k, N) per direction); with the
    gradient of the loss when training."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    collections = state.batch_stats

    def fwd(params):
        (loss, metrics), new_vars = jmodel.apply(
            {"params": params, **collections}, jbatch, training=training,
            mutable=[*collections, "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxFksModule))
        return loss, (metrics, new_vars)

    if training:
        (_, (metrics, new_vars)), grads = jax.jit(
            jax.value_and_grad(fwd, has_aux=True))(state.params)
    else:
        (_, (metrics, new_vars)), grads = jax.jit(fwd)(state.params), None
    inter = new_vars.pop("intermediates")
    scores = {}
    for name in SCORERS:
        if name in inter:
            pos, neg = (np.asarray(a) for a in inter[name]["__call__"])
            b, k = pos.shape
            scores[name] = (pos, neg.reshape(b, -1, k).transpose(0, 2, 1))
    return metrics, new_vars, scores, grads


def _port_forward(model, batch, training):
    """The port's loss and metrics and its scorers' outputs, as _jax_forward."""
    calls = {name: [] for name in SCORERS}
    hooks = [getattr(model, name).register_forward_hook(
        lambda m, i, out, name=name: calls[name].append(out.detach().numpy()))
        for name in SCORERS if getattr(model, name) is not None]
    try:
        loss, metrics = model({k: _t(v) for k, v in batch.items()},
                              training=training,
                              generator=torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    scores = {}
    for name, (pos, neg) in ((n, c) for n, c in calls.items() if c):
        b, k = pos.shape
        scores[name] = (pos, neg.reshape(b, -1, k).transpose(0, 2, 1))
    return loss, metrics, scores


def _hold_metrics(got, want, got_scores, want_scores):
    """Float metrics to 1e-5 relative, codeword counts equal, the scores to
    1e-5 of their max |value|, and per-k accuracy equal, with one
    exception: a positive that ties its best negative within 1e-5 of the
    scores' scale (a negative whose first block took the positive's code
    scores the same up to rounding, in JAX as here) may count either way,
    so each such tie may move its k's accuracy by 1 / B (1 / 2B when
    bidirectional)."""
    for name in FLOAT_METRICS:
        _rel_close(got[name].item(), want[name], 1e-5, name)
    for name in COUNT_METRICS:
        assert got[name].item() == int(want[name]), name
    assert set(got_scores) == set(want_scores)
    ties = 0.0
    for name, (wpos, wneg) in want_scores.items():
        gpos, gneg = got_scores[name]
        scale = max(np.abs(wpos).max(), np.abs(wneg).max())
        _close_to_max(gpos, wpos, 1e-5, f"{name} positive")
        _close_to_max(gneg, wneg, 1e-5, f"{name} negatives")
        margin = wpos - wneg.max(2)
        tie = np.abs(margin) <= 1e-5 * scale
        np.testing.assert_array_equal((gpos > gneg.max(2))[~tie], (margin > 0)[~tie],
                                      err_msg=name)
        ties = ties + tie.sum(0) / (tie.shape[0] * len(want_scores))
    diff = np.abs(got["accuracy"].numpy() - np.asarray(want["accuracy"]))
    assert (diff <= ties + 1e-6).all(), (diff, ties)


def test_vqcpc_model_matches_jax(model_pair):
    """The training forward of the whole model at dropout 0: the metrics as
    _hold_metrics has them, every parameter's gradient within 1e-4 of its
    max |value|, and the updated BatchNorm / EMA buffers to 1e-5 of their
    max |value|."""
    jmodel, state, model = model_pair
    batch = _batch(0)
    want, new_vars, want_scores, jgrads = _jax_forward(jmodel, state, batch, True)
    loss, got, got_scores = _port_forward(model, batch, True)
    loss.backward()
    _hold_metrics(got, want, got_scores, want_scores)
    want_grads = convert.vqcpc_state_dict(jax.device_get(jgrads))
    params = dict(model.named_parameters())
    assert set(params) == set(want_grads)
    for name, p in params.items():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-3), (name, err)
    want_buffers = convert.vqcpc_state_dict(state.params, jax.device_get(new_vars))
    for name, buf in model.named_buffers():
        _close_to_max(buf.numpy(), want_buffers[name].numpy(), 1e-5, name)


def test_vqcpc_eval_matches_jax(model_pair):
    """JAX's eval forward and the port's on another batch: the metrics as
    _hold_metrics has them, and no buffer moved."""
    jmodel, state, model = model_pair
    model.load_state_dict(convert.vqcpc_state_dict(state.params, state.batch_stats))
    batch = _batch(1)
    want, _, want_scores, _ = _jax_forward(jmodel, state, batch, False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _, got, got_scores = _port_forward(model, batch, False)
    _hold_metrics(got, want, got_scores, want_scores)
    for name, v in model.state_dict().items():
        assert torch.equal(v, before[name]), name


def test_no_quantization_model_has_no_code_metrics():
    """With the pass-through quantizer the loss is the contrastive loss
    alone (1e-5 relative) and no codebook metric exists, as in JAX."""
    jmodel, model = _models("none", False)
    batch = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    jvars = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    model.load_state_dict(convert.vqcpc_state_dict(jvars["params"]), strict=True)
    want = jax.jit(jmodel.apply)(jvars, batch)[1]
    with torch.no_grad():
        got = model({k: _t(v) for k, v in batch.items()}, training=False)[1]
    assert set(got) == set(want) == {"loss", "loss_quantize", "loss_contrastive",
                                     "accuracy"}
    assert got["loss_quantize"].item() == 0.0
    _rel_close(got["loss"].item(), want["loss"], 1e-5, "loss")


# ---- the trainer ---------------------------------------------------------------------

def test_encoder_trainer_step_matches_jax():
    """init_state with JAX's permutation gives JAX's codebooks (1e-5 of
    their max |value|: the downscaler's latents in two summation orders), then
    one train_step: each parameter's update p_new - p_old agrees with JAX's
    to 1e-3 lr where the JAX gradient exceeds 1e-3 of its tensor's max and
    to 2 lr elsewhere (Adam's first step is g / |g| there, so a gradient
    near 0 may flip its sign); the EMA buffers to 1e-5 of their max
    |value|. The EMA quantizer, whose buffers move in the step (the
    commitment quantizer's codebook gradient is held in
    test_vqcpc_model_matches_jax, the clipped Adam against optax in
    test_torch_training.py); one-layer GRUs, the two-layer stacks being
    held in the model tests."""
    _trainer_step_matches_jax(*_models("ema", False, layers=1))


def test_encoder_trainer_step_with_transformer_downscaler_matches_jax():
    """test_encoder_trainer_step_matches_jax's step and checks with the
    strided relative-transformer downscaler (one layer a stage; the
    configs/encoder_*_transfo_config.py geometry of factors [4, 4] over
    blocks of 16 tokens, narrowed): its attention layers take the training
    route of the port in the step."""
    _trainer_step_matches_jax(*_models("ema", False, layers=1, transformer=True))


def _trainer_step_matches_jax(jmodel, model):
    batch = _batch(3)
    jtrainer = _jax_trainer(jmodel, batch, seed=4)
    state = jax.tree.map(np.asarray, jax.device_get(jtrainer.state))
    before = convert.vqcpc_state_dict(state.params, state.batch_stats)
    model.load_state_dict(before, strict=True)
    trainer = VQCPCEncoderTrainer(model, device="cpu", seed=0)
    n = BATCH * NUM_NEG * BLOCKS
    trainer.init_state(batch, lr=LR, perms=_jax_perms(4, n))
    for name, buf in model.state_dict().items():
        if "codebooks" in name or "embeddings" in name or "ema_sums" in name:
            _close_to_max(buf.numpy(), before[name].numpy(), 1e-5, name)

    jbatch = mesh_lib.shard_batch(batch, jtrainer.mesh)
    jgrads = jax.jit(jax.grad(lambda p: jmodel.apply(
        {"params": p, **state.batch_stats}, jbatch, training=True,
        mutable=list(state.batch_stats))[0][0]))(state.params)
    jgrads = convert.vqcpc_state_dict(jax.device_get(jgrads))
    jtrainer._rng, rng = jax.random.split(jtrainer._rng)
    new_state, jmetrics = jtrainer._train_step(jtrainer.state, jbatch, rng)
    after = convert.vqcpc_state_dict(*jax.device_get((new_state.params,
                                                      new_state.batch_stats)))
    old = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = trainer.train_step(batch)
    _rel_close(metrics["loss"].item(), jmetrics["loss"], 1e-5, "loss")
    assert trainer.step == 1
    params = dict(model.named_parameters())
    for name, p in params.items():
        got = (p.detach() - old[name]).numpy()
        want = (after[name] - before[name]).numpy()
        g = np.abs(jgrads[name].numpy())
        strong = g > 1e-3 * g.max()
        err = np.abs(got - want)
        assert err[strong].max(initial=0.0) <= 1e-3 * LR, (name, err[strong].max())
        assert err.max(initial=0.0) <= 2 * LR, (name, err.max())
    for name, buf in model.named_buffers():
        _close_to_max(buf.numpy(), after[name].numpy(), 1e-5, name)


def test_encoder_trainer_epoch_counts_tokens_and_means():
    """epoch(): the mean of each metric over its steps, tokens/s over the
    x_left + x_right + negatives elements, loss_monitor = - mean accuracy;
    encode() returns one code per block."""
    _, model = _models("commitment", True)
    trainer = VQCPCEncoderTrainer(model, device="cpu", seed=0)
    batches = [_batch(s) for s in (5, 6)]
    trainer.init_state(batches[0], lr=LR)
    steps = [trainer.eval_step(b) for b in batches]
    means = trainer.epoch(iter(batches), train=False)
    _rel_close(means["loss"], np.mean([m["loss"].item() for m in steps]), 1e-6, "loss")
    acc = np.mean([m["accuracy"].numpy() for m in steps], axis=0)
    _rel_close(means["accuracy"], acc, 1e-6, "accuracy")
    assert means["loss_monitor"] == pytest.approx(-float(np.mean(acc)))
    assert means["tokens_per_sec"] > 0
    trained = trainer.epoch(iter(batches), train=True, num_batches=1)
    assert trainer.step == 1 and np.isfinite(trained["loss"])
    z, idx, qloss = trainer.encode(batches[0]["x_left"])
    assert z.shape == (BATCH, BLOCKS, Z) and idx.shape == (BATCH, BLOCKS, 1)
    assert qloss.shape == (BATCH, BLOCKS)
