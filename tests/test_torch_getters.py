"""The port's getters against the JAX package's on the CPU: the same config
dict (tests/configs/encoder_smoke.py, tests/configs/decoder_smoke.py with
each of the five decoder types) builds, through each package's getters, the
same model. The JAX params go through
vqcpcb_tpu_torch.convert (strict loads: the same structure); code indices
must be equal, encoder outputs within 1e-5, decoder loss and logits within
1e-4. Weights are seeded random values of the JAX params' shapes
(jax.eval_shape: no compiled init). Also: the decoder and CPC data loaders give the JAX loaders' batches
bit for bit over two reseeded epochs; the student's modules (the teacher
and the auxiliary decoder of tests/configs/encoder_student_smoke.py as the
encoder CLIs derive them) and the relative-transformer downscalers (the
*transfo* configs' downscalers on encoder_smoke.py's geometry) take the
converted JAX params in strict loads and give JAX's outputs (1e-5); and
the prior of configs/prior_config.py takes the JAX prior's parameter
shapes; the decoder over configs/encoder_random_no_quantization_config.py's
encoder (a source Linear from its z width) and the grouped (n_head_kv)
flagship decoder and prior take the JAX modules' parameter shapes at full
width; and what the port does not have yet raises NotImplementedError
naming its ROADMAP item."""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu import getters as jax_getters
from vqcpcb_tpu.training.student_trainer import mask_batch as jax_mask_batch
from vqcpcb_tpu_torch import convert, getters, main_encoder
from vqcpcb_tpu_torch.models.encoder import merge_codes
from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
from vqcpcb_tpu_torch.utils import load_config_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_CONFIG = os.path.join(REPO, "tests", "configs", "encoder_smoke.py")
DECODER_CONFIG = os.path.join(REPO, "tests", "configs", "decoder_smoke.py")
STUDENT_CONFIG = os.path.join(REPO, "tests", "configs", "encoder_student_smoke.py")
KEY = jax.random.PRNGKey(0)
RNGS = {"params": KEY, "dropout": KEY, "corrupt": KEY, "corrupt_mask": KEY}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores (many-fold slower for ops this
    size)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a):
    return torch.from_numpy(np.array(a))


def random_params(init, *args, seed=0, **kwargs):
    """Weights for a flax module without compiling its init: the shapes of
    `init`'s params from jax.eval_shape, filled from a seeded numpy
    generator (N(0, 0.2); LayerNorm scales 1 + N(0, 0.1))."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs), *args)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * noise
        return 0.2 * noise
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _loaders(config, training_method, tmp):
    """(JAX, port) data loader generators of one config, each with its own
    cache."""
    args = (config["dataset"], training_method,
            config["dataloader_generator_kwargs"], config)
    return (jax_getters.get_dataloader_generator(*args, cache_root=str(tmp / "jax")),
            getters.get_dataloader_generator(*args, cache_root=str(tmp / "port")))


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """The VQ-CPC models of encoder_smoke.py from both getters, the same
    seeded weights in both, the codebook taken from the downscaler's latents
    (the data-dependent init) so the codes spread; and a CPC batch."""
    tmp = tmp_path_factory.mktemp("getters")
    config = load_config_module(ENCODER_CONFIG)
    jgen, gen = _loaders(config, "vqcpc", tmp)
    jmodel = jax_getters.get_vqcpc_model(jgen, config)
    model = getters.get_vqcpc_model(gen, config).eval()
    batch = next(gen.dataloaders(batch_size=4)[0])
    params = random_params(jmodel.init, RNGS,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           training=False)
    model.load_state_dict(convert.vqcpc_state_dict(params), strict=True)
    with torch.no_grad():
        z = model.encoder.downscale(_t(batch["x_left"])).reshape(-1, 3).numpy()
    size = config["quantizer_kwargs"]["codebook_size"]
    codebooks = z[np.random.RandomState(0).permutation(len(z))[:size]][None]
    params["encoder"]["quantizer"]["codebooks"] = codebooks
    model.encoder.quantizer.set_codebooks(_t(codebooks))
    return config, jmodel, params, model, batch, tmp


def test_encoder_from_getters_matches_jax(encoders):
    """Code indices equal; the encoder's outputs (upscaled z, commitment
    loss) within 1e-5; the VQ-CPC eval loss within 1e-5 relative."""
    config, jmodel, params, model, batch, _ = encoders
    x = batch["x_left"]
    zq, idx, qloss = jax.jit(lambda p, inp: jmodel.apply(
        {"params": p}, inp, method=lambda m, i: m.encoder(i)))(params, jnp.asarray(x))
    with torch.no_grad():
        got_zq, got_idx, got_qloss = model.encoder(_t(x))
    assert len(np.unique(np.asarray(idx))) > 2
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_zq.numpy(), np.asarray(zq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_qloss.numpy(), np.asarray(qloss),
                               rtol=1e-5, atol=1e-5)
    loss, _ = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, training=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got_loss, _ = model({k: _t(v) for k, v in batch.items()}, training=False)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)


@pytest.fixture(scope="module")
def decoder_setup(encoders):
    """decoder_smoke.py's data from both getters, the encoders of
    encoder_smoke.py (the CPC model's trained-state layout, as the decoder
    CLI loads it), and one batch with its codes from each package."""
    enc_config, jmodel, params, model, _, tmp = encoders
    config = load_config_module(DECODER_CONFIG)
    jgen, gen = _loaders(config, "decoder", tmp)
    jencoder = jax_getters.get_encoder(_loaders(enc_config, "vqcpc", tmp)[0],
                                       enc_config)
    x = next(gen.dataloaders(batch_size=2)[0])["x"]
    np.testing.assert_array_equal(x, next(jgen.dataloaders(batch_size=2)[0])["x"])
    _, jidx, _ = jax.jit(jencoder.apply)({"params": params["encoder"]},
                                         jnp.asarray(x))
    with torch.no_grad():
        idx = model.encoder(_t(x))[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    size = enc_config["quantizer_kwargs"]["codebook_size"]
    codes = merge_codes(idx, size).numpy()
    return config, enc_config, jgen, gen, jencoder, model.encoder, x, codes


@pytest.mark.parametrize("decoder_type", sorted(getters.DECODER_TYPES))
def test_decoder_from_getters_matches_jax(decoder_setup, decoder_type):
    """Each of the five decoder types (transformer_relative_fullCross and
    transformer_relative_full among them): the same derived dimensions, a
    strict load of the converted JAX weights, and the eval loss and
    per-channel logits within 1e-4 on the frozen encoder's codes."""
    assert getters.DECODER_TYPES == jax_getters.DECODER_TYPES
    config, enc_config, jgen, gen, jencoder, encoder, x, codes = decoder_setup
    kwargs = config["decoder_kwargs"]
    jdec = jax_getters.get_decoder(
        jgen, jax_getters.get_data_processor(jgen, "bach", config["data_processor_kwargs"]),
        jencoder, enc_config, decoder_type, kwargs)
    dec = getters.get_decoder(
        gen, getters.get_data_processor(gen, "bach", config["data_processor_kwargs"]),
        encoder, enc_config, decoder_type, kwargs).eval()
    for name in ("num_events_encoder", "total_upscaling", "num_channels_decoder",
                 "transformer_type", "cross_attention_type",
                 "encoder_attention_type"):
        assert getattr(dec, name) == getattr(jdec, name), name
    jparams = random_params(jdec.init, {"params": KEY, "dropout": KEY},
                            jnp.asarray(codes), jnp.asarray(x))
    dec.load_state_dict(convert.decoder_state_dict(jparams), strict=True)
    want = jax.jit(lambda p, s, t: jdec.apply({"params": p}, s, t))(
        jparams, jnp.asarray(codes), jnp.asarray(x))
    with torch.no_grad():
        got = dec(_t(codes), _t(x))
    for g, w in zip(got["weights_per_category"], want["weights_per_category"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)


# ---- data --------------------------------------------------------------------------

def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("training_method,config_path,batch_size", [
    ("decoder", DECODER_CONFIG, 8),
    ("vqcpc", ENCODER_CONFIG, 4)])
def test_batches_equal_jax_over_reseeded_epochs(tmp_path, training_method,
                                                config_path, batch_size):
    """Two epochs, each reseeded first (epochs 3 then 4, as a resumed run
    would draw them): every train batch and the first val batch bit for
    bit; reseeding to an epoch again replays its stream."""
    config = load_config_module(config_path)
    jgen, gen = _loaders(config, training_method, tmp_path)
    firsts = []
    for epoch in (3, 4):
        jgen.reseed(epoch)
        gen.reseed(epoch)
        jtrain, jval, _ = jgen.dataloaders(batch_size=batch_size)
        train, val, _ = gen.dataloaders(batch_size=batch_size, num_workers=0)
        batches = list(train)
        assert len(batches) > 4
        for got in batches:
            _assert_batches_equal(got, next(jtrain))
        assert next(jtrain, None) is None
        _assert_batches_equal(next(val), next(jval))
        gen.reseed(epoch)
        _assert_batches_equal(next(gen.dataloaders(batch_size=batch_size)[0]),
                              batches[0])
        firsts.append(batches[0])
    for key in firsts[0]:
        assert not np.array_equal(firsts[0][key], firsts[1][key])


# ---- the student's modules and the transformer downscalers -----------------------

def _jax_student_modules(jgen, config):
    """The JAX encoder, teacher and auxiliary decoder of a student config,
    with the widths the JAX encoder CLI derives (main_encoder.py:75-103)."""
    jencoder = jax_getters.get_encoder(jgen, config)
    aux = config["auxiliary_networks_kwargs"]
    dp = jencoder.data_processor
    factors = config["downscaler_kwargs"]["downscale_factors"]
    teacher = jax_getters.get_teacher(
        dict(aux["teacher_kwargs"], num_tokens_per_channel=dp.num_tokens_per_channel,
             num_tokens=dp.num_tokens), jgen)
    decoder = jax_getters.get_auxiliary_decoder(aux["auxiliary_decoder_type"], dict(
        aux["auxiliary_decoder_kwargs"], num_tokens_per_channel=dp.num_tokens_per_channel,
        codebook_dim=config["quantizer_kwargs"]["codebook_dim"],
        upscale_factors=list(reversed(factors)),
        num_tokens_bottleneck=dp.num_tokens // int(np.prod(factors))))
    return jencoder, teacher, decoder


def _transfo_config(downscaler_type):
    """encoder_smoke.py with the *transfo* configs' downscaler (factors
    [4, 4] over its blocks of 16 tokens), narrowed as the smoke configs
    are."""
    config = load_config_module(ENCODER_CONFIG)
    config["downscaler_type"] = downscaler_type
    config["downscaler_kwargs"] = dict(downscale_factors=[4, 4], d_model=32,
                                       n_head=2, list_of_num_layers=[1, 1],
                                       dim_feedforward=48, dropout=0.0)
    return config


@pytest.mark.parametrize("what", ["relative_downscaler", "relative_downscaler_linear",
                                  "teacher", "aux_decoder"])
def test_student_modules_from_getters_load_converted_jax_params(tmp_path, what):
    """The getters' modules take the converted params of the JAX getters'
    modules in a strict load (the same structure), and give JAX's outputs
    within 1e-5: the VQ-CPC encoder's codes (equal) and z, the teacher's
    and the auxiliary decoder's logits."""
    if what.startswith("relative_downscaler"):
        config = _transfo_config(what.replace("relative_downscaler",
                                              "relative_transformer_downscaler"))
        jgen, gen = _loaders(config, "vqcpc", tmp_path)
        jmodel = jax_getters.get_vqcpc_model(jgen, config)
        model = getters.get_vqcpc_model(gen, config).eval()
        batch = next(gen.dataloaders(batch_size=4)[0])
        params = random_params(jmodel.init, RNGS,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               training=False)
        model.load_state_dict(convert.vqcpc_state_dict(params), strict=True)
        x = jnp.asarray(batch["x_left"])
        want = jax.jit(lambda p, inp: jmodel.apply(
            {"params": p}, inp, method=lambda m, i: m.encoder(i)))(params, x)
        with torch.no_grad():
            got = model.encoder(_t(x))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        return
    config = load_config_module(STUDENT_CONFIG)
    jgen, gen = _loaders(config, "student", tmp_path)
    _, jteacher, jdecoder = _jax_student_modules(jgen, config)
    trainer = main_encoder.student_trainer(config, gen, getters.get_encoder(gen, config),
                                           "cpu", None)
    x = next(gen.dataloaders(batch_size=2)[0])["x"]
    if what == "teacher":
        masked, _ = jax_mask_batch(jnp.asarray(x), jnp.int32(3), 2,
                                   jteacher.data_processor.num_tokens_per_channel)
        dp_params = random_params(jteacher.data_processor.init, RNGS, masked, seed=1)
        embedded = jteacher.data_processor.apply({"params": dp_params}, masked)
        params = random_params(jteacher.init, RNGS, embedded)
        module = trainer.teacher.eval()
        module.load_state_dict(convert.teacher_state_dict(params, dp_params),
                               strict=True)
        want = jax.jit(jteacher.apply)({"params": params}, embedded)
        with torch.no_grad():
            got = module(module.data_processor(_t(masked)))
    else:
        z = jnp.asarray(np.random.RandomState(0).randn(
            2, jdecoder.num_tokens_bottleneck, 3).astype(np.float32))
        params = random_params(jdecoder.init, RNGS, z)
        module = trainer.auxiliary_decoder.eval()
        module.load_state_dict(convert.auxiliary_decoder_state_dict(params),
                               strict=True)
        want = jax.jit(jdecoder.apply)({"params": params}, z)
        with torch.no_grad():
            got = module(_t(z))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_prior_from_getters_matches_jax_at_full_width(tmp_path):
    """configs/prior_config.py's prior over the encoder of
    configs/encoder_random_synthetic.py, on the synthetic corpus of
    configs/decoder_synthetic.py: 24 events (the prior loader's 24 beats of
    16 tokens over blocks of 16, not the CPC window), a vocabulary of 32
    codes, and the JAX prior's parameter shapes (jax.eval_shape) in a strict
    load."""
    config = load_config_module(os.path.join(REPO, "configs", "prior_config.py"))
    config.update(dataset="synthetic", corpus_kwargs=load_config_module(
        os.path.join(REPO, "configs", "decoder_synthetic.py"))["corpus_kwargs"])
    enc_config = load_config_module(
        os.path.join(REPO, "configs", "encoder_random_synthetic.py"))
    jgen, gen = _loaders(config, "prior", tmp_path)
    jenc_gen, enc_gen = _loaders(enc_config, "vqcpc", tmp_path)
    args = ("transformer_relative", config["prior_kwargs"])
    jprior = jax_getters.get_prior(
        jgen, jax_getters.get_encoder(jenc_gen, enc_config), enc_config, *args)
    prior = getters.get_prior(gen, getters.get_encoder(enc_gen, enc_config),
                              enc_config, *args)
    assert prior.num_tokens == jprior.num_tokens == 24
    assert prior.pre_softmax.out_features == jprior.code_vocab_size == 32
    shapes = jax.eval_shape(jprior.init, RNGS,
                            jnp.zeros((2, 24), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes)
    prior.load_state_dict(convert.prior_state_dict(params), strict=True)
    assert len(prior.transformer.layers) == 6
    assert prior.transformer.layers[0].self_attn.attn_bias.e1.shape == (8 * 24, 64)


# ---- the unquantized decoder and grouped-query attention at full width ------------

def _synthetic(name: str) -> dict:
    """configs/{name} on the synthetic corpus of configs/decoder_synthetic.py
    (the 'bach' corpus waits on M6 (h) part 2)."""
    config = load_config_module(os.path.join(REPO, "configs", name))
    config.update(dataset="synthetic", corpus_kwargs=load_config_module(
        os.path.join(REPO, "configs", "decoder_synthetic.py"))["corpus_kwargs"])
    return config


def _full_width_decoders(tmp, decoder_config: str, encoder_config: str,
                         n_head_kv=None):
    """(the JAX decoder, the port's, the encoder's z width) of a decoder
    config over an encoder config, both from their getters."""
    config = _synthetic(decoder_config)
    enc_config = _synthetic(encoder_config)
    config["decoder_kwargs"] = dict(config["decoder_kwargs"], n_head_kv=n_head_kv)
    jgen, gen = _loaders(config, "decoder", tmp)
    jenc_gen, enc_gen = _loaders(enc_config, "vqcpc", tmp)
    args = (config["decoder_type"], config["decoder_kwargs"])
    jdec = jax_getters.get_decoder(
        jgen, jax_getters.get_data_processor(jgen, "bach", config["data_processor_kwargs"]),
        jax_getters.get_encoder(jenc_gen, enc_config), enc_config, *args)
    encoder = getters.get_encoder(enc_gen, enc_config)
    dec = getters.get_decoder(
        gen, getters.get_data_processor(gen, "bach", config["data_processor_kwargs"]),
        encoder, enc_config, *args)
    return jdec, dec, getters.z_width(encoder, enc_config)


def _zero_params(init, *args):
    shapes = jax.eval_shape(init, RNGS, *args)["params"]
    return jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, np.float32),
                                  shapes)


@pytest.mark.parametrize("n_head_kv", [None, 4], ids=["mha", "gqa"])
def test_unquantized_decoder_from_getters_at_full_width(tmp_path, n_head_kv):
    """configs/decoder_relative_AC_D_C_random_noQuantization.py over
    configs/encoder_random_no_quantization_config.py's encoder: the source
    is a Linear from the encoder's z width, 32 (the MLP upscaler's
    output_dim, not JAX's source_dim of 3, which flax never reads), and the
    JAX decoder's parameter shapes (jax.eval_shape over z) load with
    strict=True; with n_head_kv 4, grouped, as its own case."""
    jdec, dec, width = _full_width_decoders(
        tmp_path, "decoder_relative_AC_D_C_random_noQuantization.py",
        "encoder_random_no_quantization_config.py", n_head_kv)
    assert width == 32 and jdec.source_vocab_size == 0 and jdec.source_dim == 3
    assert isinstance(dec.source_embeddings, torch.nn.Linear)
    assert (dec.source_embeddings.in_features,
            dec.source_embeddings.out_features) == (32, 512)
    params = _zero_params(jdec.init, jnp.zeros((2, 24, width)),
                          jnp.zeros((2, 96, 4), jnp.int32))
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    assert dec.transformer["encoder"].layers[0].self_attn.num_kv_heads == (
        n_head_kv or 8)


def test_grouped_decoder_and_prior_from_getters_at_full_width(tmp_path):
    """configs/decoder_relative_AC_D_C_random.py and configs/prior_config.py
    with n_head_kv 4 of 8 heads (scripts/measure_gqa_quality.py's n_head / 2
    arm): every attention grouped (kv_proj (2 * 4 * 64, 512), no in_proj),
    and the JAX modules' parameter shapes load with strict=True."""
    jdec, dec, _ = _full_width_decoders(
        tmp_path, "decoder_relative_AC_D_C_random.py",
        "encoder_random_synthetic.py", n_head_kv=4)
    params = _zero_params(jdec.init, jnp.zeros((2, 24), jnp.int32),
                          jnp.zeros((2, 96, 4), jnp.int32))
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    config = dict(_synthetic("prior_config.py"),
                  config_encoder="configs/encoder_random_synthetic.py")
    config["prior_kwargs"] = dict(config["prior_kwargs"], n_head_kv=4)
    enc_config = _synthetic("encoder_random_synthetic.py")
    jgen, gen = _loaders(config, "prior", tmp_path)
    jenc_gen, enc_gen = _loaders(enc_config, "vqcpc", tmp_path)
    args = ("transformer_relative", config["prior_kwargs"])
    jprior = jax_getters.get_prior(
        jgen, jax_getters.get_encoder(jenc_gen, enc_config), enc_config, *args)
    prior = getters.get_prior(gen, getters.get_encoder(enc_gen, enc_config),
                              enc_config, *args)
    prior.load_state_dict(convert.prior_state_dict(
        _zero_params(jprior.init, jnp.zeros((2, 24), jnp.int32))), strict=True)
    for module in (dec, prior):
        attns = [m for m in module.modules() if isinstance(m, MultiheadAttention)]
        assert attns and all(m.num_kv_heads == 4 and m.kv_proj.weight.shape
                             == (512, 512) and not hasattr(m, "in_proj_weight")
                             for m in attns)


# ---- the 'bach' dataset without music21 ---------------------------------------------

def _bach_config():
    return dict(load_config_module(ENCODER_CONFIG), dataset="bach")


@pytest.mark.parametrize("call,item", [
    (lambda root: getters.get_dataloader_generator(
        "bach", "vqcpc", _bach_config()["dataloader_generator_kwargs"],
        _bach_config(), cache_root=root).dataset_positive.windows, "music21"),
], ids=["bach"])
def test_what_waits_raises_naming_its_roadmap_item(call, item, monkeypatch, tmp_path):
    """The 'bach' dataset (music21's chorales) builds its loader, and reading
    the corpus without music21 raises the ImportError that names it, as
    the JAX package's does (corpora.py:121-130)."""
    import sys
    monkeypatch.setitem(sys.modules, "music21", None)
    with pytest.raises(ImportError, match=item):
        call(str(tmp_path))
