"""The port's student slice against the JAX package on the CPU, at a small
size (d_model 32, 2 heads, 1 layer a stage, as tests/test_student_prior.py):
the distilled cross entropy, mask_batch, both relative-transformer
downscalers, the teacher, both auxiliary decoders, the encoder over each
transformer downscaler, and one StudentEncoderTrainer step. The JAX side
takes its XLA route here (the Pallas gates need a TPU). JAX params are the
shapes of jax.eval_shape filled from a seeded numpy generator and go
through vqcpcb_tpu_torch.convert (strict loads); inputs are made with numpy
from a seed. Dropout is 0 wherever JAX and the port are compared."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vqcpcb_tpu.models import auxiliary_decoder as jax_aux
from vqcpcb_tpu.models import downscalers as jax_downscalers
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxBachProcessor
from vqcpcb_tpu.models.encoder import Encoder as JaxEncoder
from vqcpcb_tpu.models.teacher import TeacherRelative as JaxTeacher
from vqcpcb_tpu.ops import losses as jax_losses
from vqcpcb_tpu.ops.quantizer import ProductVectorQuantizer as JaxPVQ
from vqcpcb_tpu.parallel import mesh as mesh_lib
from vqcpcb_tpu.training import student_trainer as jax_student
from vqcpcb_tpu.training.optim import make_optimizer
from vqcpcb_tpu.training.train_state import TrainState
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models import auxiliary_decoder, downscalers
from vqcpcb_tpu_torch.models.data_processor import BachDataProcessor
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.teacher import TeacherRelative
from vqcpcb_tpu_torch.ops import losses
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.training.student_trainer import (StudentEncoderTrainer,
                                                       mask_batch)

VOCABS = [5, 6, 7, 8]
C = len(VOCABS)
EVENTS = 16              # 64 tokens: 4 codes a sequence
BATCH = 3
EMB = 8
D_MODEL = 32
HEADS = 2
FF = 48
POS = 4
FACTORS = [4, 4]
CODES = 8
CODE_DIM = 3
BOTTLENECK = EVENTS * C // 16
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
DOWNSCALERS = {"strided": "RelativeTransformerDownscaler",
               "linear": "RelativeTransformerDownscalerLinear"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a):
    return torch.from_numpy(np.array(a))


def random_params(init, *args, seed=0, **kwargs):
    """The shapes of `init`'s params (jax.eval_shape, nothing compiled),
    filled from a seeded numpy generator: N(0, 0.2), LayerNorm scales
    1 + N(0, 0.1)."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs), *args)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * noise
        return 0.2 * noise
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tokens(seed, batch=BATCH, events=EVENTS):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, v, size=(batch, events)) for v in VOCABS],
                    axis=-1).astype(np.int32)


def _rngs():
    return {"params": KEY, "dropout": KEY}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _apply(module, params, *args, **static):
    """module.apply, compiled (a tenth of the time of op-by-op dispatch
    here), with the dropout key and the static keywords given."""
    return jax.jit(functools.partial(module.apply, **static))(
        {"params": params}, *args, rngs={"dropout": KEY})


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what, **TOL)


# ---- losses and masking -------------------------------------------------------

def test_distilled_crossentropy_matches_jax():
    """Logits per channel, a mask with some events at batch-mean 1/3 (out)
    and some at 2/3 (in): 1e-6 relative."""
    rng = np.random.RandomState(0)
    value = [rng.randn(BATCH, EVENTS, v).astype(np.float32) * 3 for v in VOCABS]
    target = [rng.randn(BATCH, EVENTS, v).astype(np.float32) * 3 for v in VOCABS]
    mask = (rng.rand(BATCH, EVENTS, C) < 0.5).astype(np.int32)
    want = jax_losses.distilled_categorical_crossentropy(
        [jnp.asarray(v) for v in value], [jnp.asarray(t) for t in target],
        jnp.asarray(mask))
    got = losses.distilled_categorical_crossentropy(
        [_t(v) for v in value], [_t(t) for t in target], _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("index", [0, EVENTS // 2, EVENTS - 1])
def test_mask_batch_matches_jax(index):
    x = _tokens(1)
    want = jax_student.mask_batch(jnp.asarray(x), jnp.int32(index), 2, VOCABS)
    got = mask_batch(_t(x), index, 2, VOCABS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


# ---- the modules ------------------------------------------------------------------

def _downscaler_pair(kind):
    name = DOWNSCALERS[kind]
    jmod = getattr(jax_downscalers, name)(
        output_dim=CODE_DIM, downscale_factors=FACTORS, num_channels=C,
        d_model=D_MODEL, n_head=HEADS, list_of_num_layers=[1, 1],
        dim_feedforward=FF, dropout=0.0, positional_embedding_size=POS)
    mod = getattr(downscalers, name)(
        EMB, CODE_DIM, FACTORS, C, D_MODEL, HEADS, [1, 1], FF, 0.0,
        positional_embedding_size=POS)
    return jmod, mod


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(DOWNSCALERS))
def test_transformer_downscaler_matches_jax(kind, training):
    """(B, 2 blocks of 16 tokens, emb) -> (B, 2, 3) within 1e-5; in train
    mode the port's layers take the training route."""
    jmod, mod = _downscaler_pair(kind)
    x = np.random.RandomState(2).randn(BATCH, 32, EMB).astype(np.float32)
    params = random_params(jmod.init, _rngs(), jnp.asarray(x))
    sd = convert.encoder_state_dict({"data_processor": {}, "downscaler": params})
    mod.load_state_dict(_sub(sd, "downscaler."), strict=True)
    want = _apply(jmod, params, jnp.asarray(x), training=training)
    mod.train(not training)            # the argument, not the mode, decides
    got = mod(_t(x), training=training)
    assert got.shape == (BATCH, 2, CODE_DIM)
    _close(got.detach().numpy(), want)


def _teacher_pair():
    jdp = JaxBachProcessor(embedding_size=EMB, num_events=EVENTS,
                           num_tokens_per_channel=VOCABS)
    jteacher = JaxTeacher(data_processor=jdp, num_layers=1,
                          num_tokens_per_channel=VOCABS, positional_embedding_size=POS,
                          d_model=D_MODEL, dim_feedforward=FF, n_head=HEADS,
                          num_tokens=EVENTS * C, dropout=0.0)
    teacher = TeacherRelative(BachDataProcessor(EMB, EVENTS, VOCABS), 1, VOCABS, POS,
                              D_MODEL, FF, HEADS, EVENTS * C, 0.0)
    return jdp, jteacher, teacher


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_teacher_matches_jax(training):
    """Masked chorales through the teacher's data processor (mask rows
    included) and the teacher: each channel's logits within 1e-5."""
    jdp, jteacher, teacher = _teacher_pair()
    x, _ = jax_student.mask_batch(jnp.asarray(_tokens(3)), jnp.int32(5), 2, VOCABS)
    dp_params = random_params(jdp.init, _rngs(), x, seed=1)
    embedded = jdp.apply({"params": dp_params}, x)
    params = random_params(jteacher.init, _rngs(), embedded)
    teacher.load_state_dict(convert.teacher_state_dict(params, dp_params), strict=True)
    want = _apply(jteacher, params, embedded, training=training)
    teacher.train(training)
    got = teacher(teacher.data_processor(_t(x)))
    assert len(got) == C
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (BATCH, EVENTS, VOCABS[c])
        _close(g.detach().numpy(), w, f"channel {c}")


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("relative", [False, True], ids=["absolute", "relative"])
def test_auxiliary_decoder_matches_jax(relative, training):
    """z (B, 4, 3) -> per-channel logits (B, 16, vocab_c) within 1e-5."""
    name = "AuxiliaryDecoderRelative" if relative else "AuxiliaryDecoder"
    kwargs = dict(num_tokens_per_channel=VOCABS, codebook_dim=CODE_DIM,
                  upscale_factors=FACTORS, list_of_num_layers=[1, 1], n_head=HEADS,
                  d_model=D_MODEL, dim_feedforward=FF,
                  num_tokens_bottleneck=BOTTLENECK, dropout=0.0)
    jmod = getattr(jax_aux, name)(**kwargs)
    mod = getattr(auxiliary_decoder, name)(**kwargs)
    z = np.random.RandomState(4).randn(BATCH, BOTTLENECK, CODE_DIM).astype(np.float32)
    params = random_params(jmod.init, _rngs(), jnp.asarray(z))
    mod.load_state_dict(convert.auxiliary_decoder_state_dict(params), strict=True)
    want = _apply(jmod, params, jnp.asarray(z), training=training)
    mod.train(training)
    got = mod(_t(z))
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (BATCH, EVENTS, VOCABS[c])
        _close(g.detach().numpy(), w, f"channel {c}")


def _encoder_pair(kind):
    jds, ds = _downscaler_pair(kind)
    jenc = JaxEncoder(
        data_processor=JaxBachProcessor(embedding_size=EMB, num_events=EVENTS,
                                        num_tokens_per_channel=VOCABS),
        downscaler=jds,
        quantizer=JaxPVQ(codebook_size=CODES, codebook_dim=CODE_DIM,
                         commitment_cost=0.25, num_codebooks=1))
    enc = Encoder(BachDataProcessor(EMB, EVENTS, VOCABS), ds,
                  ProductVectorQuantizer(CODES, CODE_DIM, 0.25, 1))
    return jenc, enc


def _spread_codebooks(jenc, params, x):
    """Codebook rows taken from the downscaler's latents of x, so the codes
    spread over the codebook."""
    z = np.asarray(_apply(jenc, params, jnp.asarray(x),
                          method=lambda m, inp: m.downscale(inp)))
    rows = z.reshape(-1, CODE_DIM)
    params["quantizer"]["codebooks"] = rows[
        np.random.RandomState(0).permutation(len(rows))[:CODES]][None]
    return params


@pytest.mark.parametrize("kind", sorted(DOWNSCALERS))
def test_encoder_with_transformer_downscaler_matches_jax(kind):
    """Codes equal bit for bit, z and the commitment loss within 1e-5, in
    eval and (dropout 0) in train mode."""
    jenc, enc = _encoder_pair(kind)
    x = _tokens(5, batch=4)
    params = _spread_codebooks(jenc, random_params(jenc.init, _rngs(), jnp.asarray(x)), x)
    enc.load_state_dict(convert.encoder_state_dict(params), strict=True)
    for training in (False, True):
        zq, idx, qloss = _apply(jenc, params, jnp.asarray(x), training=training)
        got_zq, got_idx, got_qloss = enc(_t(x), training=training)
        assert len(np.unique(np.asarray(idx))) > 2
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        _close(got_zq.detach().numpy(), zq, "z")
        _close(got_qloss.detach().numpy(), qloss, "quantization loss")


# ---- the trainer ----------------------------------------------------------------

LR = 1e-5                # configs/encoder_student_config.py's
NUM_MASKED = 2


def _student_pairs(aux_relative=True):
    """JAX and port encoder (linear downscaler), teacher and relative (or
    absolute) auxiliary decoder of one geometry."""
    jenc, enc = _encoder_pair("linear")
    jdp, jteacher, teacher = _teacher_pair()
    name = "AuxiliaryDecoderRelative" if aux_relative else "AuxiliaryDecoder"
    kwargs = dict(num_tokens_per_channel=VOCABS, codebook_dim=CODE_DIM,
                  upscale_factors=FACTORS[::-1], list_of_num_layers=[1, 1],
                  n_head=HEADS, d_model=D_MODEL, dim_feedforward=FF,
                  num_tokens_bottleneck=BOTTLENECK, dropout=0.0)
    return ((jenc, jteacher, getattr(jax_aux, name)(**kwargs)),
            (enc, teacher, getattr(auxiliary_decoder, name)(**kwargs)))


def _jax_student_state(jmods, x):
    """A JAX student TrainState with seeded-fill params in the four groups,
    spread codebooks and fresh Adam states (what init_state builds, without
    its compiled inits)."""
    jenc, jteacher, jaux = jmods
    masked, _ = jax_student.mask_batch(jnp.asarray(x), jnp.int32(0), NUM_MASKED,
                                       VOCABS)
    enc_params = _spread_codebooks(
        jenc, random_params(jenc.init, _rngs(), jnp.asarray(x)), x)
    dp_params = random_params(jteacher.data_processor.init, _rngs(), masked, seed=1)
    embedded = jteacher.data_processor.apply({"params": dp_params}, masked)
    z = jax.ShapeDtypeStruct((x.shape[0], BOTTLENECK, CODE_DIM), jnp.float32)
    params = {"encoder": enc_params,
              "teacher": random_params(jteacher.init, _rngs(), embedded, seed=2),
              "auxiliary_decoder": random_params(jaux.init, _rngs(), z, seed=3),
              "teacher_data_processor": dp_params}
    tx = make_optimizer(LR, False)
    opt_state = {"teacher": tx.init({k: params[k] for k in ("teacher",
                                                            "teacher_data_processor")}),
                 "encdec": tx.init({k: params[k] for k in ("encoder",
                                                           "auxiliary_decoder")})}
    return TrainState(params=params, opt_state=opt_state, batch_stats={}, step=0), tx


def _grads_kept():
    """An optax transformation whose updates are zeros and whose state
    becomes the gradients it is given: after one JAX train step with it,
    the opt_state holds the step's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads),
                                           grads))


def _jax_student_grads(jtrainer, state, x, rng):
    """The gradients of JAX's train step (its teacher_loss and encdec_loss
    closures, student_trainer.py:182-221) at `state`'s params, one tree
    over the four groups; the trainer's optimizers are put back after."""
    saved = jtrainer.tx_teacher, jtrainer.tx_encdec
    kept = _grads_kept()
    jtrainer.tx_teacher = jtrainer.tx_encdec = kept
    jtrainer._build_steps()
    params = jax.tree.map(jnp.array, state.params)
    groups = {"teacher": ("teacher", "teacher_data_processor"),
              "encdec": ("encoder", "auxiliary_decoder")}
    opt_state = {g: kept.init({k: params[k] for k in keys})
                 for g, keys in groups.items()}
    out, _ = jtrainer._train_step(
        TrainState(params=params, opt_state=opt_state, batch_stats={}, step=0),
        jnp.asarray(x), rng)
    jtrainer.tx_teacher, jtrainer.tx_encdec = saved
    jtrainer._build_steps()
    return {**out.opt_state["teacher"], **out.opt_state["encdec"]}


@pytest.mark.parametrize("aux_relative", [True, False], ids=["relative", "absolute"])
def test_student_trainer_step_matches_jax(aux_relative):
    """One train step of each package from the same params, with the masked
    event JAX's step draws from its key passed to the port: every
    parameter's gradient of the four groups (the port's one backward of
    both losses against jax.grad of JAX's two closures) within 1e-5 of its
    max |gradient|; the four losses within 1e-5 relative, and every
    parameter after both Adams within 1e-5 of its max |value| (lr 1e-5,
    the student config's; this holds the optimizers' wiring, Adam's first
    step being about lr * sign(g)); then one eval step's losses."""
    jmods, mods = _student_pairs(aux_relative)
    x = _tokens(6, batch=4)
    state, tx = _jax_student_state(jmods, x)
    jtrainer = jax_student.StudentEncoderTrainer(
        model_dir="unused", dataloader_generator=None, encoder=jmods[0],
        teacher=jmods[1], auxiliary_decoder=jmods[2],
        num_events_masked=NUM_MASKED, quantization_weighting=0.1,
        mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    jtrainer.tx_teacher = jtrainer.tx_encdec = tx
    jtrainer._build_steps()
    rng = jax.random.PRNGKey(7)
    # the masked event of JAX's step (student_trainer.py:185-186)
    index = int(jax.random.randint(jax.random.split(rng, 4)[0], (), 0, EVENTS))
    new_state, jmetrics = jtrainer._train_step(state, jnp.asarray(x), rng)

    enc, teacher, aux = mods
    trainer = StudentEncoderTrainer(enc, teacher, aux, NUM_MASKED, 0.1,
                                    device="cpu", seed=0)
    params = jax.tree.map(np.asarray, state.params)
    trainer.model.load_state_dict(convert.student_state_dict(params), strict=True)
    trainer.init_state(x, lr=LR, initialize=False)
    loss_t, loss_e, _ = trainer.losses(x, index)
    (loss_t + loss_e).backward()
    want_grads = convert.student_state_dict(
        jax.tree.map(np.asarray, _jax_student_grads(jtrainer, state, x, rng)))
    named = dict(trainer.model.named_parameters())
    assert set(named) <= set(want_grads)
    for name, p in named.items():
        w = want_grads[name]
        g = torch.zeros_like(w) if p.grad is None else p.grad
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err, float(w.abs().max()))
    assert sum(float(w.abs().max()) > 0 for w in want_grads.values()) > len(named) // 2
    metrics = trainer.train_step(x, masked_event_index=index)
    for name in ("loss_teacher", "loss_quantization", "loss_reconstruction",
                 "loss_encdec", "loss_monitor"):
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]),
                                   rtol=1e-5, err_msg=name)
    want = convert.student_state_dict(jax.tree.map(np.asarray, new_state.params))
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    before = convert.student_state_dict(params)
    moved = set()
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
        if not torch.equal(w, before[name]):
            moved.add("teacher_data_processor"
                      if name.startswith("teacher.data_processor.")
                      else name.split(".")[0])
    assert moved == {"encoder", "teacher", "auxiliary_decoder",
                     "teacher_data_processor"}
    assert trainer.step == 1 and trainer.optimizer_teacher.count == 1

    jeval = jtrainer._eval_step(new_state, jnp.asarray(x), rng)
    got_eval = trainer.eval_step(x, masked_event_index=index)
    for name, value in got_eval.items():
        np.testing.assert_allclose(value.item(), float(jeval[name]), rtol=1e-5,
                                   err_msg=name)


def test_student_init_state_codebooks_and_batch_check():
    """The data-dependent codebook init reads the downscaler's latents in
    eval mode (rows of z, bit for bit, with JAX's permutation given); a
    batch with fewer latents than codewords raises."""
    _, mods = _student_pairs()
    trainer = StudentEncoderTrainer(*mods, NUM_MASKED, 0.1, device="cpu")
    x = _tokens(8, batch=4)
    perm = np.random.RandomState(1).permutation(4 * BOTTLENECK)
    trainer.init_state(x, lr=LR, perms=[perm])
    with torch.no_grad():
        z = trainer.encoder.downscale(_t(x), training=False).reshape(-1, CODE_DIM)
    torch.testing.assert_close(trainer.encoder.quantizer.codebooks[0],
                               z[torch.as_tensor(perm[:CODES])], rtol=0, atol=0)
    with pytest.raises(ValueError, match="latents cannot initialise"):
        trainer.init_state(x[:1], lr=LR)
