"""The port's (data, model) mesh against the JAX package's on the CPU
(vqcpcb_tpu_torch/parallel/, the K7 shard wrappers, the tensor-parallel
modules, the decoder, prior, VQ-CPC and student trainers over ranks, and
the encoder CLI on two ranks).

The JAX side runs on conftest's 8 virtual CPU devices, its kernels in
interpret mode with f32 dots, as tests/test_multichip.py runs them. JAX
parameters come from jax.eval_shape and a seeded fill (no compiled init) and
reach the port through convert.py. The ranks of the port are processes over
gloo (parallel/launch.run_ranks, training through
torch_mesh_harness.train_over_mesh): every group has a process-group
timeout and a deadline, and is killed on failure; every rank starts through
distributed.maybe_initialize's coordinator path (VQCPCB_COORDINATOR)."""
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vqcpcb_tpu.models import auxiliary_decoder as jax_aux
from vqcpcb_tpu.models import cpc as jax_cpc
from vqcpcb_tpu.models import downscalers as jax_downscalers
from vqcpcb_tpu.models.data_processor import BachCPCDataProcessor as JaxCPCProcessor
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.models.encoder import Encoder as JaxEncoder
from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu.models.teacher import TeacherRelative as JaxTeacher
from vqcpcb_tpu.models.upscalers import MlpUpscaler as JaxMlpUpscaler
from vqcpcb_tpu.ops import pallas_attention as jpa
from vqcpcb_tpu.ops import quantizer as jax_quantizer
from vqcpcb_tpu.parallel import mesh as jmesh
from vqcpcb_tpu.training import student_trainer as jax_student
from vqcpcb_tpu.training.encoder_trainer import VQCPCEncoderTrainer as JaxCPCTrainer
from vqcpcb_tpu.training.train_state import TrainState
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models import auxiliary_decoder, cpc, downscalers
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.models.teacher import TeacherRelative
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
from vqcpcb_tpu_torch.ops import vq_kernels as vk
from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                            ProductVectorQuantizer)
from vqcpcb_tpu_torch.parallel import distributed
from vqcpcb_tpu_torch.parallel import mesh as pmesh
from vqcpcb_tpu_torch.parallel.launch import run_ranks
from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
from torch_mesh_harness import run_job

VOCABS = [7, 9, 6, 8]           # 6 and 8 split over 2 ranks, 8 over 4
NUM_EVENTS = 16                 # 64 target tokens from 4 codes
NUM_CODES = NUM_EVENTS * 4 // 16
CODEBOOK = 8
BATCH = 8
KEY = jax.random.PRNGKey(0)
LAUNCH = "torch_mesh_harness:train_over_mesh"
RANKS_TIMEOUT_S = 120
# JAX's mesh steps compile side by side in threads but run one at a time:
# multi-device CPU programs with collectives, run from several threads at
# once on shared devices, can abort the process
JAX_RUN = threading.Lock()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _decoder_kwargs(kind):
    """The JAX and port decoders' shared geometry: the flagship AC/D/C, the
    absolute decoder with full cross-attention, or the flagship with 2 KV
    heads of 4 (split over 2 ranks, replicated over 4)."""
    kw = dict(transformer_type="relative", cross_attention_type="diagonal",
              n_head_kv=None)
    if kind == "absolute":
        kw.update(transformer_type="absolute", cross_attention_type="full")
    elif kind == "gqa":
        kw.update(n_head_kv=2)
    return dict(kw, d_model=32, n_head=4, dim_feedforward=48,
                positional_embedding_size=4, num_channels_encoder=1,
                num_events_encoder=NUM_CODES, num_channels_decoder=4,
                num_events_decoder=NUM_EVENTS, dropout=0.0, total_upscaling=16,
                source_vocab_size=CODEBOOK)


PRIOR = dict(code_vocab_size=CODEBOOK, d_model=32, num_layers=1, n_head=4,
             dim_feedforward=48, embedding_size=16, num_channels=1,
             num_events=NUM_CODES, dropout=0.0)


def _fill(shapes, seed, scale=0.3):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * noise
        return scale * noise
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def model_pair(kind):
    """(the JAX module, its params, the port module with them, the port's
    state_dict converter): a 1 + 1-layer decoder or a 1-layer prior."""
    if kind == "prior":
        jmod = JaxPrior(**PRIOR)
        shapes = jax.eval_shape(jmod.init, {"params": KEY, "dropout": KEY},
                                jnp.zeros((2, NUM_CODES), jnp.int32))["params"]
        params = _fill(shapes, 1)
        port = PriorRelative(**PRIOR)
        to_port = convert.prior_state_dict
    else:
        kw = _decoder_kwargs(kind)
        jmod = JaxDecoder(data_processor=JaxProcessor(
            embedding_size=16, num_events=NUM_EVENTS, num_tokens_per_channel=VOCABS),
            encoder_attention_type="anticausal", num_encoder_layers=1,
            num_decoder_layers=1, **kw)
        shapes = jax.eval_shape(
            jmod.init, {"params": KEY, "dropout": KEY},
            jnp.zeros((2, NUM_CODES), jnp.int32),
            jnp.zeros((2, NUM_EVENTS, 4), jnp.int32))["params"]
        params = _fill(shapes, 2)
        port = Decoder(BachDataProcessor(16, NUM_EVENTS, VOCABS), "anticausal",
                       num_encoder_layers=1, num_decoder_layers=1, **kw)
        to_port = convert.decoder_state_dict
    port.load_state_dict(to_port(params), strict=True)
    return jmod, params, port, to_port


def _jax_mesh(num_model, n_devices=8):
    return jmesh.make_mesh(num_model=num_model, devices=jax.devices()[:n_devices])


# ---- the TP rules -----------------------------------------------------------------

@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("kind", ["flagship", "absolute", "gqa", "prior"])
def test_tp_blocks_match_jax_params_shardings(kind, num_model):
    """On (8/m, m) meshes, every parameter's block on each model rank (the
    port's TP_RULES on its names, through local_slice and shard_params)
    holds exactly the elements of JAX's params_shardings block of the
    converted parameter: the JAX block is marked with ones in a zero tree,
    converted, and the port's block of the mark must be all ones and hold
    all of them. Replicated parameters are whole on every rank."""
    import copy
    jmod, params, port, to_port = model_pair(kind)
    mesh = _jax_mesh(num_model)
    shardings = jmesh.params_shardings(params, mesh)
    specs = pmesh.tp_specs(port, num_model)
    full = port.state_dict()
    n_split = 0
    for mi in range(num_model):
        device = mesh.devices[0, mi]

        def mark(leaf, sharding):
            out = np.zeros(leaf.shape, np.float32)
            out[sharding.devices_indices_map(leaf.shape)[device]] = 1.0
            return out
        marks = to_port(jax.tree.map(mark, params, shardings))
        rank = pmesh.simulated_mesh(8 // num_model, num_model, mi)
        local = copy.deepcopy(port)
        pmesh.shard_params(local, rank)
        local_sd = local.state_dict()
        for name, m in marks.items():
            block = pmesh.local_slice(m, specs[name], rank)
            assert bool((block == 1).all()) and block.numel() == int(m.sum()), name
            assert torch.equal(local_sd[name],
                               pmesh.local_slice(full[name], specs[name], rank)), name
            n_split += specs[name] is not None
    assert n_split > 0
    if kind == "gqa":
        kv = "transformer.encoder.layers.0.self_attn.kv_proj.weight"
        assert (specs[kv] is not None) == (num_model == 2)


def test_gather_params_inverts_shard_params_on_one_rank():
    """gather_params of a one-rank mesh is the state_dict; local_state_dict
    of the full state is every sharded module's state on its rank."""
    _, _, port, _ = model_pair("flagship")
    one = pmesh.Mesh(1, 1)
    assert pmesh.shard_params(port, one) is port and not pmesh.module_specs(port)
    sd = pmesh.gather_params(port, one)
    assert all(torch.equal(sd[k], v) for k, v in port.state_dict().items())


# ---- K7 against JAX's *_tp -----------------------------------------------------------

B, H, T, S, D = 4, 4, 8, 8, 8         # b_local 1 or 2, h_local 2 or 1


def _k7_inputs():
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (T, S, S))
    e1, e2 = (rng.randn(H, S, D).astype(np.float32) for _ in range(2))
    bias = (0.1 * rng.randn(B, H, T, S)).astype(np.float32)
    mask = np.triu(np.full((T, S), -1e9, np.float32), 1)
    return q, k, v, e1, e2, bias, mask


def _pack(x):
    b, h, n, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, n, h * d)


def _jax_tp(fn, mesh, q, k, v, e1, e2, bias, mask, seed):
    """JAX's *_tp output and gradients (sum of squares) at dropout 0."""
    seed = jnp.full((1,), seed, jnp.int32)
    mask = jnp.asarray(mask)

    def loss(q, k, v, x1, x2):
        if fn == "packed":
            out = jpa.fused_attention_train_relbias_packed_tp(
                mesh, 0.0, True, H, seed, q, k, v, mask, x1, x2)
        elif fn == "bhld":
            out = jpa.fused_attention_train_relbias_tp(
                mesh, 0.0, True, seed, q, k, v, mask, x1, x2)
        else:
            out = jpa.fused_attention_train_tp(mesh, 0.0, True, seed, q, k, v,
                                               mask, x1)
        return jnp.sum(out ** 2), out

    qkv = [jnp.asarray(_pack(x) if fn == "packed" else x) for x in (q, k, v)]
    extra = ([jnp.asarray(e1), jnp.asarray(e2)] if fn != "fused"
             else [jnp.asarray(bias), jnp.zeros(())])
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*qkv, *extra)
    grads = [np.asarray(g) for g in grads]
    return np.asarray(out), grads[:4] if fn == "fused" else grads


def _unpack(x, h):
    b, n, e = x.shape
    return x.reshape(b, n, h, e // h).swapaxes(1, 2)


def _port_tp(fn, n_data, n_model, q, k, v, e1, e2, bias, mask, seed):
    """The port's K7 wrapper (plain versions on the CPU) on every simulated
    shard of an (n_data, n_model) mesh, each on its (b_local, h_local)
    planes: the shards' outputs and gradients (sum of squares) put back in
    place as (B, H, L, d); the tables' gradients summed over the data
    shards."""
    lb, lh = B // n_data, H // n_model
    out = np.zeros((B, H, T, D), np.float32)
    grads = [np.zeros_like(x) for x in (q, k, v)]
    grads += ([np.zeros_like(bias)] if fn == "fused"
              else [np.zeros_like(e1), np.zeros_like(e2)])
    mask_t = torch.from_numpy(mask)
    for rank in range(n_data * n_model):
        mesh = pmesh.simulated_mesh(n_data, n_model, rank)
        rows = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)
        hs = slice(mesh.model_index * lh, (mesh.model_index + 1) * lh)
        blocks = [x[rows, hs] for x in (q, k, v)]
        if fn == "packed":
            blocks = [_pack(x) for x in blocks]
        leaves = [torch.tensor(x).requires_grad_() for x in blocks]
        if fn == "fused":
            leaves.append(torch.tensor(bias[rows, hs]).requires_grad_())
            o = fk.fused_attention_train_tp(
                mesh, *leaves[:3], mask_t, leaves[3].reshape(lb * lh, T, S),
                None, 0.0, seed, torch.float32)
        else:
            leaves += [torch.tensor(x[hs]).requires_grad_() for x in (e1, e2)]
            if fn == "packed":
                o = ak.relbias_attention_packed_tp(mesh, *leaves[:3], mask_t,
                                                   *leaves[3:], lh, 0.0, seed,
                                                   torch.float32)
            else:
                o = ak.relbias_attention_tp(mesh, *leaves[:3], mask_t,
                                            *leaves[3:], 0.0, seed, torch.float32)
        unpack = (lambda x: _unpack(x, lh)) if fn == "packed" else (lambda x: x)
        out[rows, hs] = unpack(o.detach()).numpy()
        (o * o).sum().backward()
        for i, leaf in enumerate(leaves):
            g = leaf.grad
            if i < 3:
                grads[i][rows, hs] = unpack(g).numpy()
            elif fn == "fused":
                grads[i][rows, hs] = g.numpy()
            else:
                grads[i][hs] += g.numpy()
    return out, grads


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("fn", ["packed", "bhld", "fused"])
def test_k7_matches_jax_tp(fn, num_model, monkeypatch):
    """relbias_attention_packed_tp, relbias_attention_tp and
    fused_attention_train_tp on the shards of a (8/m, m) mesh against
    fused_attention_train_relbias_packed_tp, fused_attention_train_relbias_tp
    and fused_attention_train_tp: at dropout 0 the outputs within 2e-5 and
    the gradients within 2e-4 relative / 2e-5 absolute (tests/
    test_multichip.py:209-336's bounds). The shards' dropout streams are
    held by test_k7_shard_masks_match_jax_hash."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "0")
    q, k, v, e1, e2, bias, mask = _k7_inputs()
    want, want_grads = _jax_tp(fn, _jax_mesh(num_model), q, k, v, e1, e2, bias,
                               mask, 7)
    got, grads = _port_tp(fn, 8 // num_model, num_model, q, k, v, e1, e2, bias,
                          mask, 7)
    if fn == "packed":
        want = _unpack(want, H)
        want_grads = [_unpack(g, H) for g in want_grads[:3]] + want_grads[3:]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("fn", ["relbias", "fused"])
def test_k7_shard_masks_match_jax_hash(fn, num_model):
    """At dropout 0.2 each shard's keep mask, read from the K7 wrapper's
    plain forward (v the one-hot columns, so out is the dropped weights),
    equals JAX's hash at the seed its shard_map `local()` gives the kernel
    (pallas_attention.py:1068-1071, 1152-1157: seed + shard * b_local *
    h_local, then the relbias grid's h * b_local + b or K6's b * h_local +
    h), bit for bit."""
    rate, seed = 0.2, 12345
    n_data = 8 // num_model
    lb, lh = B // n_data, H // num_model
    rng = np.random.RandomState(3)
    q = torch.tensor(rng.randn(lb, lh, T, D).astype(np.float32))
    k = torch.tensor(rng.randn(lb, lh, S, D).astype(np.float32))
    v = torch.eye(S, D).expand(lb, lh, S, D).contiguous()      # S == D: one-hot
    e1, e2 = (torch.tensor(rng.randn(lh, S, D).astype(np.float32)) for _ in range(2))
    hash_keep = jax.jit(jax.vmap(lambda s: jpa._dropout_keep((T, S), rate, s)))
    for rank in range(n_data * num_model):
        mesh = pmesh.simulated_mesh(n_data, num_model, rank)
        if fn == "relbias":
            out = ak.relbias_attention_tp(mesh, q, k, v, None, e1, e2, rate, seed,
                                          torch.float32)
            weights = ak.relbias_attention_fwd_plain(q, k, v, None, e1, e2,
                                                     torch.float32)
        else:
            out = fk.fused_attention_train_tp(mesh, q, k, v, None, None, None,
                                              rate, seed, torch.float32)
            weights = fk.fused_attention_train_fwd_plain(q, k, v, None, None,
                                                         torch.float32)
        kept = (out != 0).numpy()
        assert bool((weights > 0).all())
        local = np.int32(seed) + np.int32(rank) * np.int32(lb * lh)
        b_i = np.arange(lb, dtype=np.int32)[:, None]
        h_i = np.arange(lh, dtype=np.int32)[None, :]
        streams = local + (h_i * lb + b_i if fn == "relbias" else b_i * lh + h_i)
        want = np.asarray(hash_keep(jnp.asarray(streams.reshape(-1)))).reshape(
            lb, lh, T, S)
        np.testing.assert_array_equal(kept, want)


def test_k1_row_shards_match_jax_mesh_branch(monkeypatch):
    """K1's mesh branch as the trainers run it: each rank's rows of the
    global batch (parallel/mesh.shard_batch) through the ordinary K1 entry,
    on every data shard of an 8-row-block mesh, concatenated, against JAX's
    shard_mapped K1 (force_pallas, on the 8 devices, in interpret mode as
    tests/test_pallas_vq.py runs it) bit for bit; rows that do not divide
    the data axis are run whole on every rank."""
    from vqcpcb_tpu.ops import pallas_vq as jvq
    orig = jvq.pl.pallas_call
    monkeypatch.setattr(jvq.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    rng = np.random.RandomState(4)
    x = rng.randn(64, 1, 3).astype(np.float32)
    codebooks = rng.randn(1, CODEBOOK, 3).astype(np.float32)
    jmesh.make_mesh(num_model=1)
    want = np.asarray(jvq.nearest_codebook_indices(
        jnp.asarray(x), jnp.asarray(codebooks), force_pallas=True))
    cb = torch.from_numpy(codebooks)
    got = np.concatenate([
        vk.nearest_codebook_indices(
            pmesh.shard_batch(torch.from_numpy(x), pmesh.simulated_mesh(8, 1, r)),
            cb).numpy()
        for r in range(8)])
    np.testing.assert_array_equal(got, want)
    odd = pmesh.shard_batch(torch.from_numpy(x[:60]), pmesh.simulated_mesh(8, 1, 3))
    assert odd.shape[0] == 60
    np.testing.assert_array_equal(vk.nearest_codebook_indices(odd, cb).numpy(),
                                  want[:60])


# ---- the trainers over gloo ranks ---------------------------------------------------

def _encoder_and_batches():
    """A tiny GRU encoder whose codebook is spread over its downscaler's
    outputs (so the codes differ from block to block), and two global token
    batches of BATCH."""
    torch.manual_seed(0)
    encoder = Encoder(
        BachCPCDataProcessor(16, NUM_EVENTS, VOCABS, num_tokens_per_block=16),
        GruDownscaler(16, 3, [16], 32, num_layers=1, dropout=0.0,
                      bidirectional=True),
        ProductVectorQuantizer(CODEBOOK, 3, 0.25, 1))
    rng = np.random.RandomState(5)
    batches = [np.stack([rng.randint(0, v, (BATCH, NUM_EVENTS)) for v in VOCABS],
                        -1).astype(np.int64) for _ in range(2)]
    with torch.no_grad():
        z = encoder.eval().downscale(torch.from_numpy(batches[0])).reshape(-1, 3)
        encoder.quantizer.embeddings[0].copy_(
            z[torch.from_numpy(np.random.RandomState(0).permutation(len(z))[:CODEBOOK])])
        _, indices, _ = encoder(torch.from_numpy(batches[0]))
    codes = merge_codes(indices, CODEBOOK)
    assert len(torch.unique(codes)) > 3
    return encoder, batches


def _two_head_prior():
    """The prior with 2 heads: over a model axis of 4 its attention stays
    whole on every rank (heads do not divide) while out_proj, linear1 /
    linear2 and the head split (split_to_model's path)."""
    torch.manual_seed(3)
    return PriorRelative(**dict(PRIOR, n_head=2))


def _job(kind, encoder, batches, num_model, model_dir=None, model=None):
    import copy
    model = model_pair(kind)[2] if model is None else model
    return dict(kind=kind, encoder=copy.deepcopy(encoder),
                model=copy.deepcopy(model), codebook_size=CODEBOOK,
                num_model=num_model, batches=batches, lr=1e-3, device="cpu",
                eval_batch=batches[0], model_dir=model_dir)


def _one_rank(kind, encoder, batches, model=None):
    """The same steps on one rank in this process: losses, the first step's
    clipped gradients."""
    result = run_job(_job(kind, encoder, batches, 1, model=model), pmesh.Mesh(1, 1))
    return result["losses"], result["grads"]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One group of 4 gloo ranks over a (2, 2) mesh: the flagship decoder
    and the prior (two steps each; the decoder's overfitted slot written),
    the 2-head prior over (1, 4), the VQ-CPC (BatchNorm quantizer) and the
    student (two steps each, JAX's weights), then the sampler jobs of
    _sampler_jobs(4); and one of 2 ranks over (2, 1): the decoder (one
    step), the encoder-side jobs of _two_rank_jobs, the encoder CLI -t, the
    sampler jobs of _sampler_jobs(2) and the decoder and prior CLIs'
    generation (_generation_cli_jobs); started together. JAX's (2, 2) mesh
    steps and its (4, 2) samplers are computed while they run."""
    encoder, batches = _encoder_and_batches()
    slot_dir = str(tmp_path_factory.mktemp("mesh_slot"))
    cli_dir = tmp_path_factory.mktemp("mesh_cli")
    tp_jobs = [_job("decoder", encoder, batches, 2, slot_dir),
               _job("prior", encoder, batches, 2),
               _job("prior", encoder, batches[:1], 4, model=_two_head_prior()),
               _encoder_job("vqcpc", cpc_pair()[2], CPC_BATCHES, 2,
                            initialize=False),
               _encoder_job("student", student_pair()[2], STUDENT_BATCHES, 2,
                            initialize=False, masked_event_index=STUDENT_INDEX)]
    tp_samplers = _sampler_jobs(4)
    dp_jobs = ([_job("decoder", encoder, batches[:1], 1)]
               + list(_two_rank_jobs().values()) + [_cli_job(cli_dir)])
    dp_samplers = _sampler_jobs(2)
    generation_clis = _generation_cli_jobs(cli_dir)
    # the JAX steps compile side by side (XLA compiles outside the GIL) and
    # run one at a time (JAX_RUN)
    with ThreadPoolExecutor(6) as pool:
        tp = pool.submit(run_ranks, LAUNCH, 4, tp_jobs + list(tp_samplers.values()),
                         timeout_s=RANKS_TIMEOUT_S)
        dp = pool.submit(run_ranks, LAUNCH, 2,
                         dp_jobs + list(dp_samplers.values()) + generation_clis,
                         timeout_s=RANKS_TIMEOUT_S)
        jax_steps = {kind: pool.submit(_jax_mesh_step, kind, encoder, batches[0])
                     for kind in ("decoder", "prior")}
        jax_steps.update(vqcpc=pool.submit(_jax_cpc_mesh_step),
                         student=pool.submit(_jax_student_mesh_step))
        jax_samples = {kind: pool.submit(_jax_mesh_sample, kind)
                       for kind in ("decoder", "prior")}
        jax_steps = {kind: f.result() for kind, f in jax_steps.items()}
        jax_samples = {kind: f.result() for kind, f in jax_samples.items()}
        tp_results, dp_results = tp.result(), dp.result()
    names = list(_two_rank_jobs())
    n_tp, n_dp = len(tp_jobs), len(dp_jobs)
    samplers = {(name, 4): [r[n_tp + i] for r in tp_results]
                for i, name in enumerate(tp_samplers)}
    samplers.update({(name, 2): [r[n_dp + i] for r in dp_results]
                     for i, name in enumerate(dp_samplers)})
    return dict(encoder=encoder, batches=batches, slot_dir=slot_dir,
                decoder=tp_results[0][0], prior=tp_results[0][1],
                two_heads=tp_results[0][2], vqcpc=tp_results[0][3],
                student=tp_results[0][4], tp_others=tp_results[1:],
                dp=[r[0] for r in dp_results],
                two_ranks={name: [r[1 + i] for r in dp_results]
                           for i, name in enumerate(names)},
                cli=[r[n_dp - 1] for r in dp_results], cli_dir=cli_dir,
                jax=jax_steps, jax_samples=jax_samples, samplers=samplers,
                generation_clis=[r[n_dp + len(dp_samplers):] for r in dp_results])


def _assert_grads_close(got, want, frac, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        err = float((got[name] - w).abs().max())
        assert err <= frac * float(w.abs().max()), (what, name, err,
                                                    float(w.abs().max()))


def test_data_parallel_two_ranks_match_one_rank(rank_runs):
    """DP over 2 ranks at dropout 0 against one rank on the same global
    batch: the loss (the mean over `data`) and every averaged, clipped
    gradient within 1e-6 relative."""
    losses, grads = _one_rank("decoder", rank_runs["encoder"],
                              rank_runs["batches"][:1])
    dp = rank_runs["dp"]
    assert dp[0]["losses"] == dp[1]["losses"]
    np.testing.assert_allclose(dp[0]["losses"], losses, rtol=1e-6)
    _assert_grads_close(dp[0]["grads"], grads, 1e-6, "DP 2 ranks")


def _jax_mesh_step(kind, encoder, x):
    """JAX's (2, 2) mesh step on the first batch (its params sharded by
    params_shardings, the batch by shard_batch, the CPU attention route):
    the loss and the clipped gradients (optax.clip_by_global_norm(5), the
    trainer's chain), converted to the port's names. The frozen encoder's
    codes are the port's, on the CPU (held against JAX's in
    test_torch_generation.py)."""
    jmod, params, _, to_port = model_pair(kind)
    with torch.no_grad():
        _, indices, _ = encoder.eval()(torch.from_numpy(x))
    codes = merge_codes(indices, CODEBOOK).numpy().astype(np.int32)
    mesh = _jax_mesh(2, n_devices=4)
    with JAX_RUN:
        args = (jmesh.shard_params(params, mesh),
                *jmesh.shard_batch({"s": codes, "t": x.astype(np.int32)},
                                   mesh).values())

    def loss_fn(p, s, t):
        if kind == "decoder":
            return jmod.apply({"params": p}, s, t, training=True,
                              rngs={"dropout": KEY})["loss"]
        return jmod.apply({"params": p}, s, training=True,
                          rngs={"dropout": KEY})["loss"]

    step = jax.jit(jax.value_and_grad(loss_fn)).lower(*args).compile()
    with JAX_RUN:
        loss, grads = step(*args)
        return float(loss), to_port(jax.device_get(_clipped(grads)))


@pytest.mark.parametrize("kind", ["decoder", "prior"])
def test_mesh_trainer_step_matches_jax_mesh_step(rank_runs, kind):
    """A (2, 2) DecoderTrainer / PriorTrainer step over 4 gloo ranks at
    dropout 0 against JAX's step on a (2, 2) mesh: the loss within 1e-5
    relative, every gathered, clipped gradient within 1e-5 of its largest
    |value| (gradients, not parameters after Adam, whose first update is
    about +-lr for any gradient); every rank reports the same losses, and
    the model axis ran (the attention through the K7 wrappers' plain
    versions)."""
    result = rank_runs[kind]
    loss, grads = rank_runs["jax"][kind]
    np.testing.assert_allclose(result["losses"][0], loss, rtol=1e-5)
    _assert_grads_close(result["grads"], grads, 1e-5, f"{kind} (2, 2)")
    index = 0 if kind == "decoder" else 1
    assert all(r[index]["losses"] == result["losses"] for r in rank_runs["tp_others"])
    assert result["losses"][1] != result["losses"][0]


def test_heads_that_do_not_divide_the_model_axis(rank_runs):
    """A 2-head prior over a (1, 4) mesh: its attention runs whole on every
    rank at the data shard's offsets, its out_proj row-parallel on this
    rank's columns (split_to_model), the FFN and the head split; the loss
    and every clipped gradient within 1e-6 relative of one rank's."""
    losses, grads = _one_rank("prior", rank_runs["encoder"],
                              rank_runs["batches"][:1], _two_head_prior())
    result = rank_runs["two_heads"]
    np.testing.assert_allclose(result["losses"], losses, rtol=1e-6)
    _assert_grads_close(result["grads"], grads, 1e-6, "2 heads over (1, 4)")


def test_mesh_slot_loads_on_one_rank_with_equal_eval_loss(rank_runs):
    """The overfitted slot the (2, 2) run wrote (rank 0, from the gathered
    blocks) is the one-GPU layout: a one-rank trainer loads it, model,
    Adam's moments and step, and its eval loss equals the mesh's."""
    import copy
    trainer = DecoderTrainer(copy.deepcopy(rank_runs["encoder"]),
                             copy.deepcopy(model_pair("decoder")[2]), CODEBOOK,
                             device="cpu", model_dir=rank_runs["slot_dir"],
                             mesh=pmesh.Mesh(1, 1)).init_state(1e-3)
    trainer.load(early_stopped=False)
    assert trainer.step == 2 and trainer.optimizer.count == 2
    got = float(trainer.eval_step(rank_runs["batches"][0])["loss"])
    np.testing.assert_allclose(got, rank_runs["decoder"]["eval_loss"], rtol=1e-6)
    state = torch.load(os.path.join(rank_runs["slot_dir"], "overfitted", "state.pt"),
                       weights_only=True)
    assert len(state["generators_by_rank"]) == 4


# ---- the encoder side: VQ-CPC and the student over ranks -------------------------

EMB, HIDDEN, Z = 8, 16, 8
BLOCK, BLOCKS, NUM_NEG = 16, 2, 3     # 4 ticks x 4 voices a block
CPC_BATCH = STUDENT_BATCH = 4
NUM_MASKED = 2
STUDENT_RNG = jax.random.PRNGKey(7)
# the masked event of JAX's student step with STUDENT_RNG (student_trainer.py:
# 185-186), given to the port's ranks in place of their draws
STUDENT_INDEX = int(jax.random.randint(jax.random.split(STUDENT_RNG, 4)[0], (), 0,
                                       NUM_EVENTS))


def _tokens(rng, shape):
    return np.stack([rng.randint(0, v, size=shape) for v in VOCABS],
                    axis=-1).astype(np.int32)


def _cpc_batch(seed):
    """A global VQ-CPC batch: 2 + 2 blocks, 3 negatives of 2 blocks a row."""
    rng = np.random.RandomState(seed)
    ticks = BLOCKS * BLOCK // 4
    return {"x_left": _tokens(rng, (CPC_BATCH, ticks)),
            "x_right": _tokens(rng, (CPC_BATCH, ticks)),
            "negative_samples": _tokens(rng, (CPC_BATCH, NUM_NEG, BLOCKS, BLOCK // 4))}


CPC_BATCHES = [_cpc_batch(s) for s in (20, 21)]
STUDENT_BATCHES = [_tokens(np.random.RandomState(s), (STUDENT_BATCH, NUM_EVENTS))
                   for s in (22, 23)]


def _cpc_models(kind):
    """The JAX and the port VQCPCModel: a 1-layer bidirectional GRU
    downscaler of width 16 over blocks of 16 tokens, the BatchNorm ("bn")
    or EMA ("ema") product quantizer (8 x 3), the MLP upscaler, a 1-layer
    CModule (random init)."""
    def jax_quantizer_():
        if kind == "ema":
            return jax_quantizer.EMAProductVectorQuantizer(
                codebook_size=CODEBOOK, codebook_dim=3, commitment_cost=0.25,
                num_codebooks=1, ema_decay=0.99)
        return jax_quantizer.ProductVectorQuantizer(
            codebook_size=CODEBOOK, codebook_dim=3, commitment_cost=0.25,
            num_codebooks=1, use_batch_norm=True)

    events = 2 * BLOCKS * BLOCK // 4
    jmodel = jax_cpc.VQCPCModel(
        encoder=JaxEncoder(
            data_processor=JaxCPCProcessor(
                embedding_size=EMB, num_events=events, num_tokens_per_channel=VOCABS,
                num_tokens_per_block=BLOCK),
            downscaler=jax_downscalers.GruDownscaler(
                output_dim=3, downscale_factors=[BLOCK], hidden_size=HIDDEN,
                num_layers=1, dropout=0.0, bidirectional=True),
            quantizer=jax_quantizer_(),
            upscaler=JaxMlpUpscaler(output_dim=Z, hidden_size=HIDDEN, dropout=0.0)),
        c_module=jax_cpc.CModule(hidden_size=HIDDEN, output_dim=Z, num_layers=1,
                                 dropout=0.0),
        fks_module=jax_cpc.FksModule(z_dim=Z, c_dim=Z, k_max=BLOCKS),
        quantization_weighting=0.5)
    quantizer = (EMAProductVectorQuantizer(CODEBOOK, 3, 0.25, 1, ema_decay=0.99)
                 if kind == "ema" else
                 ProductVectorQuantizer(CODEBOOK, 3, 0.25, 1, use_batch_norm=True))
    port = cpc.VQCPCModel(
        Encoder(BachCPCDataProcessor(EMB, events, VOCABS, num_tokens_per_block=BLOCK),
                GruDownscaler(EMB, 3, [BLOCK], HIDDEN, 1, 0.0, bidirectional=True),
                quantizer, MlpUpscaler(3, Z, HIDDEN, 0.0)),
        cpc.CModule(Z, HIDDEN, Z, 1, 0.0), cpc.FksModule(Z, Z, BLOCKS),
        quantization_weighting=0.5)
    return jmodel, port


def _spread_rows(z, seed=0):
    """CODEBOOK rows of the latents z (n, 3), (1, CODEBOOK, 3)."""
    rows = z[torch.from_numpy(np.random.RandomState(seed).permutation(len(z))[:CODEBOOK])]
    return rows.detach()[None].clone()


@functools.lru_cache(maxsize=None)
def cpc_pair():
    """(the JAX BatchNorm VQCPCModel, its seeded-fill params, its
    collections (running mean 0, variance 1), the port model with them): the
    codebook is rows of the batch-normalised latents of CPC_BATCHES[0]'s
    negatives, so the codes spread."""
    jmodel, port = _cpc_models("bn")
    batch = {k: jnp.asarray(v) for k, v in CPC_BATCHES[0].items()}
    shapes = jax.eval_shape(jmodel.init, KEY, batch)
    params = jax.tree.map(np.asarray, _fill(shapes["params"], 6))
    collections = {k: jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones if path[-1].key == "var" else np.zeros)(
            leaf.shape, np.float32), v)
        for k, v in shapes.items() if k != "params"}
    port.load_state_dict(convert.vqcpc_state_dict(params, collections), strict=True)
    with torch.no_grad():
        neg = torch.from_numpy(CPC_BATCHES[0]["negative_samples"])
        z = port.encoder.downscale(neg.reshape((-1,) + neg.shape[3:]),
                                   training=False).reshape(-1, 3)
        bn = port.encoder.quantizer.batch_norm
        z = ((z - z.mean(0)) / torch.sqrt(z.var(0, unbiased=False) + bn.eps)
             * bn.weight + bn.bias)
        codebooks = _spread_rows(z)
    port.encoder.quantizer.set_codebooks(codebooks)
    params["encoder"]["quantizer"]["codebooks"] = codebooks.numpy()
    return jmodel, (params, collections), port


def _ema_port_model():
    torch.manual_seed(8)
    return _cpc_models("ema")[1]


def _student_modules():
    """The JAX and the port encoder (the linear relative-transformer
    downscaler, factors [4, 4], d_model 32, 2 heads, 1 layer a stage; the
    commitment quantizer), teacher (1 layer) and relative auxiliary decoder
    (1 layer a stage): under a model axis of 2 the heads of vocabularies 6
    and 8 split."""
    kw = dict(d_model=32, n_head=2, dim_feedforward=48, dropout=0.0)
    aux_kw = dict(num_tokens_per_channel=VOCABS, codebook_dim=3, upscale_factors=[4, 4],
                  list_of_num_layers=[1, 1], num_tokens_bottleneck=NUM_CODES, **kw)
    jmods = (
        JaxEncoder(data_processor=JaxProcessor(embedding_size=EMB, num_events=NUM_EVENTS,
                                               num_tokens_per_channel=VOCABS),
                   downscaler=jax_downscalers.RelativeTransformerDownscalerLinear(
                       output_dim=3, downscale_factors=[4, 4], num_channels=4,
                       list_of_num_layers=[1, 1], positional_embedding_size=4, **kw),
                   quantizer=jax_quantizer.ProductVectorQuantizer(
                       codebook_size=CODEBOOK, codebook_dim=3, commitment_cost=0.25,
                       num_codebooks=1)),
        JaxTeacher(data_processor=JaxProcessor(embedding_size=EMB, num_events=NUM_EVENTS,
                                               num_tokens_per_channel=VOCABS),
                   num_layers=1, num_tokens_per_channel=VOCABS,
                   positional_embedding_size=4, num_tokens=NUM_EVENTS * 4, **kw),
        jax_aux.AuxiliaryDecoderRelative(**aux_kw))
    mods = (
        Encoder(BachDataProcessor(EMB, NUM_EVENTS, VOCABS),
                downscalers.RelativeTransformerDownscalerLinear(
                    EMB, 3, [4, 4], 4, 32, 2, [1, 1], 48, 0.0,
                    positional_embedding_size=4),
                ProductVectorQuantizer(CODEBOOK, 3, 0.25, 1)),
        TeacherRelative(BachDataProcessor(EMB, NUM_EVENTS, VOCABS), 1, VOCABS, 4, 32,
                        48, 2, NUM_EVENTS * 4, 0.0),
        auxiliary_decoder.AuxiliaryDecoderRelative(**aux_kw))
    return jmods, mods


@functools.lru_cache(maxsize=None)
def student_pair():
    """(the JAX encoder, teacher and auxiliary decoder, their params in the
    JAX trainer's four groups (seeded fill), the port modules with them):
    the codebook is rows of STUDENT_BATCHES[0]'s latents."""
    jmods, mods = _student_modules()
    jenc, jteacher, jaux = jmods
    x = jnp.asarray(STUDENT_BATCHES[0])
    rngs = {"params": KEY, "dropout": KEY}
    masked, _ = jax_student.mask_batch(x, jnp.int32(0), NUM_MASKED, VOCABS)
    embedded = jax.ShapeDtypeStruct((STUDENT_BATCH, NUM_EVENTS, 4, EMB), jnp.float32)
    z = jax.ShapeDtypeStruct((STUDENT_BATCH, NUM_CODES, 3), jnp.float32)
    params = {
        "encoder": _fill(jax.eval_shape(jenc.init, rngs, x)["params"], 7, 0.2),
        "teacher": _fill(jax.eval_shape(jteacher.init, rngs, embedded)["params"], 8, 0.2),
        "auxiliary_decoder": _fill(jax.eval_shape(jaux.init, rngs, z)["params"], 9, 0.2),
        "teacher_data_processor": _fill(jax.eval_shape(
            jteacher.data_processor.init, rngs, masked)["params"], 10, 0.2)}
    params = jax.tree.map(np.asarray, params)
    model = torch.nn.ModuleDict(dict(zip(
        ("encoder", "teacher", "auxiliary_decoder"), mods)))
    model.load_state_dict(convert.student_state_dict(params), strict=True)
    with torch.no_grad():
        codebooks = _spread_rows(mods[0].downscale(
            torch.from_numpy(STUDENT_BATCHES[0]), training=False).reshape(-1, 3))
    mods[0].quantizer.set_codebooks(codebooks)
    params["encoder"]["quantizer"]["codebooks"] = codebooks.numpy()
    return jmods, params, mods


def _encoder_job(kind, model, batches, num_model, **extra):
    """A train_over_mesh payload of the VQ-CPC or the student (copies of
    `model`), lr 1e-3 on the CPU."""
    import copy
    job = dict(kind=kind, model=copy.deepcopy(model), batches=batches, lr=1e-3,
               device="cpu", num_model=num_model, **extra)
    if kind == "student":
        job.update(num_events_masked=NUM_MASKED, quantization_weighting=0.1)
    return job


@functools.lru_cache(maxsize=None)
def _two_rank_jobs():
    """The encoder-side jobs of the 2-rank launch, by name, each with its
    codebook init: the BatchNorm VQ-CPC from the global batches (the init's
    permutation given), the EMA VQ-CPC and the student with each rank fed
    only its rows, and the student from the global batches (their
    permutations drawn from the seed's generator)."""
    perm = np.random.RandomState(3).permutation(CPC_BATCH * NUM_NEG * BLOCKS)
    return {
        "vqcpc bn": _encoder_job("vqcpc", cpc_pair()[2], CPC_BATCHES, 1,
                                 perms=[perm], eval_batch=CPC_BATCHES[1]),
        "vqcpc ema local": _encoder_job("vqcpc", _ema_port_model(), CPC_BATCHES, 1,
                                        local=True),
        "student": _encoder_job("student", student_pair()[2], STUDENT_BATCHES, 1),
        "student local": _encoder_job("student", student_pair()[2],
                                      STUDENT_BATCHES[:1], 1, local=True)}


def _grads_kept():
    """An optax transformation whose updates are zeros and whose state
    becomes the gradients it is given: after one JAX train step with it,
    the opt_state holds the step's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads),
                                           grads))


def _clipped(grads):
    clip = optax.clip_by_global_norm(5.0)
    return clip.update(grads, clip.init(grads))[0]


def _jax_cpc_mesh_step():
    """JAX's VQ-CPC train step (its trainer's jitted step, the optimizer
    replaced by _grads_kept) on a (2, 2) mesh, CPC_BATCHES[0] sharded over
    `data`: the metrics and the clipped gradients (the trainer's chain),
    converted to the port's names."""
    jmodel, (params, collections), _ = cpc_pair()
    mesh = _jax_mesh(2, n_devices=4)
    kept = _grads_kept()
    with JAX_RUN:
        trainer = JaxCPCTrainer(model_dir="unused", dataloader_generator=None,
                                model=jmodel, mesh=mesh)
        trainer.tx = kept
        trainer._build_steps()
        args = (jmesh.place_state(TrainState(params=params, opt_state=kept.init(params),
                                             batch_stats=collections, step=0), mesh),
                jmesh.shard_batch(CPC_BATCHES[0], mesh), KEY)
    step = trainer._train_step.lower(*args).compile()
    with JAX_RUN:
        new_state, metrics = step(*args)
        grads = jax.device_get(_clipped(new_state.opt_state))
        return jax.device_get(metrics), convert.vqcpc_state_dict(grads)


def _jax_student_mesh_step():
    """JAX's student train step (its trainer's jitted step, both optimizers
    replaced by _grads_kept) on a (2, 2) mesh, STUDENT_BATCHES[0] sharded
    over `data`, the masked event drawn from STUDENT_RNG: the metrics and
    each group's gradients clipped by its own global norm (two clipped
    Adams), converted to the port's names."""
    (jenc, jteacher, jaux), params, _ = student_pair()
    mesh = _jax_mesh(2, n_devices=4)
    kept = _grads_kept()
    groups = {"teacher": ("teacher", "teacher_data_processor"),
              "encdec": ("encoder", "auxiliary_decoder")}
    with JAX_RUN:
        trainer = jax_student.StudentEncoderTrainer(
            model_dir="unused", dataloader_generator=None, encoder=jenc,
            teacher=jteacher, auxiliary_decoder=jaux, num_events_masked=NUM_MASKED,
            quantization_weighting=0.1, mesh=mesh)
        trainer.tx_teacher = trainer.tx_encdec = kept
        trainer._build_steps()
        args = (jmesh.place_state(TrainState(
                    params=params, batch_stats={}, step=0,
                    opt_state={g: kept.init({k: params[k] for k in keys})
                               for g, keys in groups.items()}), mesh),
                jmesh.shard_batch(STUDENT_BATCHES[0], mesh), STUDENT_RNG)
    step = trainer._train_step.lower(*args).compile()
    with JAX_RUN:
        new_state, metrics = step(*args)
        grads = {}
        for g in groups:
            grads.update(jax.device_get(_clipped(new_state.opt_state[g])))
        return jax.device_get(metrics), convert.student_state_dict(grads)


@pytest.mark.parametrize("kind", ["vqcpc", "student"])
def test_encoder_side_mesh_step_matches_jax_mesh_step(rank_runs, kind):
    """A (2, 2) VQCPCEncoderTrainer step (GRU downscaler, BatchNorm
    quantizer) and StudentEncoderTrainer step (relative auxiliary decoder:
    the teacher's and the auxiliary decoder's heads of vocabularies 6 and 8
    split over `model`) on 4 gloo ranks against JAX's trainer steps on a
    (2, 2) mesh: the losses within 1e-5 relative, every gathered clipped
    gradient within 1e-5 of its largest |value|; every rank reports the
    same losses; the second step moved the loss."""
    result = rank_runs[kind]
    want, grads = rank_runs["jax"][kind]
    names = (("loss", "loss_quantize", "loss_contrastive") if kind == "vqcpc" else
             ("loss_teacher", "loss_quantization", "loss_reconstruction",
              "loss_encdec"))
    for name in names:
        np.testing.assert_allclose(result["metrics"][0][name], float(want[name]),
                                   rtol=1e-5, err_msg=name)
    _assert_grads_close(result["grads"], grads, 1e-5, f"{kind} (2, 2)")
    index = 3 if kind == "vqcpc" else 4
    assert all(r[index]["losses"] == result["losses"] for r in rank_runs["tp_others"])
    assert result["losses"][1] != result["losses"][0]
    if kind == "student":
        assert all(m == STUDENT_INDEX for r in [result] + [
            o[index] for o in rank_runs["tp_others"]] for m in r["masked"])


@functools.lru_cache(maxsize=None)
def _one_rank_job(name):
    """_two_rank_jobs()[name] on one rank in this process, the whole
    global batches."""
    import copy
    job = copy.deepcopy(_two_rank_jobs()[name])
    job.pop("local", None)
    return run_job(job, pmesh.Mesh(1, 1))


def _rel_close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, err_msg=what)


@pytest.mark.parametrize("name", ["vqcpc bn", "vqcpc ema local", "student"])
def test_encoder_side_two_ranks_match_one_rank(rank_runs, name):
    """Over (2, 1) at dropout 0 against one rank on the same global batches
    (the EMA job's ranks each fed only their rows): both ranks report the
    same losses, within 1e-5 relative of one rank's, and every clipped
    gradient within 1e-5 of its largest |value|; the quantizer's buffers
    after the steps (BatchNorm running statistics, the EMA cluster_size,
    ema_sums and codebooks) within 1e-5 relative; the VQ-CPC's
    codebook_perplexity and used-codeword counts equal to one rank's on the
    whole batch; the student's masked event the same on both ranks, one
    rank's draws."""
    ranks = rank_runs["two_ranks"][name]
    want = _one_rank_job(name)
    got = ranks[0]
    assert ranks[1]["losses"] == got["losses"]
    _rel_close(got["losses"], want["losses"], 1e-5, f"{name} losses")
    _assert_grads_close(got["grads"], want["grads"], 1e-5, name)
    assert want["buffers"][0] or name == "student"
    for step, (g, w) in enumerate(zip(got["buffers"], want["buffers"])):
        for key, value in w.items():
            _rel_close(g[key], value, 1e-5, f"{name} {key}, step {step}")
    if name.startswith("vqcpc"):
        for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for metric in ("codebook_perplexity", "num_codewords",
                           "num_codewords_negative"):
                assert g[metric] == w[metric], (name, step, metric)
            assert w["num_codewords"] > 2
    else:
        assert ranks[1]["masked"] == got["masked"] == want["masked"]
    if name == "vqcpc bn":
        _rel_close(got["eval_loss"], want["eval_loss"], 1e-5, "eval loss")


@pytest.mark.parametrize("name", ["vqcpc bn", "vqcpc ema local", "student",
                                  "student local"])
def test_codebook_init_is_one_ranks_on_every_rank(rank_runs, name):
    """The codebooks after init_state are the same on both ranks, bit for
    bit, and equal to one rank's init on the whole batch with the same
    permutations (given, or drawn from the seed's generator), also where
    each rank was given only its own rows (the init batch gathered over
    `data`)."""
    ranks = rank_runs["two_ranks"][name]
    want = _one_rank_job(name)["init_codebooks"]
    assert set(ranks[0]["init_codebooks"]) == set(want)
    for key, value in want.items():
        assert torch.equal(ranks[0]["init_codebooks"][key],
                           ranks[1]["init_codebooks"][key]), key
        assert torch.equal(ranks[0]["init_codebooks"][key], value), key


def test_local_rows_step_equals_the_global_batch_step(rank_runs):
    """With each rank passing only its rows (shard_batch_local), both ranks
    report the same VQ-CPC loss, within 1e-6 relative of one rank's step on
    the whole batch (JAX's tests/multihost_worker.py bound); and the ranks
    started through maybe_initialize's coordinator path."""
    ranks = rank_runs["two_ranks"]["vqcpc ema local"]
    want = _one_rank_job("vqcpc ema local")
    assert ranks[0]["losses"] == ranks[1]["losses"]
    _rel_close(ranks[0]["losses"][0], want["losses"][0], 1e-6, "local rows")
    assert all(r["coordinator"].startswith("127.0.0.1:") for r in rank_runs["cli"])


def _cli_job(workdir):
    """The 2-rank launch's main_encoder -t on tests/configs/encoder_smoke.py
    (in `workdir`, the corpus cached there)."""
    import shutil
    shutil.copy(os.path.join(os.path.dirname(__file__), "configs", "encoder_smoke.py"),
                workdir / "encoder_smoke.py")
    return dict(kind="cli", cli="main_encoder", workdir=str(workdir),
                cache_root=str(workdir / "data"),
                argv=["-t", "-c", "encoder_smoke.py", "--device", "cpu"])


def test_encoder_cli_on_two_ranks_writes_one_slot(rank_runs, monkeypatch, capsys):
    """main_encoder -t over 2 gloo ranks on the CPU: one model directory,
    whose overfitted slot is the one-GPU layout (a one-rank trainer loads
    it strictly, both ranks' generators kept); -l from it on one process
    exits 0, and the slot's model gives the trained epoch's val loss again
    (metrics.jsonl, within 1e-5 relative)."""
    import glob
    import json
    from vqcpcb_tpu_torch import main_encoder
    from vqcpcb_tpu_torch.data import dataset as port_dataset
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.utils import load_config_module
    assert [r["exit"] for r in rank_runs["cli"]] == [0, 0]
    workdir = rank_runs["cli_dir"]
    (model_dir,) = glob.glob(str(workdir / "models" / "encoder_smoke_*"))
    state = checkpoints.load_state(model_dir, early_stopped=False)
    assert len(state["generators_by_rank"]) == 2
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(workdir / "data"))
    config_path = os.path.join(model_dir, "config.py")
    assert main_encoder.main(["-l", "-c", config_path, "--device", "cpu"]) == 0
    assert "Nearest neighbours list:" in capsys.readouterr().out
    config = load_config_module(config_path)
    trainer, loaders = main_encoder.build_encoder_trainer(config, "cpu", model_dir,
                                                          pmesh.Mesh(1, 1))
    loaders.reseed(0)
    train, val, _ = loaders.dataloaders(batch_size=config["batch_size"])
    # the epoch's train batches first, as the loop drew them before val
    train = [next(train) for _ in range(config["num_batches"])]
    trainer.init_state(train[0], lr=config["lr"], initialize=False)
    trainer.load(early_stopped=False)
    assert trainer.step == config["num_batches"]
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    got = trainer.epoch(val, False, config["num_batches"] // 2)["loss"]
    _rel_close(got, row["loss/val"], 1e-5, "reloaded val loss")


# ---- start-up and batches -------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"VQCPCB_DISTRIBUTED": "1"}, dict(init_method="env://")),
    ({"VQCPCB_COORDINATOR": "10.0.0.2:1234", "VQCPCB_NUM_PROCESSES": "4",
      "VQCPCB_PROCESS_ID": "3"},
     dict(init_method="tcp://10.0.0.2:1234", world_size=4, rank=3)),
    ({"VQCPCB_COORDINATOR": "10.0.0.2:1234"}, ValueError),
])
def test_maybe_initialize_reads_the_environment(monkeypatch, env, want):
    """maybe_initialize, init_process_group replaced: a no-op returning
    False without the variables; torchrun's env:// with VQCPCB_DISTRIBUTED=1;
    tcp://host:port with the world size and rank from the VQCPCB_* trio
    (which needs all three); gloo for the CPU, and always a timeout."""
    calls = []
    for name in ("VQCPCB_COORDINATOR", "VQCPCB_DISTRIBUTED",
                 "VQCPCB_NUM_PROCESSES", "VQCPCB_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    if want is ValueError:
        with pytest.raises(ValueError):
            distributed.maybe_initialize("cpu")
        return
    joined = distributed.maybe_initialize("cpu")
    assert joined == (want is not None)
    if want is None:
        assert calls == []
        return
    assert len(calls) == 1 and calls[0]["backend"] == "gloo"
    assert calls[0]["timeout"] == distributed.DEFAULT_TIMEOUT
    assert {k: calls[0][k] for k in want} == want


def test_shard_batch_rows_replication_and_the_local_twin():
    """shard_batch keeps this rank's block of rows and the whole of a leaf
    that does not divide the data axis; shard_batch_local raises on a
    scalar leaf; a one-rank mesh outside a process group; a collective on
    a simulated mesh raises."""
    x = np.arange(24).reshape(8, 3)
    mesh = pmesh.simulated_mesh(4, 2, 5)                 # data index 2
    out = pmesh.shard_batch({"x": x, "odd": x[:6], "s": np.float32(1.0)}, mesh)
    np.testing.assert_array_equal(out["x"], x[4:6])
    np.testing.assert_array_equal(out["odd"], x[:6])
    assert out["s"] == 1.0
    with pytest.raises(ValueError):
        pmesh.shard_batch_local({"s": np.float32(1.0)}, mesh)
    np.testing.assert_array_equal(pmesh.shard_batch_local({"x": x}, mesh)["x"], x)
    assert pmesh.make_mesh() == pmesh.Mesh(1, 1)
    with pytest.raises(ValueError):
        pmesh.make_mesh(num_model=2)
    from vqcpcb_tpu_torch.parallel.collectives import all_reduce_
    with pytest.raises(RuntimeError):
        all_reduce_(torch.zeros(2), mesh, pmesh.MODEL_AXIS)


def test_search_margins_measure_near_ties():
    """torch_mesh_harness.search_margins: the gap between the best and the
    second-best squared distance over |x|^2 + the largest |e|^2, 0 at an
    exact tie, and a row whose code the harness may pin only below
    CODE_TIE_REL."""
    from torch_mesh_harness import CODE_TIE_REL, search_margins
    codebooks = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [3.0, 3.0]]])   # (1, 3, 2)
    d = 2.0 ** -20                                      # exact in f32
    x = torch.tensor([[[0.5, 0.5]], [[1.0, 0.0]], [[0.5, 0.5 + d]]])    # (3, 1, 2)
    margins = search_margins(x, codebooks)
    assert margins.shape == (3, 1) and margins.dtype == torch.float64
    # |x - e|^2: a tie 0.5 / 0.5; 0 / 2 over 1 + 18; the tie moved by 2d
    np.testing.assert_allclose(
        margins[:, 0].numpy(),
        [0.0, 2.0 / 19.0, 2 * d / (0.25 + (0.5 + d) ** 2 + 18.0)], rtol=1e-12, atol=1e-15)
    assert (margins[[0, 2], 0] <= CODE_TIE_REL).all() and margins[1, 0] > CODE_TIE_REL
    codes = vk.nearest_codebook_indices(x, codebooks)
    assert codes[1, 0] == 0 and codes[2, 0] == 1


@pytest.mark.parametrize("env,want", [(None, torch.bfloat16), ("1", torch.bfloat16),
                                      ("0", torch.float32)])
def test_training_dot_dtype_reads_the_jax_knob(monkeypatch, env, want):
    """VQCPCB_PALLAS_BF16_DOTS, read where JAX reads it
    (pallas_attention.py:_dots_dtype): bf16 dots on the card unless it is
    "0"; the CPU's plain versions always take f32."""
    from vqcpcb_tpu_torch.utils import train_dot_dtype
    if env is None:
        monkeypatch.delenv("VQCPCB_PALLAS_BF16_DOTS", raising=False)
    else:
        monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", env)
    assert train_dot_dtype(torch.device("cuda", 0)) == want
    assert train_dot_dtype("cpu") == torch.float32
    assert jpa._dots_dtype() == (jnp.bfloat16 if want == torch.bfloat16
                                 else jnp.float32)


# ---- the samplers over ranks ---------------------------------------------------------

SAMPLE_RNG = np.random.RandomState(9)
SAMPLE_CODES = SAMPLE_RNG.randint(0, CODEBOOK, (BATCH, NUM_CODES)).astype(np.int64)
SAMPLE_WINDOW = SAMPLE_RNG.randint(0, CODEBOOK, (BATCH, NUM_CODES)).astype(np.int64)
SAMPLE_ZEROS = np.zeros((BATCH, NUM_EVENTS, 4), np.int64)
PRIOR_START = 2                 # the prior's window sampled after a prefill


def _sample_decoder(kind, num_model, **kw):
    job = dict(kind="sample_decoder", model=model_pair(kind)[2], source=SAMPLE_CODES,
               tokens_init=SAMPLE_ZEROS, start=0, num_steps=NUM_EVENTS * 4,
               device="cpu", num_model=num_model)
    job.update(kw)
    return job


def _sample_prior(num_model, **kw):
    job = dict(kind="sample_prior", model=model_pair("prior")[2],
               x_init=SAMPLE_WINDOW, start=PRIOR_START,
               num_steps=NUM_CODES - PRIOR_START, device="cpu", num_model=num_model)
    job.update(kw)
    return job


def _sampler_jobs(world):
    """The sampler jobs of a launch of `world` ranks, by name: greedy
    (top_k 1) and stochastic (T 1.0, top-p 0.9) flagship decoders, the
    greedy prior after a prefilled context and, on 4 ranks, the stochastic
    prior on a batch of 3 that does not divide the data axis (run whole on
    every rank) from position 0 (no prefill) over (2, 2), the GQA decoder
    (2 KV heads of 4) over (2, 2) (kv_proj split) and (1, 4) (replicated);
    on 2 ranks the greedy decoder from the encoder's codes of its rows."""
    num_model = 2 if world == 4 else 1
    stochastic = dict(temperature=1.0, top_p=0.9, seed=5)
    jobs = {"decoder greedy": _sample_decoder("decoder", num_model, top_k=1),
            "decoder stochastic": _sample_decoder("decoder", num_model, **stochastic),
            "prior greedy": _sample_prior(num_model, top_k=1)}
    if world == 4:
        jobs["prior stochastic replicated"] = _sample_prior(
            num_model, x_init=SAMPLE_WINDOW[:3], start=0, num_steps=NUM_CODES,
            temperature=1.0, seed=3)
        jobs["gqa greedy"] = _sample_decoder("gqa", 2, top_k=1)
        jobs["gqa greedy (1, 4)"] = _sample_decoder("gqa", 4, top_k=1)
    else:
        encoder, batches = _encoder_and_batches()
        job = _sample_decoder("decoder", 1, top_k=1, encoder=encoder,
                              templates=batches[0], codebook_size=CODEBOOK)
        job.pop("source")
        jobs["decoder greedy encoded"] = job
    return jobs


@functools.lru_cache(maxsize=None)
def _one_rank_sample(name, world):
    """_sampler_jobs(world)[name] on one rank in this process."""
    from torch_mesh_harness import sample_job
    return sample_job(_sampler_jobs(world)[name], pmesh.Mesh(1, 1))


def _jax_mesh_sample(kind):
    """JAX's greedy KV-cached sampler on a (4, 2) mesh, params sharded by
    params_shardings and the batch by shard_batch, as
    tests/test_multichip.py:391 runs it: the flagship decoder's
    sample_range from position 0 over SAMPLE_CODES, or the prior's
    sample_window from PRIOR_START over SAMPLE_WINDOW."""
    jmod, params, _, _ = model_pair(kind)
    mesh = _jax_mesh(2)
    with JAX_RUN:
        p = {"params": jmesh.shard_params(params, mesh)}
        if kind == "decoder":
            batch = jmesh.shard_batch({"s": SAMPLE_CODES.astype(np.int32),
                                       "t": SAMPLE_ZEROS.astype(np.int32)}, mesh)
            out = jmod.apply(p, batch["s"], batch["t"], jnp.int32(0), NUM_EVENTS * 4,
                             KEY, 1.0, 1, 0.0, method=JaxDecoder.sample_range)
        else:
            batch = jmesh.shard_batch({"x": SAMPLE_WINDOW.astype(np.int32)}, mesh)
            out = jmod.apply(p, batch["x"], PRIOR_START, NUM_CODES - PRIOR_START, KEY,
                             1.0, 1, method=JaxPrior.sample_window)
        return np.asarray(jax.device_get(out))


def _ranks_agree(ranks):
    """Every rank holds the same gathered tokens, and the model ranks of a
    data index the same local rows."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tokens"], ranks[0]["tokens"])
    by_rows = {}
    for r in ranks:
        by_rows.setdefault(r["rows"], []).append(r["local"])
    for local in by_rows.values():
        assert all(np.array_equal(x, local[0]) for x in local)
    return ranks[0]["tokens"]


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("kind", ["decoder", "prior"])
def test_mesh_greedy_sampler_matches_jax_mesh_and_one_rank(rank_runs, kind, world):
    """The flagship decoder's sample_range and the prior's sample_window,
    greedy, over (2, 2) (4 ranks: the heads, the FFN, the cross MLP and the
    vocabulary heads split over `model`, the batch of 8 over `data`) and
    (2, 1): exactly JAX's tokens on a (4, 2) mesh with shard_params, and
    the port's one-rank tokens; every rank holds the whole batch, the model
    ranks of a data index the same rows; on (2, 2) each rank's caches hold
    half the KV heads."""
    name = f"{kind} greedy"
    ranks = rank_runs["samplers"][(name, world)]
    got = _ranks_agree(ranks)
    want = rank_runs["jax_samples"][kind]
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(got, _one_rank_sample(name, world)["tokens"])
    assert ranks[0]["rows"] == (0, BATCH // 2, BATCH)
    heads = 2 if world == 4 else 4
    assert ranks[0]["cache_heads"] and all(h == heads for h in ranks[0]["cache_heads"])


@pytest.mark.parametrize("name,world", [("decoder stochastic", 4),
                                        ("decoder stochastic", 2),
                                        ("prior stochastic replicated", 4)])
def test_mesh_stochastic_sampler_matches_one_rank(rank_runs, name, world):
    """At T 1.0 (and top-p 0.9 for the decoder) over (2, 2) and (2, 1), from
    generators seeded seed + data_index put in rank 0's state
    (common_generator): exactly the one-rank run's tokens for the seed, the
    noise of each draw the global batch's; a batch of 3 runs whole on every
    data rank."""
    ranks = rank_runs["samplers"][(name, world)]
    got = _ranks_agree(ranks)
    np.testing.assert_array_equal(got, _one_rank_sample(name, world)["tokens"])
    rows = 3 if "replicated" in name else BATCH // 2
    assert ranks[0]["rows"][1] - ranks[0]["rows"][0] == rows


@pytest.mark.parametrize("name,heads", [("gqa greedy", 1), ("gqa greedy (1, 4)", 1)])
def test_mesh_gqa_sampler_matches_one_rank(rank_runs, name, heads):
    """The grouped decoder (2 KV heads of 4 query heads): over (2, 2) its
    kv_proj splits (one KV head a rank's caches), over (1, 4) it stays
    replicated and each rank caches the KV head of its one query head
    (_kv_mesh's pick); greedy tokens equal one rank's."""
    ranks = rank_runs["samplers"][(name, 4)]
    got = _ranks_agree(ranks)
    np.testing.assert_array_equal(got, _one_rank_sample(name, 4)["tokens"])
    assert all(h == heads for h in ranks[0]["cache_heads"])


def test_mesh_sampler_encodes_each_ranks_rows(rank_runs):
    """Over (2, 1) each rank encodes its rows of the templates (K1's route
    on the CPU) and samples them: the gathered codes and the greedy tokens
    equal one rank's on the whole batch."""
    ranks = rank_runs["samplers"][("decoder greedy encoded", 2)]
    want = _one_rank_sample("decoder greedy encoded", 2)
    got = _ranks_agree(ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["codes"], want["codes"])
    np.testing.assert_array_equal(got, want["tokens"])
    assert len(np.unique(want["codes"])) > 3


@pytest.mark.parametrize("total,n_data", [(8, 2), (8, 4), (3, 2), (8, 1)])
def test_sample_categorical_rows_draw_the_global_batchs_noise(total, n_data):
    """sample_categorical with rows: each data rank's draws (its rows of
    generation_rows) concatenated equal one draw over the whole batch from
    the same generator state, at any temperature and top-p; rows over the
    whole batch draw exactly what rows=None draws, which is the stream of
    torch.empty_like(logits).exponential_ (one rank's, unchanged)."""
    from vqcpcb_tpu_torch.ops.sampling import sample_categorical
    logits = torch.from_numpy(np.random.RandomState(total).randn(total, 11)
                              .astype(np.float32))
    want = sample_categorical(torch.Generator().manual_seed(4), logits, 0.9,
                              top_p=0.8)
    noise = torch.empty_like(logits).exponential_(
        generator=torch.Generator().manual_seed(4))
    from vqcpcb_tpu_torch.ops.sampling import top_k_top_p_filtering
    filtered = top_k_top_p_filtering(logits / 0.9, top_p=0.8)
    assert torch.equal(want, torch.argmax(filtered - noise.log(), dim=-1))
    parts = []
    for d in range(n_data):
        rows = pmesh.generation_rows(total, pmesh.simulated_mesh(n_data, 1, d))
        part = sample_categorical(torch.Generator().manual_seed(4), rows.of(logits),
                                  0.9, top_p=0.8, rows=rows)
        if not rows.split:
            assert torch.equal(part, want)
            continue
        parts.append(part)
    if parts:
        assert torch.equal(torch.cat(parts), want)


def _generation_cli_jobs(workdir):
    """The 2-rank launch's decoder and prior CLIs over tests/configs'
    decoder_smoke.py and prior_smoke.py (config_encoder an absolute copy of
    encoder_smoke.py: fresh encoder weights; fixed timestamps, so the model
    directories are models/decoder_smoke_mesh and models/prior_smoke_mesh):
    main_decoder -t, then -l -r --num_examples 1; main_prior -t, then -l -g
    through that decoder. Each runs on both ranks."""
    import shutil
    configs = os.path.join(os.path.dirname(__file__), "configs")
    shutil.copy(os.path.join(configs, "encoder_smoke.py"),
                workdir / "encoder_smoke_fresh.py")
    encoder = str(workdir / "encoder_smoke_fresh.py")
    decoder_dir = workdir / "models" / "decoder_smoke_mesh"
    for name, changes in (
            ("decoder_smoke.py", {"timestamp": "mesh"}),
            ("prior_smoke.py", {"timestamp": "mesh",
                                "config_decoder": str(decoder_dir / "config.py")})):
        text = open(os.path.join(configs, name)).read().replace(
            "os.path.join(os.path.dirname(__file__), 'encoder_smoke.py')", repr(encoder))
        for key, value in changes.items():
            text = text.replace(f"'{key}': None", f"'{key}': {value!r}")
        (workdir / name).write_text(text)

    def cli(module, *argv):
        return dict(kind="cli", cli=module, workdir=str(workdir),
                    cache_root=str(workdir / "data"), argv=[*argv, "--device", "cpu"])
    return [cli("main_decoder", "-t", "-c", "decoder_smoke.py"),
            cli("main_decoder", "-l", "-r", "--num_examples", "1", "-c",
                str(decoder_dir / "config.py")),
            cli("main_prior", "-t", "-c", "prior_smoke.py"),
            cli("main_prior", "-l", "-g", "-c",
                str(workdir / "models" / "prior_smoke_mesh" / "config.py"))]


def _read_scores(directory):
    """{file name: bytes} of the .json scores written under `directory`."""
    import glob
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(directory, "*.json")))}


def test_generation_clis_run_on_every_rank(rank_runs, monkeypatch):
    """main_decoder -l -r --num_examples 1 and main_prior -l -g over 2 gloo
    ranks (after -t on both): every call exits 0 on both ranks; rank 0
    wrote the re-harmonisations (3), the generations (the 3 originals and
    3 samples) and the prior's one score; one rank's -l -r --num_examples 1
    from the same slot writes the same re-harmonisations, byte for byte (the
    mesh samples the batch of 3 whole on each rank from rank 0's generator
    state)."""
    from vqcpcb_tpu_torch import main_decoder
    from vqcpcb_tpu_torch.data import dataset as port_dataset
    assert [[c["exit"] for c in r] for r in rank_runs["generation_clis"]] == [[0] * 4] * 2
    workdir = rank_runs["cli_dir"]
    decoder_dir = workdir / "models" / "decoder_smoke_mesh"
    mesh_scores = _read_scores(decoder_dir / "reharmonisations")
    assert len(mesh_scores) == 3
    assert len(_read_scores(decoder_dir / "generations")) == 6
    assert len(_read_scores(workdir / "models" / "prior_smoke_mesh" / "generations")) == 1
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(workdir / "data"))
    assert main_decoder.main(["-l", "-r", "--num_examples", "1", "-c",
                              str(decoder_dir / "config.py"), "--device", "cpu"]) == 0
    assert _read_scores(decoder_dir / "reharmonisations") == mesh_scores
