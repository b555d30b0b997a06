"""The port's (data, model) mesh against the JAX package's on the CPU
(vqcpcb_tpu_torch/parallel/, the K7 shard wrappers, the tensor-parallel
modules and the decoder and prior trainers over ranks).

The JAX side runs on conftest's 8 virtual CPU devices, its kernels in
interpret mode with f32 dots, as tests/test_multichip.py runs them. JAX
parameters come from jax.eval_shape and a seeded fill (no compiled init) and
reach the port through convert.py. The ranks of the port are processes over
gloo (parallel/launch.run_ranks, training through
torch_mesh_harness.train_over_mesh): every group has a process-group
timeout and a deadline, and is killed on failure."""
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu.ops import pallas_attention as jpa
from vqcpcb_tpu.parallel import mesh as jmesh
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
from vqcpcb_tpu_torch.ops import vq_kernels as vk
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.parallel import distributed
from vqcpcb_tpu_torch.parallel import mesh as pmesh
from vqcpcb_tpu_torch.parallel.launch import run_ranks
from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer

VOCABS = [7, 9, 6, 8]           # 6 and 8 split over 2 ranks, 8 over 4
NUM_EVENTS = 16                 # 64 target tokens from 4 codes
NUM_CODES = NUM_EVENTS * 4 // 16
CODEBOOK = 8
BATCH = 8
KEY = jax.random.PRNGKey(0)
LAUNCH = "torch_mesh_harness:train_over_mesh"
RANKS_TIMEOUT_S = 120


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


def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * noise
        return 0.3 * noise
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
    clipped gradients, the trainer."""
    import copy
    cls = DecoderTrainer if kind == "decoder" else PriorTrainer
    model = model_pair(kind)[2] if model is None else model
    trainer = cls(copy.deepcopy(encoder), copy.deepcopy(model),
                  CODEBOOK, device="cpu", mesh=pmesh.Mesh(1, 1)).init_state(1e-3)
    module = trainer.decoder if kind == "decoder" else trainer.prior
    losses, grads = [], None
    for batch in batches:
        losses.append(float(trainer.train_step(batch)["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    return losses, grads, trainer


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One group of 4 gloo ranks training the flagship decoder and the prior
    over a (2, 2) mesh (two steps each; the decoder's overfitted slot
    written), and one of 2 ranks training the decoder over (2, 1) (one
    step), started together; JAX's (2, 2) mesh steps are computed while
    they run."""
    encoder, batches = _encoder_and_batches()
    slot_dir = str(tmp_path_factory.mktemp("mesh_slot"))
    tp_jobs = [_job("decoder", encoder, batches, 2, slot_dir),
               _job("prior", encoder, batches, 2),
               _job("prior", encoder, batches[:1], 4, model=_two_head_prior())]
    dp_job = _job("decoder", encoder, batches[:1], 1)
    with ThreadPoolExecutor(2) as pool:
        tp = pool.submit(run_ranks, LAUNCH, 4, tp_jobs, timeout_s=RANKS_TIMEOUT_S)
        dp = pool.submit(run_ranks, LAUNCH, 2, dp_job, timeout_s=RANKS_TIMEOUT_S)
        jax_steps = {kind: _jax_mesh_step(kind, encoder, batches[0])
                     for kind in ("decoder", "prior")}
        tp_results, dp_results = tp.result(), dp.result()
    return dict(encoder=encoder, batches=batches, slot_dir=slot_dir,
                decoder=tp_results[0][0], prior=tp_results[0][1],
                two_heads=tp_results[0][2],
                tp_others=tp_results[1:], dp=dp_results, jax=jax_steps)


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
    losses, grads, _ = _one_rank("decoder", rank_runs["encoder"],
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
    sharded = jmesh.shard_params(params, mesh)
    batch = jmesh.shard_batch({"s": codes, "t": x.astype(np.int32)}, mesh)

    def loss_fn(p, s, t):
        if kind == "decoder":
            return jmod.apply({"params": p}, s, t, training=True,
                              rngs={"dropout": KEY})["loss"]
        return jmod.apply({"params": p}, s, training=True,
                          rngs={"dropout": KEY})["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded, batch["s"],
                                                       batch["t"])
    clip = optax.clip_by_global_norm(5.0)
    clipped, _ = clip.update(grads, clip.init(grads))
    return float(loss), to_port(jax.device_get(clipped))


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
    losses, grads, _ = _one_rank("prior", rank_runs["encoder"],
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
