"""The slice as a whole: the port's DecoderGenerator against the JAX
DecoderTrainer's generation (greedy, f32 caches), tokens exactly equal.

The JAX trainer is built as tests/test_generation.py builds one (synthetic
corpus, tiny encoder and AC/D/C decoder); its weights and vocabulary are
carried across with vqcpcb_tpu_torch.convert. The builders take the
decoder type, so tests/test_torch_absolute_decoder.py reuses them."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu import getters
from vqcpcb_tpu.training.decoder_trainer import DecoderTrainer
from vqcpcb_tpu.training.decoder_trainer import \
    compute_start_end_times as jax_compute_start_end_times
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.data.vocab import Vocabulary
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.training.decoder_trainer import (DecoderGenerator,
                                                       compute_start_end_times)
from vqcpcb_tpu_torch.training.decoder_trainer import \
    DecoderTrainer as PortDecoderTrainer

CODEBOOK = 8


def build_decoder_trainer(tmp_path, decoder_type="transformer_relative_diagonal"):
    enc_config = {
        "training_method": "vqcpc",
        "dataset": "synthetic",
        "corpus_kwargs": dict(num_chorales=5, min_beats=10, max_beats=14, seed=0),
        "data_processor_type": "bach_cpc",
        "data_processor_kwargs": dict(embedding_size=16),
        "downscaler_type": "lstm_downscaler",
        "downscaler_kwargs": dict(downscale_factors=[16], hidden_size=32,
                                  num_layers=1, dropout=0.0, bidirectional=True),
        "quantizer_type": "commitment",
        "quantizer_kwargs": dict(num_codebooks=1, codebook_size=CODEBOOK,
                                 codebook_dim=3, commitment_cost=0.25,
                                 use_batch_norm=False, squared_l2_norm=True),
        "upscaler_type": None,
    }
    cpc_gen = getters.get_dataloader_generator(
        dataset="synthetic", training_method="vqcpc",
        dataloader_generator_kwargs=dict(
            num_tokens_per_block=16, num_blocks_left=3, num_blocks_right=3,
            negative_sampling_method="same_sequence", num_negative_samples=5),
        config=enc_config, cache_root=str(tmp_path / "data"))
    encoder = getters.get_encoder(cpc_gen, enc_config)
    gen = getters.get_dataloader_generator(
        dataset="synthetic", training_method="decoder",
        dataloader_generator_kwargs=dict(sequences_size=4),
        config=enc_config, cache_root=str(tmp_path / "data"))
    data_processor = getters.get_data_processor(gen, "bach", dict(embedding_size=16))
    decoder = getters.get_decoder(
        gen, data_processor, encoder, enc_config, decoder_type,
        dict(d_model=32, n_head=2, num_encoder_layers=1, num_decoder_layers=1,
             dim_feedforward=48, positional_embedding_size=4, dropout=0.0))
    rng = jax.random.PRNGKey(0)
    x0 = next(gen.dataloaders(batch_size=4)[0])["x"]
    enc_vars = encoder.init(
        {"params": rng, "dropout": rng, "corrupt": rng, "corrupt_mask": rng},
        jnp.asarray(x0), training=False)
    # codebooks at the scale of the downscaler's outputs (its data-dependent
    # init), so the template's codes differ from block to block
    z = np.asarray(encoder.apply(enc_vars, jnp.asarray(x0),
                                 method=type(encoder).downscale)).reshape(-1, 3)
    params = jax.tree.map(np.asarray, enc_vars["params"])
    params["quantizer"]["codebooks"] = z[
        np.random.RandomState(0).permutation(len(z))[:CODEBOOK]][None]
    trainer = DecoderTrainer(
        model_dir=str(tmp_path / "decoder"), dataloader_generator=gen,
        decoder=decoder, encoder=encoder,
        encoder_variables={"params": params},
        codebook_size=CODEBOOK, num_codebooks=1)
    trainer.init_state(x0, lr=1e-3)
    return trainer, x0


def port_generator(trainer):
    """The port's DecoderGenerator with the trainer's weights, on the CPU."""
    vocab = trainer.dataloader_generator.dataset.vocabulary
    num_tokens = list(vocab.num_tokens_per_channel)
    jdec = trainer.decoder
    num_events = jdec.data_processor.num_events
    encoder = Encoder(
        BachCPCDataProcessor(16, num_events, num_tokens, num_tokens_per_block=16),
        GruDownscaler(16, 3, [16], 32, num_layers=1, dropout=0.0,
                      bidirectional=True),
        ProductVectorQuantizer(CODEBOOK, 3, 0.25, 1))
    encoder.load_state_dict(convert.encoder_state_dict(
        jax.device_get(trainer.encoder_variables["params"])), strict=True)
    decoder = Decoder(
        BachDataProcessor(16, num_events, num_tokens), "anticausal",
        d_model=32, num_encoder_layers=1, num_decoder_layers=1, n_head=2,
        dim_feedforward=48, positional_embedding_size=4,
        num_channels_encoder=1, num_events_encoder=jdec.num_events_encoder,
        num_channels_decoder=4, num_events_decoder=num_events,
        total_upscaling=jdec.total_upscaling, source_vocab_size=CODEBOOK,
        transformer_type=jdec.transformer_type,
        cross_attention_type=jdec.cross_attention_type)
    decoder.load_state_dict(convert.decoder_state_dict(
        jax.device_get(trainer.state.params)), strict=True)
    port_vocab = Vocabulary(note2index_dicts=vocab.note2index_dicts,
                            voice_ranges=vocab.voice_ranges)
    return DecoderGenerator(encoder, decoder, port_vocab, CODEBOOK,
                            device="cpu", seed=0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    trainer, x0 = build_decoder_trainer(tmp_path_factory.mktemp("gen"))
    return trainer, port_generator(trainer), np.asarray(x0)


def test_encode_codes_match_jax(pair):
    trainer, port, x0 = pair
    want = np.asarray(trainer._encode_codes(trainer.encoder_variables,
                                            jnp.asarray(x0)))
    got = port.encode_codes(x0).numpy()
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_generate_from_code_long_greedy_matches_jax(pair):
    """A sliding window over 9 codes (window of 4), two decodings, codes
    1..8, with meta symbols excluded: tokens exactly equal."""
    trainer, port, _ = pair
    codes = np.random.RandomState(1).randint(0, CODEBOOK, size=(1, 9)).astype(np.int32)
    kwargs = dict(temperature=1.0, top_k=1, num_decodings=2,
                  code_index_start=1, code_index_end=8,
                  exclude_meta_symbols=True, codes_per_window=2)
    want = trainer.generate_from_code_long(codes, **kwargs)
    got = port.generate_from_code_long(codes, **kwargs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generate_reharmonisation_greedy_matches_jax(pair, monkeypatch):
    """Re-harmonisation of a synthetic 20-event template: the JAX trainer
    reads the template from a score, so its tokenizer is replaced by one that
    returns the same tick grid; tokens exactly equal."""
    trainer, port, x0 = pair
    ticks = np.concatenate([x0[0], x0[1]])[:20]             # (events, voices)
    import vqcpcb_tpu.data.tokenizer as tokenizer
    monkeypatch.setattr(tokenizer, "score_to_ticks",
                        lambda score, vocab, subdivision: ticks.T)
    want = trainer.generate_reharmonisation(2, temperature=1.0, top_k=1,
                                            scores=[None])
    got = port.generate_reharmonisation(ticks[None], 2, temperature=1.0, top_k=1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (20, 4)
        np.testing.assert_array_equal(g, w)


def test_reharmonisation_excludes_meta_symbols(pair):
    trainer, port, x0 = pair
    outs = port.generate_reharmonisation(x0[0:1], 2, temperature=1.0,
                                         top_k=0, top_p=0.9,
                                         exclude_meta_symbols=True)
    forbidden = port._forbidden(True)
    for grid in outs:
        for c in range(4):
            assert not np.isin(grid[:, c], forbidden[c]).any()


@pytest.mark.parametrize("t,n,m", [(10, 24, 8), (0, 24, 8), (2, 24, 8),
                                   (23, 24, 8), (21, 24, 8), (5, 9, 4)])
def test_compute_start_end_times_matches_jax(t, n, m):
    assert compute_start_end_times(t, n, m) == jax_compute_start_end_times(t, n, m)


def test_generator_needs_the_card_unless_told_cpu(pair, monkeypatch):
    _, port, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderGenerator(port.encoder, port.decoder, port.vocabulary, CODEBOOK)


def test_train_step_matches_jax(pair):
    """One DecoderTrainer.train_step against the JAX trainer's train_step
    from the same weights and batch (frozen-encoder codes, f32, dropout 0,
    Adam lr 1e-3 with the clip), both on copies so the other tests keep
    their weights: loss to 1e-5 relative, and every parameter after the step
    within 1e-6 of JAX's -- or within 2 * lr where |grad| < 1e-5, since
    Adam's first step moves a weight by lr * g / (|g| + 1e-8), which is
    ill-conditioned there."""
    import copy
    trainer, port, x0 = pair
    lr = 1e-3
    ours = PortDecoderTrainer(copy.deepcopy(port.encoder), copy.deepcopy(port.decoder),
                          CODEBOOK, device="cpu", seed=0).init_state(lr)
    state = jax.tree.map(jnp.array, trainer.state)     # train_step donates it
    state, metrics = trainer._train_step(state, trainer.encoder_variables,
                                         jnp.asarray(x0), jax.random.PRNGKey(5))
    got = ours.train_step(x0)
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    want = convert.decoder_state_dict(jax.device_get(state.params))
    assert ours.step == 1
    for name, p in ours.decoder.named_parameters():
        small = p.grad.abs() < 1e-5
        err = (p.detach() - want[name]).abs()
        assert bool((err[~small] <= 1e-6).all()), (name, float(err[~small].max()))
        assert bool((err[small] <= 2 * lr).all()), name


def test_trainer_epoch_means_the_step_losses(pair):
    """DecoderTrainer.epoch over loader-style batches: the eval epoch's loss
    is eval_step's, num_batches caps a training epoch, and each trained
    batch is one optimizer step."""
    import copy
    _, port, x0 = pair
    ours = PortDecoderTrainer(copy.deepcopy(port.encoder), copy.deepcopy(port.decoder),
                              CODEBOOK, device="cpu").init_state(1e-3)
    batches = [{"x": x0}, {"x": x0[:2]}]
    evaluated = ours.epoch(batches, train=False)
    want = (ours.eval_step(x0)["loss"] + ours.eval_step(x0[:2])["loss"]) / 2
    np.testing.assert_allclose(evaluated["loss"], want.item(), rtol=1e-6)
    assert evaluated["tokens_per_sec"] > 0
    trained = ours.epoch(batches, train=True, num_batches=1)
    assert ours.step == 1 and np.isfinite(trained["loss"])
    assert ours.epoch([], train=True) == {}


def test_trainer_reharmonisation_from_a_score_matches_jax(pair, tmp_path):
    """The port DecoderTrainer's generate_reharmonisation from a synthetic
    score, greedy (top_k=1), against the JAX trainer's with the same
    weights: the grids equal, and the written .mid and .json files the same
    bytes."""
    import copy
    from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
    from vqcpcb_tpu_torch.data.dataloaders import BachDataloaderGenerator
    trainer, port, _ = pair
    ours = PortDecoderTrainer(
        copy.deepcopy(port.encoder), copy.deepcopy(port.decoder), CODEBOOK,
        device="cpu", model_dir=str(tmp_path / "port"),
        dataloader_generator=BachDataloaderGenerator(
            4, corpus=SyntheticChoraleCorpus(num_chorales=5, min_beats=10,
                                             max_beats=14, seed=0),
            cache_root=str(tmp_path / "port_data")))
    ours.init_state(lr=1e-3)
    jax_score = next(iter(trainer.dataloader_generator.dataset.corpus))
    score = next(iter(ours.dataloader_generator.dataset.corpus))
    want = trainer.generate_reharmonisation(
        2, temperature=1.0, top_k=1, scores=[jax_score],
        write_dir=str(tmp_path / "jax_out"))
    got = ours.generate_reharmonisation(2, temperature=1.0, top_k=1,
                                        scores=[score])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] >= 40
        np.testing.assert_array_equal(g, w)
    for k in range(2):
        for ext in (".mid", ".json"):
            with open(tmp_path / "port" / "reharmonisations" / f"score0_{k}{ext}",
                      "rb") as f, \
                    open(tmp_path / "jax_out" / f"score0_{k}{ext}", "rb") as g:
                assert f.read() == g.read()
