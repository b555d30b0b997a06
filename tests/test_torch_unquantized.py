"""The decoder over an unquantized encoder (source_vocab_size 0: the encoder's
continuous z through a source Linear, JAX's nn.Dense) in the port against
the JAX package on the CPU, at a small size: d_model 32, 4 heads, 2 + 2
layers, FF 48, z of width 16.

- The decoder's logits and loss over z (the flagship AC/D/C and the
  absolute decoder), every parameter's gradient against jax.grad, greedy
  KV-cached tokens over z bit for bit.
- The decoder trainer's `encode_codes` gives the encoder's z, as JAX's
  (decoder_trainer.py:110-116), from the getters' encoder of
  tests/configs/encoder_smoke.py without its quantizer.
- The decoder CLI at tests/configs size over that encoder: -t, then -l
  --num_examples 1; -l -r raises where the JAX CLI does (the encoded chunks
  glued with reshape(1, -1) lose z's feature axis,
  decoder_trainer.py:454), with the port's error saying so.

Tolerances: 1e-5 of the largest |value| for forwards, 1e-4 for gradients,
equal ints for tokens. JAX params are jax.eval_shape's shapes filled from a
seeded numpy generator (tests/test_torch_gqa.py's helpers)."""
import glob
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu import getters as jax_getters
from vqcpcb_tpu_torch import convert, getters, main_decoder
from vqcpcb_tpu_torch.data import dataset as port_dataset
from vqcpcb_tpu_torch.training.decoder_trainer import (DecoderGenerator,
                                                       DecoderTrainer)
from vqcpcb_tpu_torch.utils import load_config_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_torch_gqa as tg  # noqa: E402

Z_DIM = 16
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def f32_caches(monkeypatch):
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "float32")


@pytest.mark.parametrize("kind", ["flagship", "absolute"])
def test_decoder_over_z_forward_matches_jax(kind):
    """The source is a Linear (16 -> d_model, or d_model - p for the
    absolute decoder) in f32; logits and loss against JAX."""
    jdec, params, dec, source, target = tg.decoder_pair(kind, source_dim=Z_DIM)
    assert isinstance(dec.source_embeddings, torch.nn.Linear)
    assert dec.source_embeddings.in_features == Z_DIM
    assert source.dtype == np.float32 and source.shape == (2, tg.CODES, Z_DIM)
    tg.check_forward(jdec, params, dec, source, target)


def test_decoder_over_z_gradients_match_jax():
    """Train mode at dropout 0: every parameter's gradient, the source
    Linear's included, against jax.grad of the JAX loss."""
    jdec, params, dec, source, target = tg.decoder_pair("flagship",
                                                        source_dim=Z_DIM)
    grads = jax.jit(jax.grad(lambda p, s, t: jdec.apply(
        {"params": p}, s, t, training=True, rngs={"dropout": KEY})["loss"]))(
            params, jnp.asarray(source), jnp.asarray(target))
    want = convert.decoder_state_dict(jax.device_get(grads))
    dec.train()
    dec.zero_grad(set_to_none=True)
    dec(torch.from_numpy(source), torch.from_numpy(target))["loss"].backward()
    names = dict(dec.named_parameters())
    assert set(names) == set(want)
    assert {"source_embeddings.weight", "source_embeddings.bias"} <= set(names)
    for name, p in names.items():
        tg.close(p.grad, want[name].numpy(), tg.GRAD_TOL)


def test_greedy_tokens_over_z_match_jax():
    """Greedy (top_k 1) KV-cached tokens over z equal JAX's bit for bit,
    from a mid start with a fixed prefix."""
    tg.check_greedy(*tg.decoder_pair("flagship", source_dim=Z_DIM), start=40)


def test_a_flattened_z_raises_naming_its_axis():
    """A source without z's feature axis (what generate_reharmonisation's
    glue gives) raises at the source embedding, where JAX's Dense fails."""
    *_, dec, source, target = tg.decoder_pair("flagship", source_dim=Z_DIM)
    flat = source.reshape(1, -1)[:, :tg.CODES]
    with pytest.raises(ValueError, match="feature axis"):
        dec.sample_range(flat, target[:1], 0, 1, torch.Generator(), device="cpu")


def _encoder_config():
    return dict(load_config_module(os.path.join(REPO, "tests", "configs",
                                                "encoder_smoke.py")),
                quantizer_type=None)


def test_encode_codes_gives_jax_z(tmp_path):
    """The getters' encoder without a quantizer: the decoder trainer's
    encode_codes (and DecoderGenerator's) return its z (B, 4, 16) as the
    JAX encoder gives it, 1e-5; get_decoder builds its source Linear from
    that width."""
    config = _encoder_config()
    args = (config["dataset"], "vqcpc", config["dataloader_generator_kwargs"],
            config)
    jgen = jax_getters.get_dataloader_generator(*args, cache_root=str(tmp_path / "j"))
    gen = getters.get_dataloader_generator(*args, cache_root=str(tmp_path / "p"))
    jenc, enc = jax_getters.get_encoder(jgen, config), getters.get_encoder(gen, config)
    x = np.stack([np.random.RandomState(c).randint(0, v, (3, 16))
                  for c, v in enumerate(gen.dataset.vocabulary.num_tokens_per_channel)],
                 -1).astype(np.int32)
    params = tg.random_params(jenc.init, {"params": KEY}, jnp.asarray(x))
    enc.load_state_dict(convert.encoder_state_dict(params), strict=True)
    want, indices, _ = jenc.apply({"params": params}, jnp.asarray(x))
    assert indices is None
    dconfig = load_config_module(os.path.join(REPO, "tests", "configs",
                                              "decoder_smoke.py"))
    dgen = getters.get_dataloader_generator(
        dconfig["dataset"], "decoder", dconfig["dataloader_generator_kwargs"],
        dconfig, cache_root=str(tmp_path / "p"))
    processor = getters.get_data_processor(dgen, dconfig["data_processor_type"],
                                           dconfig["data_processor_kwargs"])
    dec = getters.get_decoder(dgen, processor, enc, config,
                              dconfig["decoder_type"], dconfig["decoder_kwargs"])
    assert dec.source_embeddings.in_features == Z_DIM
    got = DecoderTrainer(enc, dec, 8, device="cpu").encode_codes(
        torch.from_numpy(x))
    assert got.shape == (3, 4, Z_DIM) and got.dtype == torch.float32
    tg.close(got, want, tg.FWD_TOL)
    sampler = DecoderGenerator(enc, dec, dgen.dataset.vocabulary, 8,
                               device="cpu")
    tg.close(sampler.encode_codes(x), want, tg.FWD_TOL)


def test_decoder_cli_over_an_unquantized_encoder(tmp_path, monkeypatch):
    """main_decoder -t and -l --num_examples 1 on a copy of decoder_smoke.py
    whose encoder is encoder_smoke.py without its quantizer (fresh encoder
    weights, as there is no checkpoint); -l -r raises the port's error at
    the first window, as the JAX CLI fails there."""
    cfg = tmp_path / "configs"
    cfg.mkdir()
    (cfg / "encoder_nq.py").write_text(f"config = {_encoder_config()!r}\n")
    dconfig = dict(load_config_module(os.path.join(REPO, "tests", "configs",
                                                   "decoder_smoke.py")),
                   config_encoder=str(cfg / "encoder_nq.py"),
                   savename="decoder_nq")
    (cfg / "decoder_nq.py").write_text(f"config = {dconfig!r}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    assert main_decoder.main(["-t", "-c", "configs/decoder_nq.py",
                              "--device", "cpu"]) == 0
    (model_dir,) = glob.glob(str(tmp_path / "models" / "decoder_nq_*"))
    config = os.path.join(model_dir, "config.py")
    assert main_decoder.main(["-l", "--num_examples", "1", "-c", config,
                              "--device", "cpu"]) == 0
    assert len(glob.glob(os.path.join(model_dir, "generations", "*.mid"))) == 6
    with pytest.raises(ValueError, match="feature axis"):
        main_decoder.main(["-l", "-r", "-c", config, "--device", "cpu"])
