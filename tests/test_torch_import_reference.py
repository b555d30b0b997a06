"""The port's importer of PyTorch-reference checkpoints
(vqcpcb_tpu_torch/training/import_reference.py), its migrate CLI and the
weights-only checkpoints, against the JAX package on the CPU.

The reference's files are not in the repository, so every reference
state_dict here is built: flax params from jax.eval_shape filled from a
seeded numpy generator (tests/test_torch_getters.py's random_params) at the
test configs' small geometry, turned into the reference layout by
convert.py (the port keeps the reference's names), split per module as the
reference saves them, plus the entries only the reference has (a decoder
file's `encoder.*`, BatchNorm's `num_batches_tracked`).

- The fixture itself against the JAX importer: JAX's import_* gives back
  the starting flax tree exactly.
- The port's importer against JAX's importer followed by convert.py, bit
  for bit, for every encoder variant (GRU with two directions and one, both
  transformer downscalers, a BatchNorm quantizer with its statistics, no
  upscaler), the five decoder types and the unquantized encoder's Linear
  source, the prior, the teacher with its data processor and the relative
  auxiliary decoder; a missing key raises a KeyError naming it.
- The plumbing: tiny reference directories of tests/configs/*_smoke.py
  geometry (an encoder with a BatchNorm quantizer and a decoder in both
  slots, a prior in the flat layout) migrated by the port's CLI and by
  JAX's (click's CliRunner); JAX's orbax output through convert.py equals
  the port's state.pt bit for bit. Weights-only adoption loads the named
  entries, keeps Adam's moments fresh and the step as it is, and raises on
  a shape mismatch, an entry with no target and a grouped config (where
  JAX's load fails too). The CLIs (the encoder's -l, the decoder's -l
  --num_examples 1 and -t -l, the prior's -l -g) run from the migrated
  directories, and the migrated encoder's
  codes equal JAX's over JAX-migrated params.
- Vocabulary.from_reference_pickle against JAX's.
"""
import glob
import json
import os
import pickle
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vqcpcb_tpu import getters as jax_getters
from vqcpcb_tpu.data.vocab import Vocabulary as JaxVocabulary
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.models.prior import PriorRelative as JaxPrior
from vqcpcb_tpu.training import checkpoints as jax_checkpoints
from vqcpcb_tpu.training import import_reference as jax_ir
from vqcpcb_tpu.training.train_state import TrainState
from vqcpcb_tpu_torch import (convert, getters, main_decoder, main_encoder,
                              main_prior, migrate_reference_checkpoint as migrate)
from vqcpcb_tpu_torch.data import dataset as port_dataset
from vqcpcb_tpu_torch.data.vocab import Vocabulary
from vqcpcb_tpu_torch.training import checkpoints
from vqcpcb_tpu_torch.training import import_reference as ir
from vqcpcb_tpu_torch.utils import load_config_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_getters import (ENCODER_CONFIG, RNGS, STUDENT_CONFIG,  # noqa: E402
                                _jax_student_modules, _transfo_config,
                                random_params)

CONFIGS = os.path.join(REPO, "tests", "configs")
VOCABS = [7, 9, 6, 8]
NUM_EVENTS = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def assert_same_state(got, want):
    """The same entries, each an f32 contiguous CPU tensor equal bit for
    bit (its int32 view) to the other's."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype == torch.float32, k
        assert g.device.type == "cpu" and g.is_contiguous(), k
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), k


def assert_tree_equal(got, want, path=""):
    """The same nested keys and equal arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def split(sd, prefix):
    """The entries under `prefix`, without it (a per-module reference file)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---- the importer, per kind -------------------------------------------------------

@pytest.fixture(scope="module")
def cpc_loader(tmp_path_factory):
    config = load_config_module(ENCODER_CONFIG)
    return jax_getters.get_dataloader_generator(
        config["dataset"], "vqcpc", config["dataloader_generator_kwargs"], config,
        cache_root=str(tmp_path_factory.mktemp("import_reference")))


def _encoder_config(variant):
    """encoder_smoke.py (GRU 32 x 2 layers here) as each variant changes it."""
    if variant.startswith("relative_transformer"):
        return _transfo_config(variant)
    config = load_config_module(ENCODER_CONFIG)
    config["downscaler_kwargs"] = dict(config["downscaler_kwargs"], num_layers=2)
    if variant == "gru_one_direction":
        config["downscaler_kwargs"]["bidirectional"] = False
    elif variant == "batch_norm":
        config["quantizer_kwargs"] = dict(config["quantizer_kwargs"],
                                          use_batch_norm=True, num_codebooks=1)
    elif variant == "no_upscaler":
        config["upscaler_type"] = None
    return config


def _reference_encoder(jencoder, config, seed=0):
    """(flax params, flax batch_stats or {}, the four reference files)."""
    x = jnp.zeros((2, 12, 4), jnp.int32)
    params = random_params(jencoder.init, RNGS, x, training=False, seed=seed)
    sd = convert.encoder_state_dict(params)
    files = {name: split(sd, f"{name}.") for name in
             ("data_processor", "downscaler", "quantizer", "upscaler")}
    stats = {}
    if config["quantizer_kwargs"]["use_batch_norm"]:
        rng = np.random.RandomState(seed + 7)
        d = config["quantizer_kwargs"]["codebook_dim"]
        stats = {"quantizer": {"batch_norm": {
            "mean": rng.randn(d).astype(np.float32),
            "var": (rng.rand(d) + 0.5).astype(np.float32)}}}
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            files["quantizer"][f"batch_norm.{name}"] = torch.from_numpy(
                stats["quantizer"]["batch_norm"][key])
        files["quantizer"]["batch_norm.num_batches_tracked"] = torch.tensor(5)
    if config.get("upscaler_type") is None:
        files["upscaler"] = None
    return params, stats, files


def _encoder_kwargs(config):
    dk = config["downscaler_kwargs"]
    return dict(num_layers_gru=dk.get("num_layers", 2),
                bidirectional=dk.get("bidirectional", True),
                downscaler_type=config["downscaler_type"],
                num_heads=dk.get("n_head", 8),
                list_of_num_layers=dk.get("list_of_num_layers"))


ENCODER_VARIANTS = ["gru_two_directions", "gru_one_direction",
                    "relative_transformer_downscaler",
                    "relative_transformer_downscaler_linear", "batch_norm",
                    "no_upscaler"]


@pytest.mark.parametrize("variant", ENCODER_VARIANTS)
def test_encoder_import_equals_jax_then_convert(cpc_loader, variant):
    """The fixture gives JAX's importer back its starting params (and
    batch stats); the port's importer gives what JAX's followed by
    convert.py gives, bit for bit, parameters and BatchNorm buffers."""
    config = _encoder_config(variant)
    jencoder = jax_getters.get_encoder(cpc_loader, config)
    params, stats, files = _reference_encoder(jencoder, config)
    args = (files["data_processor"], files["downscaler"], files["quantizer"],
            files["upscaler"])
    kwargs = _encoder_kwargs(config)
    jparams = jax_ir.import_encoder_state_dicts(*args, **kwargs)
    assert_tree_equal(jparams, params)
    jstats = jax_ir.import_encoder_batch_stats(files["quantizer"])
    assert_tree_equal(jstats, {"batch_stats": {"encoder": stats}} if stats else {})
    assert_same_state(ir.import_encoder_state_dicts(*args, **kwargs),
                      convert.encoder_state_dict(jparams))
    want = (convert._encoder_buffers({"batch_stats": jstats["batch_stats"]["encoder"]},
                                     "") if jstats else {})
    assert_same_state(ir.import_encoder_batch_stats(files["quantizer"]), want)
    assert bool(want) == (variant == "batch_norm")


def _jax_decoder(decoder_type, source_dim=0):
    """A JAX decoder of DECODER_TYPES[decoder_type] at d_model 32, 4 heads,
    2 + 2 layers, over 4 codes of 16 tokens (or z of width source_dim), and
    its params from a seed."""
    transformer_type, encoder_attention, cross = getters.DECODER_TYPES[decoder_type]
    rng = np.random.RandomState(3)
    codes = NUM_EVENTS * 4 // 16
    source = (rng.randn(2, codes, source_dim).astype(np.float32) if source_dim
              else rng.randint(0, 8, (2, codes)).astype(np.int32))
    target = np.zeros((2, NUM_EVENTS, 4), np.int32)
    jdec = JaxDecoder(
        data_processor=JaxProcessor(embedding_size=12, num_events=NUM_EVENTS,
                                    num_tokens_per_channel=VOCABS),
        encoder_attention_type=encoder_attention, d_model=32,
        num_encoder_layers=2, num_decoder_layers=2, n_head=4, dim_feedforward=48,
        positional_embedding_size=4, num_channels_encoder=1,
        num_events_encoder=codes, num_channels_decoder=4,
        num_events_decoder=NUM_EVENTS, dropout=0.0, total_upscaling=16,
        source_vocab_size=0 if source_dim else 8, source_dim=source_dim,
        transformer_type=transformer_type, cross_attention_type=cross)
    params = random_params(jdec.init, {"params": RNGS["params"],
                                       "dropout": RNGS["dropout"]},
                           jnp.asarray(source), jnp.asarray(target))
    return params, transformer_type, cross


def _encoder_entries(seed=11):
    """Entries of the frozen encoder that a reference decoder file carries."""
    g = torch.Generator().manual_seed(seed)
    return {"encoder.data_processor.embeddings.0.weight": torch.randn(8, 4, generator=g),
            "encoder.downscaler.output_linear.weight": torch.randn(3, 8, generator=g),
            "encoder.quantizer.embeddings.0": torch.randn(8, 3, generator=g)}


@pytest.mark.parametrize("decoder_type", sorted(getters.DECODER_TYPES) + ["unquantized"])
def test_decoder_import_equals_jax_then_convert(decoder_type):
    """Each decoder type (and the Linear source over an unquantized
    encoder's z): a whole reference decoder file with its `encoder.*`
    entries; JAX's importer gives back the params, the port's gives JAX's
    followed by convert.py, bit for bit, the encoder entries ignored."""
    unquantized = decoder_type == "unquantized"
    params, transformer_type, cross = _jax_decoder(
        "transformer_relative_diagonal" if unquantized else decoder_type,
        source_dim=5 if unquantized else 0)
    sd = dict(convert.decoder_state_dict(params), **_encoder_entries())
    kwargs = dict(num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                  aligned_cross=cross == "diagonal", transformer_type=transformer_type)
    jparams = jax_ir.import_decoder_state_dict(sd, **kwargs)
    assert_tree_equal(jparams, params)
    got = ir.import_decoder_state_dict(sd, **kwargs)
    assert_same_state(got, convert.decoder_state_dict(jparams))
    assert ("source_embeddings.bias" in got) == unquantized


PRIOR = dict(code_vocab_size=11, d_model=32, num_layers=2, n_head=4,
             dim_feedforward=48, embedding_size=8, num_channels=1, num_events=12,
             dropout=0.0)


def _reference_prior(params):
    """The reference names its one head pre_softmaxes.0."""
    return {k.replace("pre_softmax.", "pre_softmaxes.0.", 1): v
            for k, v in convert.prior_state_dict(params).items()}


@pytest.fixture(scope="module")
def student_modules(tmp_path_factory):
    config = load_config_module(STUDENT_CONFIG)
    jgen = jax_getters.get_dataloader_generator(
        config["dataset"], "student", config["dataloader_generator_kwargs"], config,
        cache_root=str(tmp_path_factory.mktemp("student")))
    return config, _jax_student_modules(jgen, config)


@pytest.mark.parametrize("kind", ["prior", "teacher", "auxiliary_decoder"])
def test_other_modules_import_equals_jax_then_convert(student_modules, kind):
    """The prior, the teacher with its data processor (of
    encoder_student_smoke.py) and the relative auxiliary decoder: JAX's
    importer gives back the params; the port's gives JAX's followed by
    convert.py, bit for bit."""
    config, (_, jteacher, jdecoder) = student_modules
    aux = config["auxiliary_networks_kwargs"]
    if kind == "prior":
        params = random_params(JaxPrior(**PRIOR).init, RNGS,
                               jnp.zeros((2, 12), jnp.int32))
        sd = _reference_prior(params)
        jparams = jax_ir.import_prior_state_dict(sd, 4, 2)
        assert_tree_equal(jparams, params)
        assert_same_state(ir.import_prior_state_dict(sd, 4, 2),
                          convert.prior_state_dict(jparams))
    elif kind == "teacher":
        tk = aux["teacher_kwargs"]
        x = jnp.zeros((2, 16, 4), jnp.int32)
        dp_params = random_params(jteacher.data_processor.init, RNGS, x, seed=1)
        embedded = jax.eval_shape(lambda p: jteacher.data_processor.apply(
            {"params": p}, x), dp_params)
        params = random_params(jteacher.init, RNGS,
                               jnp.zeros(embedded.shape, embedded.dtype))
        sd = convert.teacher_state_dict(params, dp_params)
        jparams, jdp = jax_ir.import_teacher_state_dict(sd, tk["n_head"],
                                                        tk["num_layers"])
        assert_tree_equal(jparams, params)
        assert_tree_equal(jdp, dp_params)
        got, got_dp = ir.import_teacher_state_dict(sd, tk["n_head"], tk["num_layers"])
        assert not set(got) & set(got_dp) and got_dp
        assert_same_state({**got, **got_dp}, convert.teacher_state_dict(jparams, jdp))
    else:
        ak = aux["auxiliary_decoder_kwargs"]
        z = jnp.zeros((2, jdecoder.num_tokens_bottleneck, 3))
        params = random_params(jdecoder.init, RNGS, z)
        sd = convert.auxiliary_decoder_state_dict(params)
        jparams = jax_ir.import_auxiliary_decoder_state_dict(
            sd, ak["n_head"], ak["list_of_num_layers"])
        assert_tree_equal(jparams, params)
        assert_same_state(ir.import_auxiliary_decoder_state_dict(
            sd, ak["n_head"], ak["list_of_num_layers"]),
            convert.auxiliary_decoder_state_dict(jparams))


@pytest.mark.parametrize("kind,missing", [
    ("encoder", "g_enc_bwd.bias_hh_l1"), ("encoder", "embeddings.0"),
    ("decoder", "transformer.decoder.layers.1.cross_attn.2.weight"),
    ("decoder", "target_channel_embeddings"),
    ("prior", "transformer.layers.1.self_attn.attn_bias.e2"),
    ("prior", "pre_softmaxes.0.bias")])
def test_missing_key_raises_naming_it(cpc_loader, kind, missing):
    """A key the JAX importer reads, taken out: both importers raise a
    KeyError, the port's naming the key."""
    if kind == "encoder":
        config = _encoder_config("gru_two_directions")
        _, _, files = _reference_encoder(jax_getters.get_encoder(cpc_loader, config),
                                         config)
        module = "quantizer" if missing == "embeddings.0" else "downscaler"
        del files[module][missing]
        args = ((files["data_processor"], files["downscaler"], files["quantizer"],
                 files["upscaler"]), _encoder_kwargs(config))
        port, jax_fn = ir.import_encoder_state_dicts, jax_ir.import_encoder_state_dicts
    elif kind == "decoder":
        params, transformer_type, cross = _jax_decoder("transformer_relative_diagonal")
        sd = convert.decoder_state_dict(params)
        del sd[missing]
        args = ((sd,), dict(num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                            aligned_cross=True))
        port, jax_fn = ir.import_decoder_state_dict, jax_ir.import_decoder_state_dict
    else:
        sd = _reference_prior(random_params(JaxPrior(**PRIOR).init, RNGS,
                                            jnp.zeros((2, 12), jnp.int32)))
        del sd[missing]
        args = ((sd, 4, 2), {})
        port, jax_fn = ir.import_prior_state_dict, jax_ir.import_prior_state_dict
    with pytest.raises(KeyError) as exc:
        port(*args[0], **args[1])
    assert exc.value.args == (missing,)
    # JAX's importer fails too (np.stack of no codebook where none is left)
    with pytest.raises((KeyError, ValueError)):
        jax_fn(*args[0], **args[1])


# ---- the plumbing: reference directories, the two CLIs, the loads ----------------

def _write_reference_slot(slot, files):
    os.makedirs(slot, exist_ok=True)
    for name, sd in files.items():
        torch.save(sd, os.path.join(slot, name))


def _write_config(path, config):
    with open(path, "w") as f:
        f.write(f'"""A reference model directory\'s config.py."""\nconfig = {config!r}\n')


def _run_jax_cli(args):
    from click.testing import CliRunner
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import migrate_reference_checkpoint as jax_migrate
    finally:
        sys.path.pop(0)
    result = CliRunner().invoke(jax_migrate.main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


def _count_lines(output):
    return sorted(line.split(" -> ")[0] for line in output.splitlines()
                  if ": migrated " in line)


@pytest.fixture(scope="module")
def reference_dirs(tmp_path_factory):
    """Reference directories of the smoke configs' geometry from the port's
    getters, random weights from seeds: an encoder with a BatchNorm
    quantizer (both slots, four files each, the statistics moved off their
    init), a decoder over it (both slots, one whole file with the
    `encoder.*` entries) and a prior (the flat layout); each one's
    config.py names the migrated encoder's (and decoder's) config.py."""
    root = tmp_path_factory.mktemp("reference")
    out = {k: str(root / f"migrated_{k}") for k in ("encoder", "decoder", "prior")}
    ref = {k: str(root / f"ref_{k}") for k in out}
    cache = str(root / "data")
    saved_cache = port_dataset.DEFAULT_CACHE_ROOT
    port_dataset.DEFAULT_CACHE_ROOT = cache
    try:
        encoder_config = load_config_module(ENCODER_CONFIG)
        encoder_config["quantizer_kwargs"] = dict(encoder_config["quantizer_kwargs"],
                                                  use_batch_norm=True)
        encoder_config["savename"] = "ref_encoder"
        os.makedirs(ref["encoder"])
        _write_config(os.path.join(ref["encoder"], "config.py"), encoder_config)
        torch.manual_seed(0)
        encoder, _ = main_decoder.load_encoder_stack(
            {"config_encoder": os.path.join(ref["encoder"], "config.py")})
        data = getters.get_dataloader_generator(
            "synthetic", "decoder", {"sequences_size": 4}, encoder_config)
        x = torch.as_tensor(next(data.dataloaders(batch_size=8)[0])["x"])
        quantizer = encoder.quantizer
        with torch.no_grad():
            quantizer.batch_norm.running_mean.normal_()
            quantizer.batch_norm.running_var.uniform_(0.5, 1.5)
            # codewords drawn from the normalised latents, so the codes spread
            search = quantizer.batch_norm(encoder.downscale(x, training=False)
                                          .reshape(-1, 3), False)
            quantizer.set_codebooks(search[torch.randperm(len(search))[:8]][None])
        enc_sd = encoder.state_dict()
        for slot in checkpoints.SLOTS:
            files = {name: split(enc_sd, f"{name}.") for name in
                     ("data_processor", "downscaler", "quantizer", "upscaler")}
            files["quantizer"]["batch_norm.num_batches_tracked"] = torch.tensor(3)
            _write_reference_slot(os.path.join(ref["encoder"], slot), files)

        decoder_config = load_config_module(os.path.join(CONFIGS, "decoder_smoke.py"))
        decoder_config.update(config_encoder=os.path.join(out["encoder"], "config.py"),
                              savename="ref_decoder")
        os.makedirs(ref["decoder"])
        _write_config(os.path.join(ref["decoder"], "config.py"), decoder_config)
        trainer = main_decoder.build_decoder_trainer(
            dict(decoder_config, config_encoder=os.path.join(ref["encoder"], "config.py")),
            encoder, encoder_config, "cpu", str(root / "unused"))
        dec_sd = {**trainer.decoder.state_dict(),
                  **{f"encoder.{k}": v for k, v in enc_sd.items()}}
        for slot in checkpoints.SLOTS:
            _write_reference_slot(os.path.join(ref["decoder"], slot), {"decoder": dec_sd})

        prior_config = load_config_module(os.path.join(CONFIGS, "prior_smoke.py"))
        prior_config.update(config_encoder=os.path.join(out["encoder"], "config.py"),
                            config_decoder=os.path.join(out["decoder"], "config.py"),
                            savename="ref_prior")
        data = getters.get_dataloader_generator(
            "synthetic", "prior", prior_config["dataloader_generator_kwargs"],
            prior_config)
        torch.manual_seed(1)
        prior = getters.get_prior(data, encoder, encoder_config,
                                  "transformer_relative", prior_config["prior_kwargs"])
        prior_sd = {k.replace("pre_softmax.", "pre_softmaxes.0.", 1): v
                    for k, v in prior.state_dict().items()}
        _write_reference_slot(ref["prior"], {"prior": prior_sd})
        _write_config(os.path.join(ref["prior"], "config.py"), prior_config)
    finally:
        port_dataset.DEFAULT_CACHE_ROOT = saved_cache
    return dict(root=root, ref=ref, out=out, cache=cache,
                files={"encoder": enc_sd, "decoder": dec_sd, "prior": prior_sd})


@pytest.fixture(scope="module")
def migrated(reference_dirs):
    """Each reference directory through the port's CLI and through JAX's
    (into jax_<kind>); the printed lines of each."""
    import io
    from contextlib import redirect_stdout
    printed = {}
    for kind, ref in reference_dirs["ref"].items():
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert migrate.main([ref, "-o", reference_dirs["out"][kind]]) == 0
        jax_out = str(reference_dirs["root"] / f"jax_{kind}")
        printed[kind] = (buf.getvalue(), _run_jax_cli([ref, "-o", jax_out]))
    return dict(reference_dirs, printed=printed)


def _jax_output_converted(path, kind, early_stopped):
    raw = jax_checkpoints.load_state(path, early_stopped=early_stopped)
    if kind == "encoder":
        return convert.vqcpc_state_dict(raw["params"], raw.get("batch_stats"))
    return (convert.decoder_state_dict if kind == "decoder"
            else convert.prior_state_dict)(raw["params"])


@pytest.mark.parametrize("kind,slot", [("encoder", "early_stopped"),
                                       ("encoder", "overfitted"),
                                       ("decoder", "early_stopped"),
                                       ("decoder", "overfitted"),
                                       ("prior", "early_stopped")])
def test_migrate_cli_equals_jax_cli_then_convert(migrated, kind, slot):
    """The port's state.pt holds only the model's entries, equal bit for bit
    to JAX's orbax output through convert.py and to the reference tensors
    it read (the encoder's under `encoder.`, its BatchNorm statistics
    among them); both CLIs print the same kind and parameter count for each
    slot, and copy the config."""
    out = migrated["out"][kind]
    early_stopped = slot == "early_stopped"
    state = checkpoints.load_state(out, early_stopped)
    assert checkpoints.is_weights_only(state)
    jax_out = str(migrated["root"] / f"jax_{kind}")
    assert_same_state(state["model"], _jax_output_converted(jax_out, kind, early_stopped))
    reference = migrated["files"][kind]
    if kind == "encoder":
        reference = {f"encoder.{k}": v for k, v in reference.items()}
    elif kind == "decoder":
        reference = {k: v for k, v in reference.items() if not k.startswith("encoder.")}
    else:
        reference = {k.replace("pre_softmaxes.0.", "pre_softmax.", 1): v
                     for k, v in reference.items()}
    assert_same_state(state["model"], reference)
    port_out, jax_printed = migrated["printed"][kind]
    assert _count_lines(port_out) == _count_lines(jax_printed)
    assert f"{slot}: migrated {kind} (" in port_out
    assert os.path.exists(os.path.join(out, "config.py"))
    if kind == "prior":            # the flat layout: one slot
        assert not os.path.exists(os.path.join(out, "overfitted"))


def test_migrate_cli_kind_detection_and_errors(migrated, tmp_path):
    """--kind overrides the detection; a directory without reference files
    or without config.py fails."""
    out = str(tmp_path / "forced")
    assert migrate.main([migrated["ref"]["decoder"], "-o", out, "--kind",
                         "decoder"]) == 0
    assert migrate.detect_kind(os.path.join(migrated["ref"]["encoder"],
                                            "overfitted")) == "encoder"
    assert migrate.detect_kind(migrated["ref"]["prior"]) == "prior"
    with pytest.raises(ValueError, match="no reference checkpoint files"):
        migrate.detect_kind(str(tmp_path))
    with pytest.raises(SystemExit, match="config.py"):
        migrate.main([str(tmp_path), "-o", str(tmp_path / "x")])


def _decoder_trainer(migrated, config_path=None):
    config = load_config_module(config_path or os.path.join(
        migrated["out"]["decoder"], "config.py"))
    encoder, encoder_config = main_decoder.load_encoder_stack(config)
    return main_decoder.build_decoder_trainer(
        config, encoder, encoder_config, "cpu",
        os.path.dirname(os.path.abspath(config_path)) if config_path
        else migrated["out"]["decoder"]), encoder


def test_weights_only_adoption_keeps_fresh_optimizer_state(migrated, monkeypatch):
    """-l over a migrated decoder: the decoder's entries are the reference's
    bit for bit, the frozen encoder's (BatchNorm statistics included)
    too; Adam's moments stay zero, its count and the step 0; an entry with
    no target and a shape mismatch raise, giving the counts."""
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", migrated["cache"])
    trainer, encoder = _decoder_trainer(migrated)
    generator_state = trainer.generator.get_state()
    trainer.load(early_stopped=True)
    ref = migrated["files"]["decoder"]
    assert_same_state(trainer.decoder.state_dict(),
                      {k: v for k, v in ref.items() if not k.startswith("encoder.")})
    assert_same_state(encoder.state_dict(), migrated["files"]["encoder"])
    opt = trainer.optimizer
    assert opt.count == 0 and trainer.step == 0
    assert all(not m.any() for m in opt.mu + opt.nu)
    assert torch.equal(trainer.generator.get_state(), generator_state)

    model_dir = str(migrated["root"] / "bad_weights")
    weights = dict(checkpoints.load_state(migrated["out"]["decoder"], True)["model"])
    checkpoints.save_weights_only(model_dir, True, dict(weights, extra=torch.zeros(2)))
    trainer.model_dir = model_dir
    with pytest.raises(ValueError, match=r"1 of \d+ entries have no matching"):
        trainer.load(early_stopped=True)
    weights["sos"] = torch.zeros(1, 1, 3)
    checkpoints.save_weights_only(model_dir, False, weights)
    with pytest.raises(ValueError, match=r"sos: shape \(1, 1, 3\)"):
        trainer.load(early_stopped=False)


def test_flat_layout_fallback_of_load_state(tmp_path):
    """Without the slot's directory the model directory itself is read (the
    reference's pre-slot layout)."""
    state = {"model": {"w": torch.arange(3.0)}}
    torch.save(state, tmp_path / checkpoints.STATE_FILE)
    got = checkpoints.load_state(str(tmp_path), early_stopped=True)
    assert torch.equal(got["model"]["w"], state["model"]["w"])


def test_grouped_config_fails_to_load_as_jax_does(migrated, monkeypatch, tmp_path):
    """A decoder config with n_head_kv 1 of 2 heads over the migrated
    weights: the reference's fused in_proj has no grouped target; the
    port's load raises saying so, and JAX's load of its own migration
    fails too."""
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", migrated["cache"])
    config = load_config_module(os.path.join(migrated["out"]["decoder"], "config.py"))
    config["decoder_kwargs"] = dict(config["decoder_kwargs"], n_head_kv=1)
    model_dir = tmp_path / "grouped"
    shutil.copytree(migrated["out"]["decoder"], model_dir)
    _write_config(model_dir / "config.py", config)
    trainer, _ = _decoder_trainer(migrated, str(model_dir / "config.py"))
    with pytest.raises(ValueError, match="grouped-query"):
        trainer.load(early_stopped=True)

    enc_config = load_config_module(config["config_encoder"])
    jgen = jax_getters.get_dataloader_generator(
        "synthetic", "decoder", config["dataloader_generator_kwargs"], config,
        cache_root=str(tmp_path / "jax_data"))
    jenc_gen = jax_getters.get_dataloader_generator(
        "synthetic", "vqcpc", enc_config["dataloader_generator_kwargs"], enc_config,
        cache_root=str(tmp_path / "jax_data"))
    jdec = jax_getters.get_decoder(
        jgen, jax_getters.get_data_processor(jgen, "bach", config["data_processor_kwargs"]),
        jax_getters.get_encoder(jenc_gen, enc_config), enc_config,
        config["decoder_type"], config["decoder_kwargs"])
    x = next(jgen.dataloaders(batch_size=2)[0])["x"]
    shapes = jax.eval_shape(jdec.init, RNGS, jnp.zeros((2, x.shape[1] * 4 // 16),
                                                       jnp.int32), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes["params"])
    state = TrainState(params=params, opt_state=optax.adam(1e-3).init(params),
                       batch_stats={}, step=0)
    with pytest.raises(Exception):
        jax_checkpoints.load_state(str(migrated["root"] / "jax_decoder"),
                                   early_stopped=True, target=state)


def test_clis_run_from_the_migrated_directories(migrated, monkeypatch, tmp_path):
    """On the CPU: the encoder CLI -l (the VQ-CPC model's context nets
    fresh; on a copy, the cluster dumps), the decoder CLI -l --num_examples
    1 and the prior CLI -l -g from the migrated directories, then -t -l (one
    epoch of 2 batches)
    continuing from the migrated decoder's weights with fresh Adam
    moments, on a copy."""
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", migrated["cache"])
    monkeypatch.chdir(tmp_path)
    encoder_copy = tmp_path / "encoder"
    shutil.copytree(migrated["out"]["encoder"], encoder_copy)
    assert main_encoder.main(["-l", "-c", str(encoder_copy / "config.py"),
                              "--device", "cpu"]) == 0
    decoder_config = os.path.join(migrated["out"]["decoder"], "config.py")
    assert main_decoder.main(["-l", "--num_examples", "1", "-c", decoder_config,
                              "--device", "cpu"]) == 0
    assert glob.glob(os.path.join(migrated["out"]["decoder"], "generations", "*.mid"))
    prior_dir = migrated["out"]["prior"]
    assert main_prior.main(["-l", "-g", "-c", os.path.join(prior_dir, "config.py"),
                            "--device", "cpu"]) == 0
    assert len(glob.glob(os.path.join(prior_dir, "generations", "*.mid"))) == 1

    copy = tmp_path / "continued"
    shutil.copytree(migrated["out"]["decoder"], copy)
    assert main_decoder.main(["-t", "-l", "-c", str(copy / "config.py"),
                              "--num_epochs", "1", "--num_batches", "2",
                              "--device", "cpu"]) == 0
    state = checkpoints.load_state(str(copy), early_stopped=False)
    assert state["step"] == 2 and state["optimizer"]["count"] == 2
    with open(copy / "metrics.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert np.isfinite(row["loss/train"])


def test_migrated_encoder_codes_equal_jax(migrated, monkeypatch):
    """The port's migrated encoder (load_encoder_stack over its weights-only
    slot) and JAX's encoder over the JAX-migrated params and BatchNorm
    statistics (JAX's load_encoder_stack) give the same codes, bit for bit,
    on one batch of the decoder's data."""
    import main_decoder as jax_main_decoder
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", migrated["cache"])
    config = load_config_module(os.path.join(migrated["out"]["decoder"], "config.py"))
    encoder, _ = main_decoder.load_encoder_stack(config)
    data = getters.get_dataloader_generator(
        "synthetic", "decoder", config["dataloader_generator_kwargs"], config)
    x = next(data.dataloaders(batch_size=8)[0])["x"]
    with torch.no_grad():
        idx = encoder.eval()(torch.as_tensor(x))[1]
    jax_config = dict(config, config_encoder=os.path.join(
        migrated["root"], "jax_encoder", "config.py"))
    jencoder, variables, _ = jax_main_decoder.load_encoder_stack(
        jax_config, x, cache_root=str(migrated["root"] / "jax_data"))
    assert "batch_stats" in variables
    _, jidx, _ = jax.jit(lambda v, t: jencoder.apply(v, t, training=False))(
        variables, jnp.asarray(x))
    assert len(np.unique(np.asarray(jidx))) > 1
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_vocabulary_from_reference_pickle_equals_jax(tmp_path):
    """A pickle in the reference's format (chorale_dataset.py:92-101): the
    port's Vocabulary equals JAX's, index2note dicts and voice ranges
    included."""
    d = {"index2note_dicts": [{0: "C4", 1: "__", 2: "rest"}, {0: "D4", 1: "__"}],
         "note2index_dicts": [{"C4": 0, "__": 1, "rest": 2}, {"D4": 0, "__": 1}],
         "voice_ranges": [(60, 72), (50, 62)]}
    path = tmp_path / "index_dicts.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    got, want = (cls.from_reference_pickle(str(path))
                 for cls in (Vocabulary, JaxVocabulary))
    for name in ("note2index_dicts", "index2note_dicts", "voice_ranges"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.voice_ranges == [(60, 72), (50, 62)]
    assert got.num_tokens_per_channel == want.num_tokens_per_channel == [3, 2]
