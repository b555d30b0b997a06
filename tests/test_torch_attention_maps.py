"""Attention maps in the port against the JAX package on the CPU, at a small
size: d_model 32, 2 heads, 2 + 2 layers, FF 48, 16 events of 4 voices over
4 codes (the configs' upscaling of 16).

- Decoder.forward(collect_attentions=True): every decoder layer's
  a_self_decoder and a_cross weights within 1e-5 absolute of JAX's
  collect_attentions=True output, the loss within 1e-5 relative, for the
  flagship AC/D/C (a_cross None on both sides), the relative AC/AC/C, the
  absolute decoder and AC/AC/C with n_head_kv 1 of 2; one compiled JAX
  forward per model. Without the flag the loss is the same bit for bit and
  no maps come back. The encoder stack's collection against JAX's.
- need_weights changes nothing on the CPU, which always takes the plain
  path (on the card the collecting forward takes it in place of the
  kernels; the card twin is tests/test_torch_cuda.py's
  test_attention_maps_on_card, which imports no JAX).
- DecoderTrainer.dump_attention_maps writes the file names JAX's trainer
  writes on the same geometry; plot_attention and scatterplot_clusters_3d
  (codebook dims 1, 2 and 3) write non-empty PDFs under JAX's names, and
  without matplotlib or seaborn raise an ImportError naming it.
- main_encoder -t, then -l, on tests/configs/encoder_smoke.py (codebook
  dimension 3) leave clusters_scatter.pdf; without matplotlib the CLI says
  so and exits 0.
- The data layer's extract_with_padding and the dataset's vocabulary
  properties against JAX's, bit for bit.

JAX params are jax.eval_shape's shapes filled from a seeded numpy generator
(tests/test_torch_getters.py's random_params); inputs come from numpy seeds."""
import copy
import functools
import glob
import os
import shutil
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu.data.dataset import ChoraleBeatsDataset as JaxDataset
from vqcpcb_tpu.data.corpora import SyntheticChoraleCorpus as JaxCorpus
from vqcpcb_tpu.data.tokenizer import extract_with_padding as jax_extract
from vqcpcb_tpu.models.data_processor import BachDataProcessor as JaxProcessor
from vqcpcb_tpu.models.decoder import Decoder as JaxDecoder
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.transformer import TransformerEncoder as JaxEncoderStack
from vqcpcb_tpu.training import analysis as jax_analysis
from vqcpcb_tpu.training.decoder_trainer import \
    DecoderTrainer as JaxDecoderTrainer
from vqcpcb_tpu_torch import convert, main_encoder
from vqcpcb_tpu_torch.data import dataset as port_dataset
from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
from vqcpcb_tpu_torch.data.dataset import ChoraleBeatsDataset
from vqcpcb_tpu_torch.data.tokenizer import extract_with_padding
from vqcpcb_tpu_torch.data.vocab import Vocabulary
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder
from vqcpcb_tpu_torch.training import analysis
from vqcpcb_tpu_torch.training.decoder_trainer import \
    DecoderTrainer as PortDecoderTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_getters import random_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
RNGS = {"params": KEY, "dropout": KEY}
E, H = 32, 2
VOCABS = [7, 9, 6, 8]
NUM_EVENTS = 16          # 64 target tokens, 4 codes of 16
CODES = NUM_EVENTS * 4 // 16
CODE_VOCAB = 8
ATOL, LOSS_RTOL = 1e-5, 1e-5

KINDS = {
    "AC_D_C": dict(transformer_type="relative", cross_attention_type="diagonal"),
    "AC_AC_C": dict(transformer_type="relative", cross_attention_type="anticausal"),
    "absolute": dict(transformer_type="absolute", cross_attention_type="full"),
    "AC_AC_C_kv1": dict(transformer_type="relative",
                        cross_attention_type="anticausal", n_head_kv=1),
}


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


def decoder_geometry(kind: str) -> dict:
    return dict(
        d_model=E, num_encoder_layers=2, num_decoder_layers=2, n_head=H,
        dim_feedforward=48, positional_embedding_size=4,
        num_channels_encoder=1, num_events_encoder=CODES,
        num_channels_decoder=4, num_events_decoder=NUM_EVENTS, dropout=0.0,
        total_upscaling=16, source_vocab_size=CODE_VOCAB, **KINDS[kind])


def _jax_decoder(kind: str):
    return JaxDecoder(data_processor=JaxProcessor(
        embedding_size=12, num_events=NUM_EVENTS, num_tokens_per_channel=VOCABS),
        encoder_attention_type="anticausal", **decoder_geometry(kind))


@functools.lru_cache(maxsize=None)
def _jax_apply(kind: str):
    """The JAX decoder's apply, compiled once per model and shared by the
    weights test and JAX's dump."""
    return jax.jit(_jax_decoder(kind).apply,
                   static_argnames=("training", "collect_attentions"))


@functools.lru_cache(maxsize=None)
def _inputs():
    """source (2, 4) codes, target (2, 16, 4) tokens."""
    rng = np.random.RandomState(3)
    source = rng.randint(0, CODE_VOCAB, (2, CODES)).astype(np.int32)
    target = np.stack([rng.randint(0, v, (2, NUM_EVENTS)) for v in VOCABS],
                      -1).astype(np.int32)
    return source, target


@functools.lru_cache(maxsize=None)
def decoder_params(kind: str):
    source, target = _inputs()
    return jax.tree.map(jnp.asarray, random_params(
        _jax_decoder(kind).init, RNGS, jnp.asarray(source), jnp.asarray(target)))


@functools.lru_cache(maxsize=None)
def decoder_case(kind: str):
    """(JAX's collect_attentions=True output, the port decoder with the same
    weights, source, target)."""
    source, target = _inputs()
    params = decoder_params(kind)
    want = _jax_apply(kind)({"params": params}, jnp.asarray(source),
                            jnp.asarray(target), training=False,
                            collect_attentions=True)
    dec = Decoder(BachDataProcessor(12, NUM_EVENTS, VOCABS), "anticausal",
                  **decoder_geometry(kind)).eval()
    dec.load_state_dict(convert.decoder_state_dict(params), strict=True)
    return jax.device_get(want), dec, source, target


def port_forward(dec, source, target, collect=True):
    with torch.no_grad():
        return dec(_t(source), _t(target), collect_attentions=collect)


@pytest.mark.parametrize("kind", list(KINDS))
def test_decoder_layer_weights_match_jax(kind):
    """Every layer's self and cross weights (B, H, T, S), the same Nones."""
    want, dec, source, target = decoder_case(kind)
    got = port_forward(dec, source, target)
    assert len(got["attentions_decoder"]) == len(want["attentions_decoder"]) == 2
    crosses = 0
    for g, w in zip(got["attentions_decoder"], want["attentions_decoder"]):
        assert set(g) == set(w) == {"a_self_decoder", "a_cross"}
        for name in g:
            if w[name] is None:
                assert g[name] is None, name
                continue
            crosses += name == "a_cross"
            assert g[name].shape == w[name].shape, name
            np.testing.assert_allclose(g[name].numpy(), w[name], rtol=0, atol=ATOL)
        assert g["a_self_decoder"].shape == (2, H, NUM_EVENTS * 4, NUM_EVENTS * 4)
    assert crosses == (0 if KINDS[kind]["cross_attention_type"] == "diagonal" else 2)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_decoder_without_collection_returns_no_maps_and_the_same_loss(kind):
    _, dec, source, target = decoder_case(kind)
    plain = port_forward(dec, source, target, collect=False)
    collected = port_forward(dec, source, target)
    assert plain["attentions_decoder"] == []
    assert torch.equal(plain["loss"], collected["loss"])


@pytest.mark.parametrize("attn_name", ["self_attn", "multihead_attn"])
def test_need_weights_changes_nothing_on_the_cpu(attn_name):
    """The CPU takes the plain path whatever need_weights says (on the card
    it picks the plain path over the kernels): an AC/AC/C decoder layer's
    self- and cross-attention give the same output and weights bit for bit
    either way."""
    _, dec, source, target = decoder_case("AC_AC_C")
    attn = getattr(dec.transformer["decoder"].layers[0], attn_name)
    with torch.no_grad():
        tgt = dec.shift_with_sos(dec.embed_target(_t(target)))
        t_len = tgt.shape[1]
        if attn_name == "self_attn":
            key, mask = tgt, causal_mask(t_len)
        else:
            key = dec.encode_memory(_t(source))
            mask = dec.cross_mask(key.shape[1], t_len)
        out, weights = attn(tgt, key, attn_mask=mask)
        out_w, weights_w = attn(tgt, key, attn_mask=mask, need_weights=True)
    assert weights is not None
    assert torch.equal(out, out_w) and torch.equal(weights, weights_w)


def test_encoder_stack_collection_matches_jax():
    """TransformerEncoder(collect_attentions=True): (output, one
    {'a_self_encoder'} dict per layer), relative bias, anticausal mask,
    against JAX's stack; the output alone without the flag."""
    t = 12
    kw = dict(num_layers=2, d_model=E, n_head=H,
              attention_bias_type="relative_attention", num_channels=1,
              num_events=t, dim_feedforward=48, dropout=0.0)
    x = np.random.RandomState(5).randn(2, t, E).astype(np.float32)
    jstack = JaxEncoderStack(**kw)
    params = random_params(jstack.init, RNGS, jnp.asarray(x), jax_anticausal(t))
    want_out, want = jax.jit(functools.partial(
        jstack.apply, collect_attentions=True))(
        {"params": params}, jnp.asarray(x), jax_anticausal(t))
    stack = TransformerEncoder(**kw).eval()
    stack.load_state_dict(convert._transformer_stack(params, ""), strict=True)
    with torch.no_grad():
        out, got = stack(_t(x), anticausal_mask(t), collect_attentions=True)
        alone = stack(_t(x), anticausal_mask(t))
    assert torch.equal(alone, out)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=1e-4)
    assert [set(g) for g in got] == [{"a_self_encoder"}] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["a_self_encoder"].numpy(),
                                   np.asarray(w["a_self_encoder"]), rtol=0, atol=ATOL)


# ---- the dump and the plots -----------------------------------------------------

def test_dump_attention_maps_writes_jax_file_names(tmp_path, monkeypatch):
    """DecoderTrainer.dump_attention_maps over a small random encoder and
    the AC/AC/C decoder above, and JAX's DecoderTrainer.dump_attention_maps
    on the same decoder, weights and codes (its trainer's fields only: the
    encode, the decoder, the params, model_dir; its plot records the path):
    the same layer{i}_{name}.pdf files under model_dir/attention_maps, the
    port's non-empty; the decoder's mode given back."""
    _, dec, _, target = decoder_case("AC_AC_C")
    torch.manual_seed(0)
    encoder = Encoder(
        BachCPCDataProcessor(16, NUM_EVENTS, VOCABS, num_tokens_per_block=16),
        GruDownscaler(16, 3, [16], 32, num_layers=1, dropout=0.0,
                      bidirectional=True),
        ProductVectorQuantizer(CODE_VOCAB, 3, 0.25, 1))
    ours = PortDecoderTrainer(encoder, copy.deepcopy(dec).train(), CODE_VOCAB,
                              device="cpu", model_dir=str(tmp_path / "port"))
    got = ours.dump_attention_maps(target)
    assert ours.decoder.training
    codes = ours.encode_codes(_t(target)).numpy().astype(np.int32)
    jax_trainer = types.SimpleNamespace(
        model_dir=str(tmp_path / "jax"), encoder_variables=None,
        decoder=types.SimpleNamespace(apply=_jax_apply("AC_AC_C")),
        _encode_codes=lambda variables, x: jnp.asarray(codes),
        state=types.SimpleNamespace(params=decoder_params("AC_AC_C")))
    monkeypatch.setattr(jax_analysis, "plot_attention", lambda att, path: path)
    want = JaxDecoderTrainer.dump_attention_maps(jax_trainer, target)
    names = [f"layer{i}_{n}.pdf" for i in range(2)
             for n in ("a_self_decoder", "a_cross")]
    assert [os.path.basename(p) for p in want] == names
    assert [os.path.basename(p) for p in got] == names
    assert all(os.path.dirname(p) == str(tmp_path / "port" / "attention_maps")
               for p in got)
    assert all(os.path.getsize(p) > 0 for p in got)


def test_plot_attention_writes_a_pdf_under_jax_name(tmp_path):
    att = np.random.RandomState(0).dirichlet(np.ones(6), size=(2, 3, 6))
    want = jax_analysis.plot_attention(att, str(tmp_path / "jax" / "layer0_a_cross.pdf"))
    got = analysis.plot_attention(att, str(tmp_path / "port" / "layer0_a_cross.pdf"))
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.getsize(got) > 0


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_scatterplot_clusters_3d_writes_a_pdf_under_jax_name(dim, tmp_path):
    """1- and 2-d codewords are zero-padded to 3 axes, as in JAX."""
    codebooks = np.random.RandomState(dim).randn(1, 8, dim).astype(np.float32)
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    want = jax_analysis.scatterplot_clusters_3d(codebooks, str(tmp_path / "jax"))
    got = analysis.scatterplot_clusters_3d(codebooks, str(tmp_path / "port"))
    assert os.path.basename(got) == os.path.basename(want) == "clusters_scatter.pdf"
    assert os.path.getsize(got) > 0


@pytest.mark.parametrize("package,plot", [
    ("matplotlib", "plot_attention"), ("seaborn", "plot_attention"),
    ("matplotlib", "scatterplot_clusters_3d")])
def test_plots_without_their_package_raise_naming_it(package, plot, tmp_path,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)
    args = ((np.ones((1, 1, 2, 2)) / 2, str(tmp_path / "a.pdf"))
            if plot == "plot_attention" else (np.ones((1, 4, 3)), str(tmp_path)))
    with pytest.raises(ImportError, match=package):
        getattr(analysis, plot)(*args)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    shutil.copy(os.path.join(REPO, "tests", "configs", "encoder_smoke.py"),
                tmp_path / "configs" / "encoder_smoke.py")
    monkeypatch.chdir(tmp_path)
    # the corpus windows are cached here, not in the checkout's data/
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    return tmp_path


def test_encoder_cli_writes_the_cluster_scatter(workdir, capsys, monkeypatch):
    """-t writes clusters_scatter.pdf (codebook_dim 3); -l writes it again;
    -l without matplotlib says it was not written and exits 0."""
    assert main_encoder.main(["-t", "-c", "configs/encoder_smoke.py",
                              "--device", "cpu"]) == 0
    (model_dir,) = glob.glob(str(workdir / "models" / "encoder_smoke_*"))
    scatter = os.path.join(model_dir, "clusters_scatter.pdf")
    assert os.path.getsize(scatter) > 0
    os.remove(scatter)
    config = os.path.join(model_dir, "config.py")
    assert main_encoder.main(["-l", "-c", config, "--device", "cpu"]) == 0
    assert os.path.getsize(scatter) > 0
    os.remove(scatter)
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert main_encoder.main(["-l", "-c", config, "--device", "cpu"]) == 0
    assert "clusters_scatter.pdf not written" in capsys.readouterr().out
    assert not os.path.exists(scatter)


# ---- the data layer -------------------------------------------------------------

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX dataset, port dataset) over the same synthetic corpus, each with
    its own cache."""
    tmp = tmp_path_factory.mktemp("datasets")
    kw = dict(num_chorales=3, min_beats=8, max_beats=10, seed=0)
    return (JaxDataset(JaxCorpus(**kw), 4, cache_root=str(tmp / "jax")),
            ChoraleBeatsDataset(SyntheticChoraleCorpus(**kw), 4,
                                cache_root=str(tmp / "port")))


def test_dataset_vocabulary_properties_match_jax(datasets):
    jds, ds = datasets
    assert ds.note2index_dicts == jds.note2index_dicts
    assert ds.index2note_dicts == jds.index2note_dicts
    assert list(ds.num_tokens_per_channel) == list(jds.num_tokens_per_channel)
    assert ds.num_voices == jds.num_voices == 4


@pytest.mark.parametrize("start,end", [(-5, 6), (-1, 3), (0, 10), (2, 7),
                                       (6, 14), (9, 11), (-3, 13)])
def test_extract_with_padding_matches_jax(datasets, start, end):
    """A (4, 10) grid: windows inside, across either edge and across both;
    START / END next to the score, PAD beyond, bit for bit."""
    jds, ds = datasets
    grid = np.random.RandomState(start + 7).randint(0, 5, (4, 10)).astype(np.int32)
    vocab = Vocabulary(note2index_dicts=ds.note2index_dicts,
                       voice_ranges=ds.vocabulary.voice_ranges)
    got = extract_with_padding(grid, start, end, vocab)
    want = jax_extract(grid, start, end, jds.vocabulary)
    assert got.shape == (4, end - start)
    np.testing.assert_array_equal(got, want)
