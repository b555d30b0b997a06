"""The port's native host-pipeline routines (vqcpcb_tpu_torch/native:
tokenizer.cpp, built with g++ at first use) against the JAX package's
native routines (vqcpcb_tpu/native) and the port's NumPy paths
(VQCPCB_NATIVE=0), bit for bit: the articulation loop (part_to_ticks), the
window extraction (extract_windows_batch, and through it whole window
datasets of the synthetic corpus and of a small written MIDI corpus) and
the same-sequence CPC negatives; the knobs, JAX's argument checks, and a
build without a compiler, which raises."""
import os
import shutil
import sys
import types

import numpy as np
import pytest

from vqcpcb_tpu import native as jax_native
from vqcpcb_tpu.data import corpora as jax_corpora
from vqcpcb_tpu.data import dataloaders as jax_dataloaders
from vqcpcb_tpu.data import midi as jax_midi
from vqcpcb_tpu.data import tokenizer as jax_tokenizer
from vqcpcb_tpu_torch import native
from vqcpcb_tpu_torch.data import corpora, dataloaders, midi, tokenizer
from vqcpcb_tpu_torch.data.vocab import SLUR_SYMBOL, Vocabulary, midi_of_plain_name

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_corpora import _midi_root  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def jax_native_built(tmp_path_factory):
    """The JAX package's native library loaded (built, if no test of this
    process has loaded it yet, into a temporary cache: its default is under
    the home directory)."""
    if jax_native.lib() is None:
        saved = os.environ.get("VQCPCB_NATIVE_CACHE")
        os.environ["VQCPCB_NATIVE_CACHE"] = str(tmp_path_factory.mktemp("jax_native"))
        try:
            assert jax_native.build() is not None
            jax_native._tried = False
            assert jax_native.lib() is not None
        finally:
            if saved is None:
                os.environ.pop("VQCPCB_NATIVE_CACHE", None)
            else:
                os.environ["VQCPCB_NATIVE_CACHE"] = saved


def _numpy(monkeypatch, fn, *args):
    """fn(*args) on the port's NumPy paths (VQCPCB_NATIVE=0), the native
    library made unreachable meanwhile."""
    with monkeypatch.context() as m:
        m.setenv("VQCPCB_NATIVE", "0")
        m.setattr(native, "library", _unreachable)
        return fn(*args)


def _unreachable():
    raise AssertionError("the native library was called under VQCPCB_NATIVE=0")


def _equal(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _events(module, rng, n, lo=50, hi=70):
    """n events of `module`'s NeutralEvent: notes (some out of [lo, hi)),
    rests, onsets on a 16th grid, some of them on the window's edges."""
    onsets = np.sort(rng.choice(np.arange(-4, 24), size=n, replace=False)) / 4.0
    out = []
    for onset in onsets:
        if rng.rand() < 0.15:
            out.append(module.NeutralEvent(float(onset), "rest", None, False))
        else:
            m = int(rng.randint(lo - 5, hi + 5))
            out.append(module.NeutralEvent(float(onset), f"p{m}", m, True))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_part_to_ticks_matches_jax_native_and_numpy(monkeypatch, seed):
    """One part's ticks over windows starting before, at and inside the
    part (out-of-range notes as OUT_OF_RANGE, rests, slurs, an empty
    window): the port's native route, its NumPy route and JAX's native
    route give the same int64 ticks."""
    rng = np.random.RandomState(seed)
    n2i = {f"p{m}": m - 40 for m in range(40, 80)}
    n2i.update({SLUR_SYMBOL: 50, "OOR": 51, "rest": 52})
    for n, (start, end) in zip((6, 9, 1, 12), ((0.0, 4.0), (-1.0, 3.0),
                                               (30.0, 32.0), (1.25, 6.0))):
        port_events = _events(tokenizer, np.random.RandomState(seed * 7 + n), n)
        jax_events = [jax_tokenizer.NeutralEvent(e.offset, e.name, e.midi, e.is_note)
                      for e in port_events]
        args = (n2i, (50, 69), 4, start, end)
        got = tokenizer.part_to_ticks(port_events, *args)
        _equal(got, jax_tokenizer.part_to_ticks(jax_events, *args))
        _equal(got, _numpy(monkeypatch, tokenizer.part_to_ticks, port_events, *args))


def test_extract_windows_matches_jax_native_and_numpy(monkeypatch):
    """Windows of a (4, 40) grid starting before it (PAD, START), inside it
    and past its end (END, PAD): the three routes agree, int32."""
    note_sets = [{f"p{m}" for m in range(50, 60)} for _ in range(4)]
    vocab = Vocabulary.from_note_sets(note_sets, midi_of_plain_name)
    jvocab = jax_tokenizer.Vocabulary.from_note_sets(note_sets, midi_of_plain_name)
    grid = np.random.RandomState(0).randint(0, 10, size=(4, 40)).astype(np.int32)
    starts = np.array([-12, -5, -1, 0, 10, 30, 32, 36, 39, 40, 45], dtype=np.int64)
    got = tokenizer.extract_windows_batch(grid, starts, 8, vocab)
    _equal(got, jax_tokenizer.extract_windows_batch(grid, starts, 8, jvocab))
    _equal(got, _numpy(monkeypatch, tokenizer.extract_windows_batch, grid, starts,
                       8, vocab))


def _corpora(kind, tmp_path):
    """(the port corpus, the JAX corpus) of the synthetic kind or over a
    written MIDI corpus (6 scores, a corrupt and a two-voice file)."""
    if kind == "synthetic":
        kw = dict(num_chorales=5, min_beats=12, max_beats=20, seed=4)
        return corpora.SyntheticChoraleCorpus(**kw), jax_corpora.SyntheticChoraleCorpus(**kw)
    root = str(_midi_root(tmp_path))
    return midi.MidiCorpus(root), jax_midi.MidiCorpus(root)


@pytest.mark.parametrize("kind", ["synthetic", "midi"])
def test_window_datasets_match_jax_native_and_numpy(tmp_path, monkeypatch, kind):
    """A whole corpus's windows with every transposition (make_window_dataset:
    part_to_ticks and extract_windows_batch on each score) are the same
    array on the port's native route, its NumPy route and JAX's native
    route."""
    corpus, jcorpus = _corpora(kind, tmp_path)
    vocab, jvocab = corpus.build_vocabulary(), jcorpus.build_vocabulary()
    got = tokenizer.make_window_dataset(list(corpus), vocab, 2, 4)
    assert len(got) > 50
    _equal(got, jax_tokenizer.make_window_dataset(list(jcorpus), jvocab, 2, 4))
    _equal(got, _numpy(monkeypatch, tokenizer.make_window_dataset, list(corpus),
                       vocab, 2, 4))


def _negatives(module, x_left, x_right, tokens_per_block=16):
    owner = types.SimpleNamespace(num_tokens_per_block=tokens_per_block)
    return module.BachCPCDataloaderGenerator._build_negatives_same_seq(
        owner, x_left, x_right)


@pytest.mark.parametrize("left,right", [(2, 2), (3, 2), (2, 3)])
def test_negatives_same_seq_match_jax_native_and_numpy(monkeypatch, left, right):
    """The same-sequence negatives of (B, L*tb, 4) and (B, R*tb, 4) blocks,
    both directions (the backward one swaps the block counts): the three
    routes agree, int32."""
    rng = np.random.RandomState(left * 10 + right)
    x_left = rng.randint(0, 50, size=(3, left * 4, 4)).astype(np.int32)
    x_right = rng.randint(0, 50, size=(3, right * 4, 4)).astype(np.int32)
    for a, b in ((x_left, x_right), (x_right, x_left)):
        got = _negatives(dataloaders, a, b)
        assert got.shape == (3, left + right - 1, b.shape[1] // 4, 4, 4)
        _equal(got, _negatives(jax_dataloaders, a, b))
        _equal(got, _numpy(monkeypatch, _negatives, dataloaders, a, b))


@pytest.mark.parametrize("kind", ["synthetic", "midi"])
def test_same_sequence_cpc_batches_match_jax_native_and_numpy(tmp_path, monkeypatch,
                                                              kind):
    """The CPC loader with same-sequence negatives (3 + 2 blocks of 16
    tokens: both directions with unequal block counts) over each corpus:
    the first train and val batches, negatives both ways included, are the
    same arrays on the port's native route, its NumPy route and JAX's
    native route."""
    corpus, jcorpus = _corpora(kind, tmp_path)
    cpc = dict(num_tokens_per_block=16, num_blocks_left=3, num_blocks_right=2,
               negative_sampling_method="same_sequence", num_negative_samples=1)

    def first(module, corpus_, cache):
        gen = module.BachCPCDataloaderGenerator(corpus=corpus_, cache_root=cache, **cpc)
        train, val, _ = gen.dataloaders(batch_size=2)
        return [next(train), next(val)]

    got = first(dataloaders, corpus, str(tmp_path / "port"))
    want = first(jax_dataloaders, jcorpus, str(tmp_path / "jax"))
    plain = _numpy(monkeypatch, first, dataloaders, corpus, str(tmp_path / "port"))
    assert got[0]["negative_samples"].shape == (2, 4, 2, 4, 4)
    for g, w, p in zip(got, want, plain):
        assert set(g) == set(w) == set(p)
        for key in w:
            _equal(g[key], w[key])
            _equal(g[key], p[key])


def test_native_checks_the_geometry_it_is_given():
    """JAX's argument checks (vqcpcb_tpu/native/__init__.py:131-140): block
    counts that do not match the arrays raise before any pointer is
    handed over."""
    x = np.zeros((2, 8, 4), np.int32)
    with pytest.raises(ValueError):
        native.build_negatives_same_seq_native(x, x, 3, 2, 4)
    with pytest.raises(ValueError):
        native.build_negatives_same_seq_native(x, x[:, :4], 2, 2, 4)
    with pytest.raises(ValueError):
        native.part_to_ticks_native(np.zeros(3), np.zeros(2, np.int32), 8, 4, 0.0, 1)


def test_native_is_the_default_route_and_the_knob_selects_numpy(monkeypatch):
    """Unset, VQCPCB_NATIVE takes the native library (its loader called);
    VQCPCB_NATIVE=0 never reaches it."""
    calls = []
    loader = native.library

    def counting():
        calls.append(1)
        return loader()
    monkeypatch.setattr(native, "library", counting)
    monkeypatch.delenv("VQCPCB_NATIVE", raising=False)
    grid = np.arange(8, dtype=np.int32).reshape(4, 2)
    vocab = corpora.SyntheticChoraleCorpus(num_chorales=1).build_vocabulary()
    tokenizer.extract_windows_batch(grid, np.array([0], np.int64), 2, vocab)
    assert calls
    monkeypatch.setenv("VQCPCB_NATIVE", "0")
    monkeypatch.setattr(native, "library", _unreachable)
    tokenizer.extract_windows_batch(grid, np.array([0], np.int64), 2, vocab)


def test_prebuilt_library_knob_and_a_missing_compiler(tmp_path, monkeypatch):
    """VQCPCB_NATIVE_LIB names the library to load (a copy of the built
    one, loaded from its own path); without it and without a library for
    this source, a build with no compiler on PATH raises, naming
    VQCPCB_NATIVE=0, where JAX falls back to NumPy without a word; with
    VQCPCB_NATIVE=0 the data layer builds windows all the same."""
    copy = tmp_path / "prebuilt.so"
    shutil.copy(native.build(), copy)
    monkeypatch.setenv("VQCPCB_NATIVE_LIB", str(copy))
    out = native.extract_windows_native(np.zeros((4, 3), np.int32),
                                        np.array([-1], np.int64), 2, *([0] * 4,) * 3)
    assert str(copy) in native._LIBS
    np.testing.assert_array_equal(out[0, :, 0], 0)
    monkeypatch.delenv("VQCPCB_NATIVE_LIB")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})       # nothing loaded yet
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="VQCPCB_NATIVE=0"):
        native.part_to_ticks_native(np.zeros(1), np.zeros(1, np.int32), 4, 4, 0.0, 1)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())
    monkeypatch.setenv("VQCPCB_NATIVE", "0")
    events = [tokenizer.NeutralEvent(0.0, "p60", 60, True)]
    ticks = tokenizer.part_to_ticks(events, {"p60": 3, SLUR_SYMBOL: 1}, (50, 70), 4,
                                    0.0, 1.0)
    np.testing.assert_array_equal(ticks, [3, 1, 1, 1])
