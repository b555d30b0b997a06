"""The port's file corpora (data/filecorpus.py, data/midi.py,
data/musicxml.py), its corpus writer and the getters' routing, against the
JAX package on the same bytes: the SMF parser's byte cases of
tests/test_midi_musicxml.py, parametrised; MidiCorpus and MusicXmlCorpus
(with an .mxl) over fixtures written in tmp_path by the port's writer:
scores, skipped files, vocabulary, cache key, and the decoder's and CPC's
windows and batches; malformed MusicXML; the writer's bytes and key against
scripts/make_midi_corpus.py; and the encoder CLI on a tiny-width copy of
configs/encoder_scaleup_midi.py over a written corpus, then the decoder CLI
over the run directory's copied config.py. Each side builds its own window
cache under tmp_path."""
import os
import runpy
import shutil
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch

from vqcpcb_tpu.data import dataloaders as jax_dataloaders
from vqcpcb_tpu.data import midi as jax_midi
from vqcpcb_tpu.data import musicxml as jax_musicxml
from vqcpcb_tpu.data import tokenizer as jax_tokenizer
from vqcpcb_tpu_torch import getters, main_decoder, main_encoder, make_midi_corpus
from vqcpcb_tpu_torch.data import corpora as port_corpora
from vqcpcb_tpu_torch.data import dataloaders, midi, musicxml, tokenizer
from vqcpcb_tpu_torch.data import dataset as port_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_midi_musicxml import _header, _simple_partwise_xml, _track  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _score(score):
    """A NeutralScore as plain data: per part (offset, name, midi, is_note)."""
    if score is None:
        return None
    return ([[(e.offset, e.name, e.midi, e.is_note) for e in part]
             for part in score.parts], score.highest_time)


def _notes(notes):
    return [(n.onset_tick, n.off_tick, n.pitch, n.channel) for n in notes]


# ---- the SMF parser on bytes -------------------------------------------------

def _format0(data1: bytes) -> bytes:
    """A format-1 file's note tracks merged into one format-0 track."""
    smf = jax_midi.parse_smf(data1)
    merged = sorted((e for t in smf["tracks"][1:] for e in t if e[1] != 0xFF),
                    key=lambda e: e[0])
    body, tick = bytearray(), 0
    for abs_tick, status, payload in merged:
        body += jax_midi._vlq(abs_tick - tick) + bytes([status]) + payload
        tick = abs_tick
    return _header(0, 1, division=8) + _track(bytes(body))


_FOUR = [[(0.0, 1.0, p), (1.0, 1.0, p + 2)] for p in (72, 65, 57, 48)]
SMF_CASES = {
    # running status, a velocity-0 note-on as the off, a 2-byte delta
    "running_status_vel0": _header(0, 1) + _track(
        b"\x00\x90\x3c\x40\x04\x3c\x00\x81\x48\x90\x3e\x40\x04\x80\x3e\x00"),
    # a tempo meta event and an alien chunk before the track
    "tempo_and_alien_chunk": _header(1, 1) + b"XFIH" + struct.pack(">I", 3)
    + b"abc" + _track(b"\x00\xff\x51\x03\x07\xa1\x20"
                      b"\x00\x90\x30\x40\x08\x80\x30\x00"),
    "smpte_division": struct.pack(">4sIHHh", b"MThd", 6, 0, 1, -25 * 256 + 40)
    + _track(b"\x00\x90\x3c\x40\x04\x80\x3c\x00"),
    "format1_tracks": jax_midi.write_smf(_FOUR, division=8, fmt=1),
    "format0_channels": _format0(jax_midi.write_smf(_FOUR, division=8, fmt=1)),
    "chord_and_rest_gap": jax_midi.write_smf(
        [[(0.0, 1.0, 60), (0.0, 1.0, 64), (2.0, 1.0, 62)]] * 4, division=16),
    "status_0xF3": _header(0, 1) + _track(
        b"\x00\xf3\x05\x00\x90\x3c\x50\x10\x80\x3c\x00\x00\xff\x2f\x00"),
    "status_0xF8": _header(0, 1) + _track(
        b"\x00\xf8\x05\x00\x90\x3c\x50\x10\x80\x3c\x00\x00\xff\x2f\x00"),
    "too_few_voices": jax_midi.write_smf([[(0.0, 1.0, 60)], [(0.0, 1.0, 50)]],
                                         division=8),
    "truncated": b"MThd\x00\x00\x00\x06junk",
}


def _both(fn_port, fn_jax, *args):
    """(port result, JAX result), or each side's MidiParseError message."""
    out = []
    for fn, err in ((fn_port, midi.MidiParseError),
                    (fn_jax, jax_midi.MidiParseError)):
        try:
            out.append(fn(*args))
        except err as exc:
            out.append(("MidiParseError", str(exc)))
    return out


@pytest.mark.parametrize("case", sorted(SMF_CASES))
def test_smf_parser_matches_jax_on_bytes(case):
    """parse_smf, track_notes of every track and smf_to_neutral: equal to
    JAX's on the same bytes, errors with the same message."""
    data = SMF_CASES[case]
    got, want = _both(midi.parse_smf, jax_midi.parse_smf, data)
    assert got == want
    if isinstance(want, dict):
        assert ([_notes(midi.track_notes(t)) for t in got["tracks"]]
                == [_notes(jax_midi.track_notes(t)) for t in want["tracks"]])
    got, want = _both(lambda d: _score(midi.smf_to_neutral(d)),
                      lambda d: _score(jax_midi.smf_to_neutral(d)), data)
    assert got == want
    if case.startswith("format"):
        assert [p[0][2] for p in got[0]] == [72, 65, 57, 48]   # soprano first


def test_vlq_round_trip():
    for v in (0, 1, 0x7F, 0x80, 200, 0x3FFF, 0x4000, 0x0FFFFFFF):
        enc = midi._vlq(v)
        assert enc == jax_midi._vlq(v)
        assert midi._read_vlq(enc, 0) == (v, len(enc))


# ---- MusicXML ------------------------------------------------------------------

_BAD_XML = {
    "backup_without_duration": b"""<score-partwise><part id="P1"><measure number="1">
      <attributes><divisions>2</divisions></attributes>
      <note><pitch><step>C</step><octave>4</octave></pitch><duration>2</duration></note>
      <backup/></measure></part></score-partwise>""",
    "garbage_duration": b"""<score-partwise><part id="P1"><measure number="1">
      <attributes><divisions>2</divisions></attributes>
      <note><pitch><step>C</step><octave>4</octave></pitch><duration>x</duration></note>
      </measure></part></score-partwise>""",
    "missing_octave": b"""<score-partwise><part id="P1"><measure number="1">
      <attributes><divisions>2</divisions></attributes>
      <note><pitch><step>C</step></pitch><duration>2</duration></note>
      </measure></part></score-partwise>""",
    "not_partwise": b"<not-music/>",
    "not_xml": b"<score-partwise><part>",
}


@pytest.mark.parametrize("case", sorted(_BAD_XML))
def test_malformed_musicxml_raises_in_both(case):
    with pytest.raises(jax_musicxml.MusicXmlParseError) as want:
        jax_musicxml.parse_musicxml(_BAD_XML[case])
    with pytest.raises(musicxml.MusicXmlParseError) as got:
        musicxml.parse_musicxml(_BAD_XML[case])
    assert str(got.value) == str(want.value)


_CHORD = b"""<score-partwise><part id="P1"><measure number="1">
  <attributes><divisions>2</divisions></attributes>
  <note><pitch><step>C</step><octave>4</octave></pitch><duration>1</duration></note>
  <note><pitch><step>E</step><octave>4</octave></pitch><duration>2</duration></note>
  <note><chord/><pitch><step>G</step><octave>4</octave></pitch><duration>4</duration></note>
  <backup><duration>3</duration></backup>
  <note><pitch><step>C</step><octave>3</octave></pitch><duration>3</duration>
    <voice>2</voice></note>
  </measure></part></score-partwise>"""


@pytest.mark.parametrize("data", [_simple_partwise_xml(), _CHORD],
                         ids=["ties_alter_chord_rest", "unequal_chord_backup"])
def test_musicxml_streams_and_scores_match_jax(data):
    assert musicxml.parse_musicxml(data) == jax_musicxml.parse_musicxml(data)
    for voices in (1, 2, 4):
        assert (_score(musicxml.musicxml_to_neutral(data, voices))
                == _score(jax_musicxml.musicxml_to_neutral(data, voices)))


# ---- the corpora ------------------------------------------------------------------

def _midi_root(tmp_path, num=6):
    """num scores of the port's writer (16-24 beats), a corrupt file and a
    two-voice file."""
    root = tmp_path / "midis"
    make_midi_corpus.write_corpus(str(root), num=num, min_beats=16,
                                  max_beats=24, seed=3)
    (root / "corrupt.mid").write_bytes(b"MThd\x00\x00\x00\x06junk")
    (root / "sub").mkdir()
    (root / "sub" / "duo.midi").write_bytes(midi.write_smf(
        [[(0.0, 1.0, 60)], [(0.0, 1.0, 50)]], division=8))
    return root


def _xml_root(tmp_path):
    root = tmp_path / "xmls"
    root.mkdir()
    (root / "a.xml").write_bytes(_simple_partwise_xml())
    with zipfile.ZipFile(root / "b.mxl", "w") as z:
        z.writestr("META-INF/container.xml",
                   '<container><rootfiles><rootfile full-path="score.xml"/>'
                   "</rootfiles></container>")
        z.writestr("score.xml", _simple_partwise_xml())
    with zipfile.ZipFile(root / "c.mxl", "w") as z:        # no manifest
        z.writestr("score.xml", _simple_partwise_xml().replace(b">5<", b">4<"))
    (root / "bad.xml").write_bytes(_BAD_XML["garbage_duration"])
    (root / "broken.mxl").write_bytes(b"not a zip")
    return root


CORPORA = {"midi": (lambda tmp: _midi_root(tmp), midi.MidiCorpus,
                    jax_midi.MidiCorpus),
           "musicxml": (lambda tmp: _xml_root(tmp), musicxml.MusicXmlCorpus,
                        jax_musicxml.MusicXmlCorpus)}


@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_corpus_scores_skips_vocabulary_and_key_match_jax(tmp_path, capsys, kind):
    make_root, port_cls, jax_cls = CORPORA[kind]
    root = str(make_root(tmp_path))
    corpus, jcorpus = port_cls(root), jax_cls(root)
    capsys.readouterr()
    got = [_score(s) for s in corpus]
    port_log = capsys.readouterr().out
    want = [_score(s) for s in jcorpus]
    assert port_log == capsys.readouterr().out
    assert got == want and len(got) == (6 if kind == "midi" else 3)
    assert port_log.count("skipping") == 2
    assert corpus.cache_key == jcorpus.cache_key
    assert corpus.cache_key.startswith(f"{kind}_")
    vocab, jvocab = corpus.build_vocabulary(), jcorpus.build_vocabulary()
    assert vocab.note2index_dicts == jvocab.note2index_dicts
    assert vocab.voice_ranges == jvocab.voice_ranges
    np.testing.assert_array_equal(
        tokenizer.make_window_dataset(corpus, vocab, 2, 4),
        jax_tokenizer.make_window_dataset(jcorpus, jvocab, 2, 4))
    assert port_cls(root, max_files=2).cache_key == jax_cls(root, max_files=2).cache_key
    assert port_cls(root, max_files=2).cache_key != corpus.cache_key


def test_cache_key_follows_contents_not_times(tmp_path):
    root = _midi_root(tmp_path, num=2)
    key = midi.MidiCorpus(str(root)).cache_key
    path = root / "chorale_00000.mid"
    data = path.read_bytes()
    path.write_bytes(data)
    os.utime(path, (1e9, 1e9))
    assert midi.MidiCorpus(str(root)).cache_key == key
    path.write_bytes(data[:-10] + bytes([data[-10] ^ 1]) + data[-9:])
    assert midi.MidiCorpus(str(root)).cache_key != key


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_decoder_and_cpc_batches_match_jax(tmp_path, kind):
    """The decoder's windows (sequences of 4 beats) and the CPC's (blocks of
    16 tokens, 2 + 2 blocks, 3 random negatives): each side's cached
    windows, then the first train and val batches."""
    make_root, port_cls, jax_cls = CORPORA[kind]
    root = str(make_root(tmp_path))
    gens = [(dataloaders.BachDataloaderGenerator(
                 4, port_cls(root), cache_root=str(tmp_path / "port")),
             jax_dataloaders.BachDataloaderGenerator(
                 4, jax_cls(root), cache_root=str(tmp_path / "jax")))]
    cpc = dict(num_tokens_per_block=16, num_blocks_left=2, num_blocks_right=2,
               negative_sampling_method="random", num_negative_samples=3)
    gens.append((dataloaders.BachCPCDataloaderGenerator(
                     corpus=port_cls(root), cache_root=str(tmp_path / "port"), **cpc),
                 jax_dataloaders.BachCPCDataloaderGenerator(
                     corpus=jax_cls(root), cache_root=str(tmp_path / "jax"), **cpc)))
    for gen, jgen in gens:
        np.testing.assert_array_equal(gen.dataset.windows, jgen.dataset.windows)
        assert len(gen.dataset.windows) > 20
        train, val, _ = gen.dataloaders(batch_size=2)
        jtrain, jval, _ = jgen.dataloaders(batch_size=2)
        _assert_batches_equal(next(train), next(jtrain))
        _assert_batches_equal(next(val), next(jval))


# ---- the writer ---------------------------------------------------------------------

def test_writer_gives_the_jax_scripts_bytes_and_key(tmp_path, monkeypatch, capsys):
    out, jout = tmp_path / "port", tmp_path / "jax"
    assert make_midi_corpus.main(["--out", str(out), "--num", "8"]) == 0
    monkeypatch.setattr(sys, "argv", ["make_midi_corpus.py", "--out", str(jout),
                                      "--num", "8"])
    runpy.run_path(os.path.join(REPO, "scripts", "make_midi_corpus.py"),
                   run_name="__main__")
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == names and len(names) == 8
    for name in names:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name
    assert (midi.MidiCorpus(str(out)).cache_key
            == jax_midi.MidiCorpus(str(jout)).cache_key)
    assert capsys.readouterr().out.count("wrote 8 .mid files") == 2


def test_neutral_to_smf_matches_jax_and_parses_back():
    from vqcpcb_tpu.data.corpora import SyntheticChoraleCorpus as JaxSynthetic
    from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
    for score, jscore in zip(SyntheticChoraleCorpus(3, 8, 12, seed=1),
                             JaxSynthetic(3, 8, 12, seed=1)):
        data = midi.neutral_to_smf(score)
        assert data == jax_midi.neutral_to_smf(jscore)
        back = midi.smf_to_neutral(data)
        assert _score(back) == _score(jax_midi.smf_to_neutral(data))
        assert back.highest_time == score.highest_time


# ---- the getters and the CLIs --------------------------------------------------------

def test_getters_route_the_file_corpora(tmp_path):
    root = str(_midi_root(tmp_path, num=2))
    corpus = getters._corpus_from_config(
        {"dataset": "midi", "corpus_kwargs": dict(midi_root=root, max_files=1)})
    assert isinstance(corpus, midi.MidiCorpus) and corpus.max_files == 1
    xml_root = str(_xml_root(tmp_path))
    corpus = getters._corpus_from_config(
        {"dataset": "MusicXML", "corpus_kwargs": dict(xml_root=xml_root)})
    assert isinstance(corpus, musicxml.MusicXmlCorpus)
    gen = getters.get_dataloader_generator(
        "musicxml", "decoder", dict(sequences_size=2),
        {"corpus_kwargs": dict(xml_root=xml_root)}, cache_root=str(tmp_path / "c"))
    assert gen.dataset.vocabulary.num_voices == 4
    corpus = getters._corpus_from_config({"dataset": "bach"})
    assert isinstance(corpus, port_corpora.Music21BachCorpus)
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "music21", None)       # music21 not installed
        with pytest.raises(ImportError, match="music21"):
            next(iter(corpus))


# encoder_scaleup_midi.py at a tiny width: only these strings change
_TINY = (("d_model=512", "d_model=32"), ("n_head=8", "n_head=2"),
         ("list_of_num_layers=[4, 4]", "list_of_num_layers=[1, 1]"),
         ("dim_feedforward=2048", "dim_feedforward=48"),
         ("hidden_size=512", "hidden_size=32"),
         ("num_negative_samples=15", "num_negative_samples=3"),
         ("'batch_size': 64", "'batch_size': 4"),
         ("'num_batches': None", "'num_batches': 2"),
         ("'num_epochs': 6", "'num_epochs': 1"))
_TINY_DECODER = (("d_model=512", "d_model=32"), ("n_head=8", "n_head=2"),
                 ("num_encoder_layers=3", "num_encoder_layers=1"),
                 ("num_decoder_layers=3", "num_decoder_layers=1"),
                 ("dim_feedforward=1024", "dim_feedforward=48"),
                 ("sequences_size=24", "sequences_size=4"),
                 ("'batch_size':                  32",
                  "'batch_size':                  2"),
                 ("'num_batches':                 512",
                  "'num_batches':                 2"),
                 ("'num_epochs':                  3",
                  "'num_epochs':                  1"))


def _tiny_copy(name, replacements, midi_root, dest):
    with open(os.path.join(REPO, "configs", name)) as f:
        text = f.read()
    for old, new in replacements + (("'data/midi_corpus'", repr(midi_root)),):
        assert old in text, old
        text = text.replace(old, new)
    dest.write_text(text)
    return str(dest)


def test_scaleup_midi_cli_chain_on_the_cpu(tmp_path, monkeypatch):
    """encoder -t on a tiny-width encoder_scaleup_midi.py over a written
    corpus (the EMA product quantizer of 2 x 16 codes, the linear transformer
    downscaler), then decoder -t on a tiny decoder_scaleup_midi.py whose
    config_encoder is the encoder run's copied config.py, read through
    VQCPCB_MIDI_ENCODER_CONFIG when the config is executed."""
    root = tmp_path / "midi_corpus"
    make_midi_corpus.write_corpus(str(root), num=6, min_beats=16, max_beats=24)
    (tmp_path / "configs").mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_dataset, "DEFAULT_CACHE_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("VQCPCB_WARMUP_STEPS", "2")
    config = _tiny_copy("encoder_scaleup_midi.py", _TINY, str(root),
                        tmp_path / "configs" / "encoder_scaleup_midi.py")
    assert main_encoder.main(["-t", "-c", config, "--device", "cpu"]) == 0
    (run,) = os.listdir(tmp_path / "models")
    encoder_config = str(tmp_path / "models" / run / "config.py")
    monkeypatch.setenv("VQCPCB_MIDI_ENCODER_CONFIG", encoder_config)
    config = _tiny_copy("decoder_scaleup_midi.py", _TINY_DECODER, str(root),
                        tmp_path / "configs" / "decoder_scaleup_midi.py")
    assert main_decoder.main(["-t", "-c", config, "--device", "cpu"]) == 0
    runs = sorted(os.listdir(tmp_path / "models"))
    assert len(runs) == 2 and runs[0].startswith("decoder_scaleup_midi_")
    with open(tmp_path / "models" / runs[0] / "config.py") as f:
        assert "VQCPCB_MIDI_ENCODER_CONFIG" in f.read()
    assert any(name.startswith("midi_") for name in os.listdir(tmp_path / "data"))
    shutil.rmtree(tmp_path / "models")


# ---- the music21 Bach corpus over the in-memory music21 fake ------------------------

@pytest.fixture
def fake_music21(monkeypatch):
    """tests/m21fake.py installed as sys.modules["music21"] for the test,
    its corpus.chorales.Iterator() giving 3 four-voice chorales, a
    three-voice one (skipped), a messy one (pickup beat, repeated pitches,
    a mid-voice rest) and one whose transpositions raise KeyError."""
    import types

    import m21fake
    fake = m21fake.make_module()
    base = m21fake.make_test_chorales(num=3)
    corrupt = m21fake.TransposeKeyErrorScore(
        [list(p.flat.elements) for p in m21fake.make_test_chorales(num=1, seed=17)[0].parts])
    chorales = [base[0], m21fake.make_three_voice_chorale(), m21fake.make_messy_chorale(),
                corrupt, base[1], base[2]]
    fake.corpus = types.SimpleNamespace(
        chorales=types.SimpleNamespace(Iterator=lambda: iter(chorales)))
    monkeypatch.setitem(sys.modules, "music21", fake)
    return fake


def test_bach_corpus_matches_jax_adapter_over_the_fake(fake_music21, capsys):
    """The port's Music21BachCorpus and JAX's over the same fake chorales:
    the same vocabulary (index dicts, and voice ranges widened by the
    meta-symbol pitches, the reference's quirk), the same scores, and the
    same windows with every transposition, bit for bit (the KeyError
    chorale's transposed windows dropped on both sides, the three-voice
    chorale skipped)."""
    from vqcpcb_tpu.data import corpora as jax_corpora
    corpus, jcorpus = port_corpora.Music21BachCorpus(), jax_corpora.Music21BachCorpus()
    assert corpus.cache_key == jcorpus.cache_key == "bach_m21_v4"
    vocab, jvocab = corpus.build_vocabulary(), jcorpus.build_vocabulary()
    assert vocab.note2index_dicts == jvocab.note2index_dicts
    assert vocab.voice_ranges == jvocab.voice_ranges
    assert all(lo <= 48 for lo, _ in vocab.voice_ranges)
    assert [_score(s) for s in corpus] == [_score(s) for s in jcorpus]
    assert len(list(corpus)) == 5
    capsys.readouterr()
    got = tokenizer.make_window_dataset(corpus, vocab, 2, 4)
    port_log = capsys.readouterr().out
    want = jax_tokenizer.make_window_dataset(jcorpus, jvocab, 2, 4)
    assert port_log == capsys.readouterr().out and "KeyError" in port_log
    assert got.dtype == want.dtype and len(got) > 100
    np.testing.assert_array_equal(got, want)


def test_bach_dataset_through_the_getters_matches_jax(fake_music21, tmp_path):
    """getters.get_dataloader_generator('bach', 'decoder', ...) builds the
    music21 corpus, as JAX's getters do: the same vocabulary and windows
    (sequences_size 2) as the JAX package's loader over the fake, and the
    'bach' data processor sizes its heads from that vocabulary."""
    from vqcpcb_tpu import getters as jax_getters
    gen = getters.get_dataloader_generator("bach", "decoder", dict(sequences_size=2),
                                           cache_root=str(tmp_path / "port"))
    jgen = jax_getters.get_dataloader_generator("bach", "decoder", dict(sequences_size=2),
                                                cache_root=str(tmp_path / "jax"))
    assert isinstance(gen.dataset.corpus, port_corpora.Music21BachCorpus)
    assert gen.dataset.vocabulary.note2index_dicts == jgen.dataset.vocabulary.note2index_dicts
    np.testing.assert_array_equal(gen.dataset.windows, jgen.dataset.windows)
    processor = getters.get_data_processor(gen, "bach", dict(embedding_size=8))
    assert processor.num_tokens_per_channel == \
        gen.dataset.vocabulary.num_tokens_per_channel
