"""Corpus backends producing NeutralScores, port-local copies of
vqcpcb_tpu/data/corpora.py:
  * SyntheticChoraleCorpus (:43): deterministic 4-voice scores with
    Bach-chorale statistics (SATB ranges, a 16th-note grid, held notes and
    rests) from np.random.RandomState, so the same seed gives the JAX
    package's scores;
  * Music21BachCorpus (:110-212): the 'bach' dataset, the reference's own
    corpus, over music21.corpus.chorales (4-part chorales only).

music21 is imported lazily, inside Music21BachCorpus's methods and nowhere
else in the port (tests/test_torch_isolation.py holds that): importing any
port module, or running any other dataset, never needs it, and 'bach'
without it raises an ImportError that names music21, as JAX's does.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from vqcpcb_tpu_torch.data.tokenizer import NeutralEvent, NeutralScore
from vqcpcb_tpu_torch.data.vocab import (END_SYMBOL, PAD_SYMBOL, REST_SYMBOL,
                                         START_SYMBOL, Vocabulary,
                                         midi_of_plain_name)

# SATB practical ranges (midi)
SATB_RANGES = [(60, 81), (53, 74), (48, 69), (36, 64)]


def _plain_name(midi: int) -> str:
    return f"p{midi}"


def _transpose_plain(score: NeutralScore, semitone: int) -> NeutralScore:
    parts = []
    for part in score.parts:
        new = []
        for e in part:
            if e.is_note:
                m = e.midi + semitone
                new.append(NeutralEvent(e.offset, _plain_name(m), m, True))
            else:
                new.append(e)
        parts.append(new)
    return NeutralScore(parts=parts, transpose_fn=_transpose_plain,
                        end_time=score.end_time)


class SyntheticChoraleCorpus:
    """Deterministic fake chorales: random-walk melodies per voice on a beat
    subdivision grid, occasional rests and held notes."""

    def __init__(self,
                 num_chorales: int = 24,
                 min_beats: int = 16,
                 max_beats: int = 48,
                 seed: int = 0):
        self.num_chorales = num_chorales
        self.min_beats = min_beats
        self.max_beats = max_beats
        self.seed = seed

    @property
    def cache_key(self) -> str:
        return (f"synthetic_n{self.num_chorales}_b{self.min_beats}-"
                f"{self.max_beats}_s{self.seed}")

    def __iter__(self) -> Iterator[NeutralScore]:
        for i in range(self.num_chorales):
            yield self._make_score(i)

    def _make_score(self, index: int) -> NeutralScore:
        rng = np.random.RandomState(self.seed * 10007 + index)
        num_beats = int(rng.randint(self.min_beats, self.max_beats + 1))
        parts: List[List[NeutralEvent]] = []
        for lo, hi in SATB_RANGES:
            # keep voices in the central 2/3 of their range so windows admit
            # some transpositions (like real chorales do)
            margin = (hi - lo) // 6
            pitch = int(rng.randint(lo + margin, hi - margin + 1))
            events: List[NeutralEvent] = []
            offset = 0.0
            while offset < num_beats:
                dur = float(rng.choice([0.25, 0.5, 1.0, 2.0],
                                       p=[0.2, 0.4, 0.3, 0.1]))
                dur = min(dur, num_beats - offset)
                if rng.rand() < 0.05:
                    events.append(NeutralEvent(offset, REST_SYMBOL, None, False))
                else:
                    step = int(rng.randint(-4, 5))
                    pitch = int(np.clip(pitch + step, lo + margin, hi - margin))
                    events.append(NeutralEvent(
                        offset, _plain_name(pitch), pitch, True))
                offset += dur
            parts.append(events)
        return NeutralScore(parts=parts, transpose_fn=_transpose_plain,
                            end_time=float(num_beats))

    def build_vocabulary(self) -> Vocabulary:
        """Names over the whole *untransposed* corpus plus special symbols
        (reference: chorale_dataset.py:364-394); pitches discovered through
        transposition later map to OUT_OF_RANGE exactly as in the reference
        when outside the corpus voice range."""
        note_sets = [set() for _ in SATB_RANGES]
        for score in self:
            for part_id, part in enumerate(score.parts):
                for e in part:
                    note_sets[part_id].add(e.name)
        # include every in-range pitch name so transposed windows tokenize
        for (lo, hi), s in zip(SATB_RANGES, note_sets):
            for m in range(lo, hi + 1):
                s.add(_plain_name(m))
        return Vocabulary.from_note_sets(note_sets, midi_of_plain_name)


class Music21BachCorpus:
    """music21 Bach chorale iterator -> NeutralScores
    (4-part chorales only, reference: chorale_dataset.py:396-398)."""

    def __init__(self, num_voices: int = 4):
        self.num_voices = num_voices

    @property
    def cache_key(self) -> str:
        return f"bach_m21_v{self.num_voices}"

    @staticmethod
    def _import_music21():
        try:
            import music21
            return music21
        except ImportError as e:
            raise ImportError(
                "the 'bach' dataset needs music21 (pip install music21); "
                "for a music21-free run use dataset: 'synthetic' "
                "(e.g. configs/encoder_random_synthetic.py)") from e

    def _chorales(self):
        """The corpus's chorales of num_voices parts, as music21 gives them."""
        music21 = self._import_music21()
        for chorale in music21.corpus.chorales.Iterator():
            if len(chorale.parts) == self.num_voices:
                yield chorale

    def __iter__(self) -> Iterator[NeutralScore]:
        for chorale in self._chorales():
            yield self._to_neutral(chorale)

    def _to_neutral(self, chorale) -> NeutralScore:
        music21 = self._import_music21()

        def convert(score) -> NeutralScore:
            parts = []
            for part in score.parts[:self.num_voices]:
                events = []
                for n in part.flat.getElementsByOffset(
                        offsetStart=0.0,
                        offsetEnd=score.flat.highestTime,
                        classList=[music21.note.Note, music21.note.Rest]):
                    if n.isNote:
                        events.append(NeutralEvent(
                            float(n.offset), n.nameWithOctave,
                            int(n.pitch.midi), True))
                    else:
                        events.append(NeutralEvent(
                            float(n.offset), n.name, None, False))
                parts.append(events)
            return NeutralScore(parts=parts,
                                end_time=float(score.flat.highestTime))

        def transpose_fn(neutral: NeutralScore, semitone: int) -> NeutralScore:
            # the reference's spelling: music21 interval transposition
            # (chorale_dataset.py:193-200)
            interval_type, interval_nature = \
                music21.interval.convertSemitoneToSpecifierGeneric(semitone)
            transposition_interval = music21.interval.Interval(
                str(interval_nature) + interval_type)
            transposed = chorale.transpose(transposition_interval)
            out = convert(transposed)
            out.transpose_fn = transpose_fn
            return out

        neutral = convert(chorale)
        neutral.transpose_fn = transpose_fn
        return neutral

    def build_vocabulary(self) -> Vocabulary:
        music21 = self._import_music21()
        note_sets = [set() for _ in range(self.num_voices)]
        name_to_midi = {}
        for chorale in self._chorales():
            for part_id, part in enumerate(chorale.parts[:self.num_voices]):
                for n in part.flat.notesAndRests:
                    if n.isNote:
                        note_sets[part_id].add(n.nameWithOctave)
                        name_to_midi[n.nameWithOctave] = int(n.pitch.midi)
                    else:
                        note_sets[part_id].add(n.name)

        # the reference's quirk, kept for parity (corpora.py:188-199):
        # _compute_voice_ranges runs standard_note over every vocabulary
        # entry, and standard_note maps START/END/PAD to the quarter-tone
        # notes C~3/D~3/E~3 (midi 48/50/52, helpers.py:36-51), which widen
        # the voice ranges and with them each window's transposition
        # interval (chorale_dataset.py:400-416, 234-250)
        meta_pitches = {START_SYMBOL: 48, END_SYMBOL: 50, PAD_SYMBOL: 52}

        def midi_of(name: str) -> Optional[int]:
            if name in meta_pitches:
                return meta_pitches[name]
            if name in name_to_midi:
                return name_to_midi[name]
            try:
                return int(music21.note.Note(name).pitch.midi)
            except Exception:
                return None

        return Vocabulary.from_note_sets(note_sets, midi_of)
