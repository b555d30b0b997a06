"""The synthetic chorale corpus: a port-local copy of
SyntheticChoraleCorpus (vqcpcb_tpu/data/corpora.py:43), deterministic
4-voice scores with Bach-chorale statistics (SATB ranges, a 16th-note grid,
held notes and rests) from np.random.RandomState, so the same seed gives the
JAX package's scores. The music21 corpus waits for a later slice.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from vqcpcb_tpu_torch.data.tokenizer import NeutralEvent, NeutralScore
from vqcpcb_tpu_torch.data.vocab import (REST_SYMBOL, Vocabulary,
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
