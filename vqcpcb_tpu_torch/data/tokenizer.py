"""Neutral score representation and its tokenization into int tick grids:
a port-local copy of vqcpcb_tpu/data/tokenizer.py:33-328 (the port imports
nothing of the JAX package). As in JAX, the articulation loop and the window
extraction run in native code (vqcpcb_tpu_torch/native, built with g++ at
first use) unless VQCPCB_NATIVE=0 selects these NumPy paths, which give the
same windows bit for bit. A transposition that raises KeyError (a music21
score's key analysis, tokenizer.py:280-294) drops that (score, semitone)'s
windows, as the reference does.

Per part, a tick sequence with slurs for held notes, notes outside the
corpus voice range as OUT_OF_RANGE; sliding windows of `sequences_size`
beats over every score with every valid transposition, START/END/PAD at the
edges (reference: VQCPCB/datasets/chorale_dataset.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from vqcpcb_tpu_torch import native
from vqcpcb_tpu_torch.data.vocab import (END_SYMBOL, OUT_OF_RANGE, PAD_SYMBOL,
                                         SLUR_SYMBOL, START_SYMBOL, Vocabulary)


@dataclass
class NeutralEvent:
    """A note or rest in a part, ordered by offset (in beats)."""
    offset: float
    name: str                 # standard name; REST_SYMBOL for rests
    midi: Optional[int]       # None for rests
    is_note: bool


@dataclass
class NeutralScore:
    """Backend-independent score: one ordered event list per part."""
    parts: List[List[NeutralEvent]]
    # transpose_fn(score, semitone) -> NeutralScore; supplied by the corpus
    # backend (pitch-arithmetic for synthetic data, music21 for real scores)
    transpose_fn: Optional[Callable[["NeutralScore", int], "NeutralScore"]] = None
    # end of the score in beats (music21 highestTime); when None, the next
    # beat after the last event onset is used
    end_time: Optional[float] = None

    @property
    def lowest_offset(self) -> float:
        return min((p[0].offset for p in self.parts if p), default=0.0)

    @property
    def highest_offset(self) -> float:
        return max((p[-1].offset for p in self.parts if p), default=0.0)

    @property
    def highest_time(self) -> float:
        # end of the last event; the reference uses score.flat.highestTime
        if self.end_time is not None:
            return self.end_time
        return float(np.ceil(self.highest_offset + 1e-9)) + 1.0

    def transpose(self, semitone: int) -> "NeutralScore":
        if semitone == 0:
            return self
        assert self.transpose_fn is not None, "corpus provided no transpose_fn"
        return self.transpose_fn(self, semitone)


def part_to_ticks(events: Sequence[NeutralEvent],
                  note2index: Dict[str, int],
                  voice_range: Tuple[int, int],
                  subdivision: int,
                  offset_start: float,
                  offset_end: float) -> np.ndarray:
    """Tick sequence for one part over [offset_start, offset_end), replicating
    the reference's articulation loop and slur encoding
    (chorale_dataset.py:297-321). Returns int64 (length,)."""
    length = int((offset_end - offset_start) * subdivision)
    sel = [e for e in events if offset_start <= e.offset < offset_end]
    # the reference also includes elements at the boundary via music21
    # getElementsByOffset(offsetStart, offsetEnd); an event sounding across
    # offset_start begun earlier is *not* included — matching its behaviour.
    min_pitch, max_pitch = voice_range

    def name_of(e: NeutralEvent) -> str:
        if e.is_note and (e.midi < min_pitch or e.midi > max_pitch):
            return OUT_OF_RANGE
        return e.name

    slur_index = note2index[SLUR_SYMBOL]
    num_notes = len(sel)
    if num_notes == 0:
        return np.full((length,), slur_index, dtype=np.int64)

    token_index = np.asarray([note2index[name_of(e)] for e in sel],
                             dtype=np.int32)
    if native.enabled():
        offsets = np.asarray([e.offset for e in sel], dtype=np.float64)
        return native.part_to_ticks_native(
            offsets, token_index, length, subdivision, offset_start,
            slur_index).astype(np.int64)
    t = np.zeros((length, 2), dtype=np.int64)
    j = 0
    i = 0
    is_articulated = True
    while i < length:
        if j < num_notes - 1:
            if sel[j + 1].offset > i / subdivision + offset_start:
                t[i] = [token_index[j], int(is_articulated)]
                i += 1
                is_articulated = False
            else:
                j += 1
                is_articulated = True
        else:
            t[i] = [token_index[j], int(is_articulated)]
            i += 1
            is_articulated = False
    return t[:, 0] * t[:, 1] + (1 - t[:, 1]) * slur_index


def score_to_ticks(score: NeutralScore,
                   vocab: Vocabulary,
                   subdivision: int,
                   offset_start: float = 0.0,
                   offset_end: Optional[float] = None) -> np.ndarray:
    """(num_voices, length) int grid (chorale_dataset.py:252-259)."""
    if offset_end is None:
        offset_end = score.highest_time
    parts = []
    for part_id in range(len(vocab.note2index_dicts)):
        parts.append(part_to_ticks(
            score.parts[part_id],
            vocab.note2index_dicts[part_id],
            vocab.voice_ranges[part_id],
            subdivision, offset_start, offset_end))
    return np.stack(parts, axis=0)


def voice_ranges_in_window(score: NeutralScore,
                           num_voices: int,
                           offset_start: float,
                           offset_end: float) -> Optional[List[Tuple[int, int]]]:
    """Per-voice (min, max) midi of notes *beginning* in the window; None when
    any voice has no note (chorale_dataset.py:326-362)."""
    out = []
    for part in score.parts[:num_voices]:
        pitches = [e.midi for e in part
                   if e.is_note and offset_start <= e.offset < offset_end]
        if not pitches:
            return None
        out.append((min(pitches), max(pitches)))
    return out


def min_max_transposition(current_subseq_ranges,
                          corpus_voice_ranges) -> Tuple[int, int]:
    """(chorale_dataset.py:234-250)"""
    if current_subseq_ranges is None:
        return (0, 0)
    transpositions = [
        (mn_corpus - mn_cur, mx_corpus - mx_cur)
        for (mn_corpus, mx_corpus), (mn_cur, mx_cur)
        in zip(corpus_voice_ranges, current_subseq_ranges)
    ]
    mins, maxs = zip(*transpositions)
    return (max(mins), min(maxs))


def extract_with_padding(tensor_score: np.ndarray,
                         start_tick: int,
                         end_tick: int,
                         vocab: Vocabulary) -> np.ndarray:
    """One window [start_tick, end_tick) of a (voices, ticks) grid, padded
    where it leaves the score: a single START (resp. END) symbol next to
    the score, PAD beyond it (tokenizer.py:152-179; reference:
    chorale_dataset.py:418-470)."""
    assert start_tick < end_tick
    assert end_tick > 0
    length = tensor_score.shape[1]
    start_symbols = np.array(vocab.symbol_indices(START_SYMBOL))
    end_symbols = np.array(vocab.symbol_indices(END_SYMBOL))
    pad_symbols = np.array(vocab.symbol_indices(PAD_SYMBOL))

    parts = []
    if start_tick < 0:
        left = np.tile(pad_symbols[:, None], (1, -start_tick))
        left[:, -1] = start_symbols
        parts.append(left)
    parts.append(tensor_score[:, max(start_tick, 0):min(end_tick, length)])
    if end_tick > length:
        right = np.tile(pad_symbols[:, None], (1, end_tick - length))
        right[:, 0] = end_symbols
        parts.append(right)
    return np.concatenate(parts, axis=1)


def extract_windows_batch(grid: np.ndarray,
                          start_ticks: np.ndarray,
                          window_len: int,
                          vocab: Vocabulary) -> np.ndarray:
    """Batched window extraction with START/END/PAD padding, natively or
    (VQCPCB_NATIVE=0) in vectorised NumPy. Returns (num_windows,
    num_voices, window_len) int32."""
    start_symbols = np.array(vocab.symbol_indices(START_SYMBOL), np.int32)
    end_symbols = np.array(vocab.symbol_indices(END_SYMBOL), np.int32)
    pad_symbols = np.array(vocab.symbol_indices(PAD_SYMBOL), np.int32)
    if native.enabled():
        return native.extract_windows_native(grid, start_ticks, window_len,
                                             start_symbols, end_symbols,
                                             pad_symbols)
    num_voices, length = grid.shape
    ticks = start_ticks[:, None] + np.arange(window_len)[None, :]  # (W, T)
    clipped = np.clip(ticks, 0, length - 1)
    gathered = grid[:, clipped]                       # (V, W, T)
    gathered = np.transpose(gathered, (1, 0, 2)).copy()
    sym = {
        "pad": np.broadcast_to(pad_symbols[None, :, None], gathered.shape),
        "start": np.broadcast_to(start_symbols[None, :, None], gathered.shape),
        "end": np.broadcast_to(end_symbols[None, :, None], gathered.shape),
    }
    t = ticks[:, None, :]
    gathered = np.where(t < -1, sym["pad"], gathered)
    gathered = np.where(t == -1, sym["start"], gathered)
    gathered = np.where(t == length, sym["end"], gathered)
    gathered = np.where(t > length, sym["pad"], gathered)
    return gathered.astype(np.int32)


def make_window_dataset(scores: Iterable[NeutralScore],
                        vocab: Vocabulary,
                        sequences_size: int,
                        subdivision: int) -> np.ndarray:
    """All (num_voices, sequences_size*subdivision) windows over the corpus
    with every valid transposition (chorale_dataset.py:109-183); the window
    *order* (offset-major, semitone-minor per score) matches the reference so
    the contiguous train/val/test split selects the same material.

    Returns int32 (num_windows, num_voices, ticks)."""
    one_beat = 1.0
    num_voices = vocab.num_voices
    window_len = sequences_size * subdivision
    all_windows = []
    for score in scores:
        # plan: ordered (semitone, start_tick) jobs for this score
        jobs = []
        for offset_start in np.arange(
                score.lowest_offset - (sequences_size - one_beat),
                score.highest_offset,
                one_beat):
            offset_end = offset_start + sequences_size
            ranges = voice_ranges_in_window(score, num_voices,
                                            offset_start, offset_end)
            mn, mx = min_max_transposition(ranges, vocab.voice_ranges)
            for semi_tone in range(mn, mx + 1):
                jobs.append((semi_tone, int(offset_start * subdivision)))
        if not jobs:
            continue
        # tokenize each needed transposition once, extract its windows batched
        semis = np.array([j[0] for j in jobs])
        starts = np.array([j[1] for j in jobs], dtype=np.int64)
        out = np.empty((len(jobs), num_voices, window_len), dtype=np.int32)
        keep = np.ones(len(jobs), dtype=bool)
        for semi_tone in np.unique(semis):
            sel = semis == semi_tone
            try:
                ticks = score_to_ticks(score.transpose(int(semi_tone)), vocab,
                                       subdivision)
            except KeyError as exc:
                # the reference's tolerance (chorale_dataset.py:172-174): a
                # music21 score whose transposition raises (its key analyzer)
                # loses every window of that (score, semitone), and the rest
                # of the dataset builds on
                print(f"KeyError {exc!r} transposing score by {semi_tone} "
                      "semitones; skipping its windows")
                keep[sel] = False
                continue
            out[sel] = extract_windows_batch(
                ticks.astype(np.int32), starts[sel], window_len, vocab)
        all_windows.append(out[keep])
    return np.concatenate(all_windows, axis=0).astype(np.int32)


def ticks_to_neutral_events(tensor_score: np.ndarray,
                            vocab: Vocabulary,
                            subdivision: int) -> List[List[Tuple[str, float, float]]]:
    """Inverse of score_to_ticks, for score writing: per voice, a list of
    (name, offset_beats, duration_beats) merging slurred ticks
    (chorale_dataset.py:505-540)."""
    out = []
    for voice_idx in range(tensor_score.shape[0]):
        slur = vocab.note2index_dicts[voice_idx][SLUR_SYMBOL]
        i2n = vocab.index2note_dicts[voice_idx]
        events = []
        # leading slurs with no preceding note become a rest, as in the
        # reference (music21.note.Rest default, chorale_dataset.py:523)
        current = ("rest", 0.0)
        dur = 0
        for tick, idx in enumerate(tensor_score[voice_idx]):
            idx = int(idx)
            if idx != slur:
                if dur > 0:
                    events.append((current[0], current[1], dur / subdivision))
                current = (i2n[idx], tick / subdivision)
                dur = 1
            else:
                dur += 1
        if dur > 0:
            events.append((current[0], current[1], dur / subdivision))
        out.append(events)
    return out
