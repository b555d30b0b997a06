"""Per-voice note vocabularies and special symbols.

A port-local copy of vqcpcb_tpu/data/vocab.py:19-128 (the port imports
nothing of the JAX package): one note2index/index2note pair per voice plus
midi voice ranges, vocabularies sorted for reproducibility.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SLUR_SYMBOL = "__"
START_SYMBOL = "START"
END_SYMBOL = "END"
REST_SYMBOL = "rest"
OUT_OF_RANGE = "OOR"
PAD_SYMBOL = "XX"

SPECIAL_SYMBOLS = [SLUR_SYMBOL, START_SYMBOL, END_SYMBOL, REST_SYMBOL,
                   OUT_OF_RANGE, PAD_SYMBOL]


@dataclass
class Vocabulary:
    """One note2index/index2note pair per voice plus midi voice ranges."""
    note2index_dicts: List[Dict[str, int]]
    voice_ranges: List[Tuple[int, int]]
    index2note_dicts: List[Dict[int, str]] = field(default_factory=list)

    def __post_init__(self):
        if not self.index2note_dicts:
            self.index2note_dicts = [
                {i: n for n, i in d.items()} for d in self.note2index_dicts
            ]

    @property
    def num_voices(self) -> int:
        return len(self.note2index_dicts)

    @property
    def num_tokens_per_channel(self) -> List[int]:
        return [len(d) for d in self.note2index_dicts]

    def symbol_indices(self, symbol: str) -> List[int]:
        return [d[symbol] for d in self.note2index_dicts]

    @classmethod
    def from_note_sets(cls,
                       note_sets: Sequence[set],
                       midi_of_name) -> "Vocabulary":
        """Sorted vocabularies from per-voice name sets; special symbols are
        always included."""
        note2index_dicts = []
        for note_set in note_sets:
            names = sorted(set(note_set) | set(SPECIAL_SYMBOLS))
            note2index_dicts.append({n: i for i, n in enumerate(names)})
        voice_ranges = []
        for d in note2index_dicts:
            pitches = [midi_of_name(n) for n in d]
            pitches = [p for p in pitches if p is not None]
            voice_ranges.append((min(pitches), max(pitches)))
        return cls(note2index_dicts=note2index_dicts, voice_ranges=voice_ranges)

    @classmethod
    def from_reference_pickle(cls, path: str) -> "Vocabulary":
        """Load a reference-built index_dicts pickle."""
        import pickle
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(note2index_dicts=d["note2index_dicts"],
                   voice_ranges=[tuple(r) for r in d["voice_ranges"]])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"note2index_dicts": self.note2index_dicts,
                       "voice_ranges": [list(r) for r in self.voice_ranges]}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            d = json.load(f)
        return cls(note2index_dicts=d["note2index_dicts"],
                   voice_ranges=[tuple(r) for r in d["voice_ranges"]])


def midi_of_plain_name(name: str) -> Optional[int]:
    """midi pitch for names of the form 'p<midi>' (synthetic corpus);
    None for special symbols."""
    if name.startswith("p") and name[1:].isdigit():
        return int(name[1:])
    return None


_PITCH_STEPS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def midi_of_name(name: str) -> Optional[int]:
    """midi pitch for 'p<midi>' plain names and music21-style pitch names
    ('C4', 'C#4', 'E-4'); None for special symbols and rests."""
    plain = midi_of_plain_name(name)
    if plain is not None:
        return plain
    if not name or name[0] not in _PITCH_STEPS:
        return None
    i, alter = 1, 0
    while i < len(name) and name[i] in "#-":
        alter += 1 if name[i] == "#" else -1
        i += 1
    tail = name[i:]
    if not tail or not (tail.isdigit()
                        or (tail[0] == "-" and tail[1:].isdigit())):
        return None
    return (int(tail) + 1) * 12 + _PITCH_STEPS[name[0]] + alter
