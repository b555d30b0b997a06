"""Directory-of-files corpus base for the stdlib format adapters (MIDI,
MusicXML): a port-local copy of vqcpcb_tpu/data/filecorpus.py. A sorted
recursive listing by extension, a content-addressed cache key, iteration
that skips unusable files with a message (the corpus-level counterpart of
the reference's per-score tolerance, chorale_dataset.py:172-174), and the
fill-in-range vocabulary (pitches outside a voice's corpus range map to
OUT_OF_RANGE, as in the reference's helpers.py:12-33). The same files give
the JAX package's scores, key and vocabulary, so both packages share a
window cache.
"""
from __future__ import annotations

import hashlib
import os
from typing import Iterator, List, Optional, Tuple

from vqcpcb_tpu_torch.data.corpora import _plain_name
from vqcpcb_tpu_torch.data.tokenizer import NeutralScore
from vqcpcb_tpu_torch.data.vocab import Vocabulary, midi_of_plain_name


class FileCorpus:
    """Subclasses set EXTENSIONS / KEY_PREFIX / PARSE_ERRORS and implement
    `_parse(path) -> Optional[NeutralScore]` (None: fewer voices than
    num_voices; an exception in PARSE_ERRORS: the file is skipped with a
    message)."""

    EXTENSIONS: Tuple[str, ...] = ()
    KEY_PREFIX: str = "files"
    PARSE_ERRORS: Tuple[type, ...] = ()

    def __init__(self, root: str, num_voices: int = 4,
                 max_files: Optional[int] = None):
        self.root = root
        self.num_voices = num_voices
        self.max_files = max_files

    def _files(self) -> List[str]:
        out = []
        for dirpath, _, filenames in sorted(os.walk(self.root)):
            for name in sorted(filenames):
                if name.lower().endswith(self.EXTENSIONS):
                    out.append(os.path.join(dirpath, name))
        if self.max_files is not None:
            out = out[: self.max_files]
        return out

    @property
    def cache_key(self) -> str:
        """SHA-1 over every file's relative path and bytes: a byte-identical
        rewrite keeps the key, any edit of the contents changes it."""
        h = hashlib.sha1()
        for path in self._files():
            h.update(os.path.relpath(path, self.root).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
            h.update(b";")
        return f"{self.KEY_PREFIX}_{h.hexdigest()[:12]}_v{self.num_voices}"

    def _parse(self, path: str) -> Optional[NeutralScore]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[NeutralScore]:
        for path in self._files():
            try:
                score = self._parse(path)
            except self.PARSE_ERRORS as exc:
                print(f"skipping unparseable {self.KEY_PREFIX} file "
                      f"{path}: {exc}")
                continue
            if score is None:
                print(f"skipping {path}: fewer than {self.num_voices} "
                      "note streams")
                continue
            yield score

    def build_vocabulary(self) -> Vocabulary:
        """Every name in each voice, plus every plain pitch name between the
        voice's lowest and highest note."""
        note_sets = [set() for _ in range(self.num_voices)]
        ranges = [[128, -1] for _ in range(self.num_voices)]
        empty = True
        for score in self:
            empty = False
            for part_id, part in enumerate(score.parts):
                for e in part:
                    note_sets[part_id].add(e.name)
                    if e.is_note:
                        ranges[part_id][0] = min(ranges[part_id][0], e.midi)
                        ranges[part_id][1] = max(ranges[part_id][1], e.midi)
        if empty:
            raise ValueError(
                f"no usable {self.num_voices}-voice {self.KEY_PREFIX} files "
                f"under {self.root}")
        for (lo, hi), s in zip(ranges, note_sets):
            for m in range(lo, hi + 1):
                s.add(_plain_name(m))
        return Vocabulary.from_note_sets(note_sets, midi_of_plain_name)
