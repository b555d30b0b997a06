"""Render the synthetic chorale corpus to .mid files (the port's counterpart
of scripts/make_midi_corpus.py, the same file names and bytes).

The scale-up MIDI configs (configs/*_scaleup_midi.py) read a directory of
.mid files; this writes one from the deterministic synthetic generator
through the SMF writer, so the whole MIDI path (bytes -> NeutralScore ->
tokenizer -> windows) runs on real file contents. Pointing midi_root at any
other MIDI directory changes nothing else.

    python -m vqcpcb_tpu_torch.make_midi_corpus --out data/midi_corpus \
        [--num 512 --min-beats 32 --max-beats 128 --seed 0]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
from vqcpcb_tpu_torch.data.midi import neutral_to_smf


def write_corpus(out: str, num: int = 512, min_beats: int = 32,
                 max_beats: int = 128, seed: int = 0) -> int:
    """Writes chorale_{i:05d}.mid for each score; returns how many."""
    corpus = SyntheticChoraleCorpus(num_chorales=num, min_beats=min_beats,
                                    max_beats=max_beats, seed=seed)
    os.makedirs(out, exist_ok=True)
    n = 0
    for i, score in enumerate(corpus):
        with open(os.path.join(out, f"chorale_{i:05d}.mid"), "wb") as f:
            f.write(neutral_to_smf(score))
        n += 1
    return n


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--num", type=int, default=512)
    parser.add_argument("--min-beats", type=int, default=32)
    parser.add_argument("--max-beats", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    n = write_corpus(args.out, args.num, args.min_beats, args.max_beats,
                     args.seed)
    print(f"wrote {n} .mid files to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
