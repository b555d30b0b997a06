"""Standard MIDI File writing: a port-local copy of the writer half of
vqcpcb_tpu/data/midi.py (`_vlq` :289, `_track_chunk` :298, `write_smf` :310,
`neutral_events_to_smf` :332), stdlib only, so a written score is the same
bytes as the JAX package's. The parser and the MIDI corpus come with the
file corpora (ROADMAP Queue 1, M6 (h)).
"""
from __future__ import annotations

import struct
from typing import Sequence, Tuple

from vqcpcb_tpu_torch.data.vocab import midi_of_name


def _vlq(value: int) -> bytes:
    """MIDI variable-length quantity, 7 bits a byte, high bit = more."""
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _track_chunk(events: Sequence[Tuple[int, bytes]]) -> bytes:
    """[(abs_tick, raw message bytes)] -> MTrk chunk with deltas + EOT."""
    body = bytearray()
    tick = 0
    for abs_tick, msg in sorted(events, key=lambda e: e[0]):
        body += _vlq(abs_tick - tick)
        body += msg
        tick = abs_tick
    body += _vlq(0) + b"\xff\x2f\x00"
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def write_smf(tracks: Sequence[Sequence[Tuple[float, float, int]]],
              division: int = 480,
              fmt: int = 1,
              tempo_us: int = 500000) -> bytes:
    """[(onset_beats, duration_beats, pitch)] per track -> SMF bytes: a
    conductor track with the tempo, then one track (and channel) per voice."""
    chunks = [struct.pack(">4sIHHH", b"MThd", 6, fmt,
                          len(tracks) + 1, division)]
    chunks.append(_track_chunk(
        [(0, b"\xff\x51\x03" + tempo_us.to_bytes(3, "big"))]))
    for ch, notes in enumerate(tracks):
        events = []
        for onset, dur, pitch in notes:
            on = int(round(onset * division))
            off = int(round((onset + dur) * division))
            events.append((on, bytes([0x90 | (ch & 0x0F), pitch, 80])))
            events.append((max(off, on + 1),
                           bytes([0x80 | (ch & 0x0F), pitch, 0])))
        chunks.append(_track_chunk(events))
    return b"".join(chunks)


def neutral_events_to_smf(events_per_voice, division: int = 480) -> bytes:
    """Per-voice (name, offset_beats, duration_beats) lists, as
    `BachDataloaderGenerator.to_neutral` gives them, rendered to SMF bytes.
    Names without a midi pitch (rests, START / END / PAD / out-of-range
    markers) become silence."""
    tracks = []
    for events in events_per_voice:
        notes = []
        for name, offset, duration in events:
            pitch = midi_of_name(name)
            if pitch is not None and 0 <= pitch <= 127 and duration > 0:
                notes.append((offset, duration, pitch))
        tracks.append(notes)
    return write_smf(tracks, division=division)
