"""Standard MIDI Files: a port-local copy of vqcpcb_tpu/data/midi.py,
stdlib only, so a file parses to the JAX package's scores and a written
score is the same bytes.

Two halves:
  * reading: `parse_smf` (format 0/1, variable-length deltas, running
    status, meta and sysex events skipped, undefined status bytes and SMPTE
    divisions rejected), `track_notes` (a note-on of velocity 0 is a
    note-off), `smf_to_neutral` (one monophonic voice per track, or per
    channel in a format-0 file, ordered soprano-first by mean pitch;
    offsets in beats from the header's division) and `MidiCorpus`, a
    directory of .mid files (data/filecorpus.py);
  * writing: `write_smf`, `neutral_events_to_smf` (generated grids) and
    `neutral_to_smf` (whole scores; make_midi_corpus.py renders the
    synthetic corpus to .mid files with it).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from vqcpcb_tpu_torch.data.corpora import _plain_name, _transpose_plain
from vqcpcb_tpu_torch.data.filecorpus import FileCorpus
from vqcpcb_tpu_torch.data.tokenizer import NeutralEvent, NeutralScore
from vqcpcb_tpu_torch.data.vocab import REST_SYMBOL, midi_of_name


# ---- reading ---------------------------------------------------------------

@dataclass
class MidiNote:
    onset_tick: int
    off_tick: int
    pitch: int
    channel: int


class MidiParseError(ValueError):
    pass


def _read_vlq(data: bytes, i: int) -> Tuple[int, int]:
    """Variable-length quantity at data[i:]; returns (value, next_index)."""
    value = 0
    for _ in range(4):
        if i >= len(data):
            raise MidiParseError("truncated variable-length quantity")
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i
    raise MidiParseError("variable-length quantity longer than 4 bytes")


def _parse_track(data: bytes) -> List[Tuple[int, int, bytes]]:
    """One MTrk chunk body -> [(abs_tick, status, payload)], running status
    resolved. Meta events keep status 0xFF and payload bytes([type]) + data;
    sysex events are skipped."""
    events: List[Tuple[int, int, bytes]] = []
    i = 0
    tick = 0
    running: Optional[int] = None
    n = len(data)
    while i < n:
        delta, i = _read_vlq(data, i)
        tick += delta
        if i >= n:
            raise MidiParseError("truncated event")
        status = data[i]
        if status & 0x80:
            i += 1
            if status < 0xF0:
                running = status
        else:
            if running is None:
                raise MidiParseError("data byte with no running status")
            status = running
        if status == 0xFF:                      # meta
            if i >= n:
                raise MidiParseError("truncated meta event")
            mtype = data[i]
            i += 1
            length, i = _read_vlq(data, i)
            payload = data[i:i + length]
            i += length
            events.append((tick, 0xFF, bytes([mtype]) + payload))
            if mtype == 0x2F:                   # end of track
                break
        elif status in (0xF0, 0xF7):            # sysex: skipped
            length, i = _read_vlq(data, i)
            i += length
        elif status >= 0xF1:
            # system-common / real-time bytes are undefined in a track and
            # carry 0-2 data bytes that cannot be inferred: guessing would
            # desynchronise the parser, so the file is refused (the corpus
            # skips it)
            raise MidiParseError(f"unsupported status byte 0x{status:02X}")
        else:
            kind = status & 0xF0
            width = 1 if kind in (0xC0, 0xD0) else 2
            payload = data[i:i + width]
            i += width
            if len(payload) < width:
                raise MidiParseError("truncated channel event")
            events.append((tick, status, payload))
    return events


def parse_smf(data: bytes) -> Dict:
    """SMF bytes -> {'format', 'division', 'tracks': [event list]}. Only
    ticks-per-quarter divisions are read (an SMPTE division raises); an
    offset in beats is tick / division. Chunks other than MTrk are skipped."""
    if len(data) < 14 or data[0:4] != b"MThd":
        raise MidiParseError("missing MThd header")
    hlen = struct.unpack(">I", data[4:8])[0]
    if hlen < 6:
        raise MidiParseError("bad MThd length")
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise MidiParseError("SMPTE time division not supported")
    if division == 0:
        raise MidiParseError("zero time division")
    i = 8 + hlen
    tracks = []
    while i + 8 <= len(data) and len(tracks) < ntrks:
        chunk_type = data[i:i + 4]
        chunk_len = struct.unpack(">I", data[i + 4:i + 8])[0]
        body = data[i + 8:i + 8 + chunk_len]
        i += 8 + chunk_len
        if chunk_type != b"MTrk":
            continue
        tracks.append(_parse_track(body))
    if not tracks:
        raise MidiParseError("no MTrk chunks")
    return {"format": fmt, "division": division, "tracks": tracks}


def track_notes(events: Sequence[Tuple[int, int, bytes]]) -> List[MidiNote]:
    """Note-ons paired with their offs (a note-on of velocity 0 is an off; a
    retriggered note closes the sounding one); notes still sounding close
    at the last event's tick. Sorted by onset, highest pitch first."""
    active: Dict[Tuple[int, int], int] = {}
    notes: List[MidiNote] = []
    last_tick = 0
    for tick, status, payload in events:
        last_tick = max(last_tick, tick)
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90 and payload[1] > 0:
            key = (ch, payload[0])
            if key in active:
                notes.append(MidiNote(active[key], tick, payload[0], ch))
            active[key] = tick
        elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):
            key = (ch, payload[0])
            onset = active.pop(key, None)
            if onset is not None and tick > onset:
                notes.append(MidiNote(onset, tick, payload[0], ch))
    for (ch, pitch), onset in active.items():
        if last_tick > onset:
            notes.append(MidiNote(onset, last_tick, pitch, ch))
    notes.sort(key=lambda x: (x.onset_tick, -x.pitch))
    return notes


def _monophonic_voice(notes: Sequence[MidiNote],
                      division: int) -> List[NeutralEvent]:
    """One note stream as a melody line: one event per distinct onset (the
    highest pitch of a chord), a rest where a note ends before the next
    begins."""
    events: List[NeutralEvent] = []
    prev_off_beats = None
    prev_onset = None
    for note in notes:                          # onset up, pitch down
        if note.onset_tick == prev_onset:
            continue
        onset_beats = note.onset_tick / division
        if prev_off_beats is not None and onset_beats > prev_off_beats + 1e-9:
            events.append(NeutralEvent(prev_off_beats, REST_SYMBOL, None,
                                       False))
        events.append(NeutralEvent(onset_beats, _plain_name(note.pitch),
                                   note.pitch, True))
        prev_onset = note.onset_tick
        prev_off_beats = note.off_tick / division
    return events


def smf_to_neutral(data: bytes, num_voices: int = 4) -> Optional[NeutralScore]:
    """SMF bytes -> a NeutralScore of `num_voices` monophonic parts,
    soprano first, or None when the file has fewer note streams (the
    reference's four-voice filter, chorale_dataset.py:396-398). The streams
    are the tracks with notes, or, with fewer of those than voices, the
    channels."""
    smf = parse_smf(data)
    division = smf["division"]
    track_note_lists = [t for t in (track_notes(t) for t in smf["tracks"]) if t]
    if len(track_note_lists) >= num_voices:
        streams = track_note_lists
    else:
        by_channel: Dict[int, List[MidiNote]] = {}
        for t in track_note_lists:
            for note in t:
                by_channel.setdefault(note.channel, []).append(note)
        streams = [sorted(v, key=lambda x: (x.onset_tick, -x.pitch))
                   for _, v in sorted(by_channel.items())]
    if len(streams) < num_voices:
        return None
    streams.sort(key=lambda notes: sum(n.pitch for n in notes) / len(notes),
                 reverse=True)
    streams = streams[:num_voices]
    parts = [_monophonic_voice(s, division) for s in streams]
    if any(not p for p in parts):
        return None
    end_time = max(max(n.off_tick for n in s) for s in streams) / division
    return NeutralScore(parts=parts, transpose_fn=_transpose_plain,
                        end_time=float(end_time))


class MidiCorpus(FileCorpus):
    """A directory of .mid / .midi files -> NeutralScores
    (`dataset: 'midi'`, corpus_kwargs midi_root, num_voices, max_files)."""

    EXTENSIONS = (".mid", ".midi")
    KEY_PREFIX = "midi"
    PARSE_ERRORS = (MidiParseError,)

    def __init__(self, midi_root: str, num_voices: int = 4,
                 max_files: Optional[int] = None):
        super().__init__(midi_root, num_voices=num_voices,
                         max_files=max_files)
        self.midi_root = midi_root

    def _parse(self, path: str) -> Optional[NeutralScore]:
        with open(path, "rb") as f:
            return smf_to_neutral(f.read(), self.num_voices)


# ---- writing ---------------------------------------------------------------

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


def neutral_to_smf(score: NeutralScore, division: int = 480) -> bytes:
    """A NeutralScore as SMF bytes: each note sounds until the next event of
    its part (the tick-grid reading of part_to_ticks), the last until the
    score's end."""
    tracks = []
    for part in score.parts:
        notes = []
        for i, e in enumerate(part):
            if not e.is_note:
                continue
            end = (part[i + 1].offset if i + 1 < len(part)
                   else score.highest_time)
            if end > e.offset:
                notes.append((e.offset, end - e.offset, e.midi))
        tracks.append(notes)
    return write_smf(tracks, division=division)
