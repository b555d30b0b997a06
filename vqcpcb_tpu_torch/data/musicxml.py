"""MusicXML corpus, stdlib xml.etree only: a port-local copy of
vqcpcb_tpu/data/musicxml.py. Score-partwise MusicXML (.xml, .musicxml, or
zip-compressed .mxl) -> NeutralScores: pitch (step / alter / octave) ->
midi, rests, chords (the highest note, as the MIDI reader keeps), ties (a
note that only stops a tie starts nothing), <divisions> per measure,
<backup> / <forward> moves, and one candidate stream per (part, voice).
Offsets are in beats: position in divisions / divisions. Malformed values
raise MusicXmlParseError, so the corpus skips the file.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
import zipfile
from typing import Dict, List, Optional, Tuple

from vqcpcb_tpu_torch.data.corpora import _plain_name, _transpose_plain
from vqcpcb_tpu_torch.data.filecorpus import FileCorpus
from vqcpcb_tpu_torch.data.tokenizer import NeutralEvent, NeutralScore
from vqcpcb_tpu_torch.data.vocab import _PITCH_STEPS, REST_SYMBOL


class MusicXmlParseError(ValueError):
    pass


def _num(el, tag: str, default: Optional[str] = None) -> float:
    """A child's text as a number; missing or not a number raises
    MusicXmlParseError."""
    text = el.findtext(tag, default)
    if text is None:
        raise MusicXmlParseError(f"missing <{tag}>")
    try:
        return float(text)
    except ValueError as exc:
        raise MusicXmlParseError(f"bad <{tag}> value {text!r}") from exc


def _pitch_to_midi(pitch_el) -> int:
    step = pitch_el.findtext("step")
    if step not in _PITCH_STEPS:
        raise MusicXmlParseError(f"bad step {step!r}")
    alter = int(_num(pitch_el, "alter", "0"))
    octave = int(_num(pitch_el, "octave"))
    return 12 * (octave + 1) + _PITCH_STEPS[step] + alter


def _is_tie_stop_only(note_el) -> bool:
    """Whether the note only continues a tie (a stop without a new start)."""
    types = {t.get("type") for t in note_el.findall("tie")}
    return "stop" in types and "start" not in types


def parse_musicxml(data: bytes) -> List[List[Tuple[float, Optional[int], float]]]:
    """MusicXML bytes -> streams of (onset_beats, midi or None for a rest,
    duration_beats), one per (part, voice) in document order, each sorted
    by onset with the highest pitch first. A chord member shares its base
    note's onset whatever its own duration."""
    try:
        root = ET.fromstring(data)
    except ET.ParseError as exc:
        raise MusicXmlParseError(str(exc)) from exc
    if root.tag != "score-partwise":
        raise MusicXmlParseError(f"unsupported root element {root.tag!r}")

    streams: List[List[Tuple[float, Optional[int], float]]] = []
    for part in root.findall("part"):
        voices: Dict[str, List[Tuple[float, Optional[int], float]]] = {}
        divisions = None
        measure_start = 0.0
        for measure in part.findall("measure"):
            pos = measure_start
            max_pos = measure_start
            base_onset = None        # onset of the last note that is no chord member
            for el in measure:
                if el.tag == "attributes":
                    if el.findtext("divisions") is not None:
                        divisions = int(_num(el, "divisions"))
                        if divisions <= 0:
                            raise MusicXmlParseError(
                                f"non-positive divisions {divisions}")
                elif el.tag == "backup":
                    if divisions is None:
                        raise MusicXmlParseError("backup before divisions")
                    pos -= int(_num(el, "duration")) / divisions
                    base_onset = None
                elif el.tag == "forward":
                    if divisions is None:
                        raise MusicXmlParseError("forward before divisions")
                    pos += int(_num(el, "duration")) / divisions
                    max_pos = max(max_pos, pos)
                    base_onset = None
                elif el.tag == "note":
                    if el.find("grace") is not None:
                        continue
                    if divisions is None:
                        raise MusicXmlParseError("note before divisions")
                    dur = int(_num(el, "duration", "0")) / divisions
                    is_chord = el.find("chord") is not None
                    if is_chord:
                        if base_onset is None:
                            raise MusicXmlParseError(
                                "chord note with no preceding note")
                        onset = base_onset
                    else:
                        onset = pos
                        base_onset = pos
                    stream = voices.setdefault(el.findtext("voice", "1"), [])
                    if el.find("rest") is not None:
                        stream.append((onset, None, dur))
                    else:
                        pitch_el = el.find("pitch")
                        if pitch_el is None:
                            raise MusicXmlParseError("note without pitch/rest")
                        if not _is_tie_stop_only(el):
                            stream.append((onset, _pitch_to_midi(pitch_el),
                                           dur))
                    if not is_chord:
                        pos += dur
                        max_pos = max(max_pos, pos)
            measure_start = max_pos
        for _, stream in sorted(voices.items()):
            if stream:
                streams.append(sorted(stream,
                                      key=lambda e: (e[0], -(e[1] or -1))))
    if not streams:
        raise MusicXmlParseError("no parts with notes")
    return streams


def _stream_to_part(stream) -> Tuple[List[NeutralEvent], float]:
    """One stream as a melody line: one event per distinct onset (the
    first, highest), rests where written; returns (events, end in beats)."""
    events: List[NeutralEvent] = []
    last_onset = None
    end_time = 0.0
    for onset, midi, dur in stream:
        end_time = max(end_time, onset + dur)
        if last_onset is not None and abs(onset - last_onset) < 1e-9:
            continue
        last_onset = onset
        if midi is None:
            events.append(NeutralEvent(onset, REST_SYMBOL, None, False))
        else:
            events.append(NeutralEvent(onset, _plain_name(midi), midi, True))
    return events, end_time


def musicxml_to_neutral(data: bytes,
                        num_voices: int = 4) -> Optional[NeutralScore]:
    """MusicXML bytes -> a NeutralScore of `num_voices` monophonic parts,
    soprano first by mean pitch, or None when fewer streams carry notes."""
    streams = parse_musicxml(data)
    note_streams = [s for s in streams if any(m is not None for _, m, _ in s)]
    if len(note_streams) < num_voices:
        return None

    def mean_pitch(s):
        ps = [m for _, m, _ in s if m is not None]
        return sum(ps) / len(ps)

    note_streams.sort(key=mean_pitch, reverse=True)
    parts, ends = zip(*(_stream_to_part(s) for s in note_streams[:num_voices]))
    return NeutralScore(parts=list(parts), transpose_fn=_transpose_plain,
                        end_time=float(max(ends)))


def _read_mxl(path: str) -> bytes:
    """A compressed .mxl's score: the rootfile its META-INF/container.xml
    names, else its first top-level .xml entry."""
    with zipfile.ZipFile(path) as z:
        try:
            container = ET.fromstring(z.read("META-INF/container.xml"))
            rootfile = container.find(".//rootfile")
            if rootfile is not None and rootfile.get("full-path"):
                return z.read(rootfile.get("full-path"))
        except KeyError:
            pass
        for name in z.namelist():
            if name.lower().endswith(".xml") and "/" not in name:
                return z.read(name)
    raise MusicXmlParseError(f"no score entry in {path}")


class MusicXmlCorpus(FileCorpus):
    """A directory of .xml / .musicxml / .mxl files -> NeutralScores
    (`dataset: 'musicxml'`, corpus_kwargs xml_root, num_voices,
    max_files)."""

    EXTENSIONS = (".xml", ".musicxml", ".mxl")
    KEY_PREFIX = "musicxml"
    PARSE_ERRORS = (MusicXmlParseError, zipfile.BadZipFile)

    def __init__(self, xml_root: str, num_voices: int = 4,
                 max_files: Optional[int] = None):
        super().__init__(xml_root, num_voices=num_voices,
                         max_files=max_files)
        self.xml_root = xml_root

    def _parse(self, path: str) -> Optional[NeutralScore]:
        if path.lower().endswith(".mxl"):
            data = _read_mxl(path)
        else:
            with open(path, "rb") as f:
                data = f.read()
        return musicxml_to_neutral(data, self.num_voices)
