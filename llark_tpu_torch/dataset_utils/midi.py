"""MIDI parsing + note formatting (counterpart of
llark_tpu/dataset_utils/midi.py).

The reference converts MusicNet/Slakh MIDI to human-readable note lists
via the note_seq package (reference: m2t/preprocessing/jsonify.py:162-197,
m2t/dataset_utils/midi.py). Here: a dependency-free Standard MIDI File
parser (note on/off + tempo map -> seconds) and the same formatted-notes
contract, including the MusicNet corrections (1-indexed programs,
pizzicato-section -> violin).
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

NOTE_LABELS = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")

# General MIDI level-1 program names (public MIDI specification).
GM_PROGRAMS = (
    "Acoustic Grand Piano", "Bright Acoustic Piano", "Electric Grand Piano",
    "Honky-tonk Piano", "Electric Piano 1", "Electric Piano 2", "Harpsichord",
    "Clavinet", "Celesta", "Glockenspiel", "Music Box", "Vibraphone",
    "Marimba", "Xylophone", "Tubular Bells", "Dulcimer", "Drawbar Organ",
    "Percussive Organ", "Rock Organ", "Church Organ", "Reed Organ",
    "Accordion", "Harmonica", "Tango Accordion", "Acoustic Guitar (nylon)",
    "Acoustic Guitar (steel)", "Electric Guitar (jazz)",
    "Electric Guitar (clean)", "Electric Guitar (muted)", "Overdriven Guitar",
    "Distortion Guitar", "Guitar Harmonics", "Acoustic Bass",
    "Electric Bass (finger)", "Electric Bass (pick)", "Fretless Bass",
    "Slap Bass 1", "Slap Bass 2", "Synth Bass 1", "Synth Bass 2", "Violin",
    "Viola", "Cello", "Contrabass", "Tremolo Strings", "Pizzicato Strings",
    "Orchestral Harp", "Timpani", "String Ensemble 1", "String Ensemble 2",
    "Synth Strings 1", "Synth Strings 2", "Choir Aahs", "Voice Oohs",
    "Synth Voice", "Orchestra Hit", "Trumpet", "Trombone", "Tuba",
    "Muted Trumpet", "French Horn", "Brass Section", "Synth Brass 1",
    "Synth Brass 2", "Soprano Sax", "Alto Sax", "Tenor Sax", "Baritone Sax",
    "Oboe", "English Horn", "Bassoon", "Clarinet", "Piccolo", "Flute",
    "Recorder", "Pan Flute", "Blown Bottle", "Shakuhachi", "Whistle",
    "Ocarina", "Lead 1 (square)", "Lead 2 (sawtooth)", "Lead 3 (calliope)",
    "Lead 4 (chiff)", "Lead 5 (charang)", "Lead 6 (voice)", "Lead 7 (fifths)",
    "Lead 8 (bass + lead)", "Pad 1 (new age)", "Pad 2 (warm)",
    "Pad 3 (polysynth)", "Pad 4 (choir)", "Pad 5 (bowed)", "Pad 6 (metallic)",
    "Pad 7 (halo)", "Pad 8 (sweep)", "FX 1 (rain)", "FX 2 (soundtrack)",
    "FX 3 (crystal)", "FX 4 (atmosphere)", "FX 5 (brightness)",
    "FX 6 (goblins)", "FX 7 (echoes)", "FX 8 (sci-fi)", "Sitar", "Banjo",
    "Shamisen", "Koto", "Kalimba", "Bag pipe", "Fiddle", "Shanai",
    "Tinkle Bell", "Agogo", "Steel Drums", "Woodblock", "Taiko Drum",
    "Melodic Tom", "Synth Drum", "Reverse Cymbal", "Guitar Fret Noise",
    "Breath Noise", "Seashore", "Bird Tweet", "Telephone Ring", "Helicopter",
    "Applause", "Gunshot",
)


# General MIDI percussion-key names (public MIDI specification, keys 35-81),
# used for Slakh drum-track formatting (reference contract:
# m2t/preprocessing/jsonify.py:230-260 + slakh2100_redux DRUM_PITCH_TO_NAME).
GM_DRUM_PITCH_TO_NAME: Dict[int, str] = {
    35: "Acoustic Bass Drum", 36: "Bass Drum", 37: "Side Stick",
    38: "Acoustic Snare", 39: "Hand Clap", 40: "Snare",
    41: "Low Floor Tom", 42: "Closed Hi-hat", 43: "High Floor Tom",
    44: "Pedal Hi-hat", 45: "Low Tom", 46: "Open Hi-hat",
    47: "Low-Mid Tom", 48: "Hi-Mid Tom", 49: "Crash Cymbal 1",
    50: "High Tom", 51: "Ride Cymbal 1", 52: "Chinese Cymbal",
    53: "Ride Bell", 54: "Tambourine", 55: "Splash Cymbal",
    56: "Cowbell", 57: "Crash Cymbal 2", 58: "Vibraslap",
    59: "Ride Cymbal 2", 60: "High Bongo", 61: "Low Bongo",
    62: "Mute High Conga", 63: "Open High Conga", 64: "Low Conga",
    65: "High Timbale", 66: "Low Timbale", 67: "High Agogo",
    68: "Low Agogo", 69: "Cabasa", 70: "Maracas",
    71: "Short Whistle", 72: "Long Whistle", 73: "Short Guiro",
    74: "Long Guiro", 75: "Claves", 76: "High Woodblock",
    77: "Low Woodblock", 78: "Mute Cuica", 79: "Open Cuica",
    80: "Mute Triangle", 81: "Open Triangle",
}

# GM program-family names (programs 0-127 in groups of 8; public spec),
# the Slakh instrument-class taxonomy.
GM_FAMILIES = (
    "Piano", "Chromatic Percussion", "Organ", "Guitar", "Bass", "Strings",
    "Ensemble", "Brass", "Reed", "Pipe", "Synth Lead", "Synth Pad",
    "Synth Effects", "Ethnic", "Percussive", "Sound Effects",
)


def program_to_family(program: int) -> str:
    """GM program -> instrument family / Slakh class name."""
    return GM_FAMILIES[max(0, min(127, program)) // 8]


def pitch_to_note_label(pitch: int) -> str:
    """MIDI pitch -> note label with octave, e.g. 60 -> 'C4'."""
    return f"{NOTE_LABELS[pitch % 12]}{pitch // 12 - 1}"


def program_to_instrument(
    program: int, one_indexed: bool = False, pizzicato_to_violin: bool = False
) -> str:
    """GM program -> instrument name, with MusicNet corrections
    (reference m2t/dataset_utils/midi.py:167-210)."""
    p = program - 1 if one_indexed else program
    p = max(0, min(127, p))
    name = GM_PROGRAMS[p]
    if pizzicato_to_violin and name == "Pizzicato Strings":
        name = "Violin"
    return name


# ---------------------------------------------------------------------------
# Standard MIDI File parser (formats 0/1)
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def parse_midi(data: bytes) -> List[Dict[str, Any]]:
    """Parse SMF bytes -> notes [{pitch, start_tick, end_tick, program,
    channel, velocity}] plus a tempo map applied to produce seconds."""
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    (hlen,) = struct.unpack(">I", data[4:8])
    fmt, ntrk, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division unsupported")
    pos = 8 + hlen

    tempo_events: List[Tuple[int, int]] = [(0, 500000)]  # (tick, us/quarter)
    raw_notes: List[Dict[str, Any]] = []

    for _ in range(ntrk):
        if data[pos : pos + 4] != b"MTrk":
            break
        (tlen,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        track = data[pos + 8 : pos + 8 + tlen]
        pos += 8 + tlen

        tick = 0
        tpos = 0
        running = 0
        program_by_channel = defaultdict(int)
        active: Dict[Tuple[int, int], Dict[str, Any]] = {}
        while tpos < len(track):
            delta, tpos = _read_varlen(track, tpos)
            tick += delta
            status = track[tpos]
            if status & 0x80:
                tpos += 1
                running = status
            else:
                status = running
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90 or kind == 0x80:  # note on/off
                pitch = track[tpos]
                vel = track[tpos + 1]
                tpos += 2
                key = (channel, pitch)
                if kind == 0x90 and vel > 0:
                    active[key] = {
                        "pitch": pitch,
                        "start_tick": tick,
                        "velocity": vel,
                        "channel": channel,
                        "program": program_by_channel[channel],
                    }
                else:
                    note = active.pop(key, None)
                    if note is not None:
                        note["end_tick"] = tick
                        raw_notes.append(note)
            elif kind in (0xA0, 0xB0, 0xE0):
                tpos += 2
            elif kind == 0xC0:  # program change
                program_by_channel[channel] = track[tpos]
                tpos += 1
            elif kind == 0xD0:
                tpos += 1
            elif status == 0xFF:  # meta
                meta = track[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(track, tpos)
                if meta == 0x51 and mlen == 3:
                    us = int.from_bytes(track[tpos : tpos + 3], "big")
                    tempo_events.append((tick, us))
                tpos += mlen
            elif status in (0xF0, 0xF7):  # sysex
                mlen, tpos = _read_varlen(track, tpos)
                tpos += mlen
            else:
                break
        # close any dangling notes at track end
        for note in active.values():
            note["end_tick"] = tick
            raw_notes.append(note)

    tempo_events.sort()

    def tick_to_seconds(t: int) -> float:
        seconds = 0.0
        prev_tick, prev_us = tempo_events[0]
        for ev_tick, ev_us in tempo_events[1:]:
            if ev_tick >= t:
                break
            seconds += (ev_tick - prev_tick) * prev_us / (1e6 * division)
            prev_tick, prev_us = ev_tick, ev_us
        return seconds + (t - prev_tick) * prev_us / (1e6 * division)

    for n in raw_notes:
        n["start"] = round(tick_to_seconds(n["start_tick"]), 4)
        n["end"] = round(tick_to_seconds(n["end_tick"]), 4)
    raw_notes.sort(key=lambda n: (n["start"], n["pitch"]))
    return raw_notes


def get_formatted_notes_list(
    notes: List[Dict[str, Any]],
    one_indexed_programs: bool = False,
    pizzicato_to_violin: bool = False,
) -> Dict[str, List[Dict[str, Any]]]:
    """Group notes by instrument name with readable pitch labels
    (reference contract: {'Violin': [{'start','end','pitch'}...], ...})."""
    by_inst: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for n in notes:
        inst = program_to_instrument(
            n.get("program", 0), one_indexed_programs, pizzicato_to_violin
        )
        by_inst[inst].append(
            {
                "start": n["start"],
                "end": n["end"],
                "pitch": pitch_to_note_label(n["pitch"]),
            }
        )
    return dict(by_inst)


def format_slakh_notes_list(
    notes: List[Dict[str, Any]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Slakh per-instrument note lists: drum-channel notes map to GM
    percussion names under a 'Drums' instrument (unknown drum pitches are
    skipped — missing beats wrong); melodic notes map to their GM program
    name with a readable pitch label (reference contract:
    m2t/preprocessing/jsonify.py:230-260)."""
    by_inst: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for n in notes:
        if n.get("channel") == 9:  # GM percussion channel
            name = GM_DRUM_PITCH_TO_NAME.get(n["pitch"])
            if name is None:
                continue
            inst, pitch = "Drums", name
        else:
            inst = program_to_instrument(n.get("program", 0))
            pitch = pitch_to_note_label(n["pitch"])
        by_inst[inst].append(
            {"start": round(n["start"], 2), "end": round(n["end"], 2), "pitch": pitch}
        )
    return dict(by_inst)
