"""Few-shot exemplars for musical-reasoning QA (structure parity with
m2t/instruct/fewshot_examples/reasoning_qa.py; examples re-authored)."""

from llark_tpu_torch.instruct import FewShotExample

REASONING_QA_FEWSHOT_EXAMPLES = [
    FewShotExample(
        user=[
            {
                "tempo_in_beats_per_minute_madmom": 172.0,
                "key": "F# minor",
                "tags": ["drum and bass", "dark", "bass"],
                "chords": [
                    {"start_time": 0.0, "end_time": 4.0, "chord": "F# minor"}
                ],
            }
        ],
        assistant=[
            {
                "question": "Why might a DJ slot this track late in a night's set?",
                "answer": "Its very fast tempo of around 172 BPM and dark minor "
                "tonality build intense energy, which suits the peak or late "
                "phase of a set when dancers expect maximum drive.",
            },
            {
                "question": "How do the key and tempo together shape the mood?",
                "answer": "The F# minor harmony lends tension and darkness, and "
                "at drum-and-bass speed that tension feels urgent rather than "
                "melancholic, giving the track a propulsive, brooding character.",
            },
        ],
    ),
    FewShotExample(
        user=[
            {
                "notes": {
                    "Violin": [
                        {"start": 0.0, "end": 0.5, "pitch": "E5"},
                        {"start": 0.5, "end": 1.0, "pitch": "G5"},
                    ],
                    "Cello": [{"start": 0.0, "end": 1.0, "pitch": "C3"}],
                },
                "ensemble": "String Duo",
            }
        ],
        assistant=[
            {
                "question": "How do the two instruments divide their roles here?",
                "answer": "The cello sustains a low C as a harmonic anchor while "
                "the violin moves through E and G above it, so the cello "
                "provides the foundation and the violin carries the melodic "
                "motion — together they outline a C major sonority.",
            }
        ],
    ),
]
