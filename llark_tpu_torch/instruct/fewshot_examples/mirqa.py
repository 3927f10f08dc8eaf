"""Few-shot exemplars for MIR question answering (structure parity with
m2t/instruct/fewshot_examples/mirqa.py; examples re-authored)."""

from llark_tpu_torch.instruct import FewShotExample

MIRQA_FEWSHOT_EXAMPLES = [
    FewShotExample(
        user=[
            {
                "tempo_in_beats_per_minute_madmom": 128.0,
                "key": "A minor",
                "downbeats_madmom": [
                    {"time": 0.47, "beat_number": 1},
                    {"time": 0.94, "beat_number": 2},
                    {"time": 1.41, "beat_number": 3},
                    {"time": 1.88, "beat_number": 4},
                    {"time": 2.35, "beat_number": 1},
                ],
                "chords": [
                    {"start_time": 0.0, "end_time": 1.9, "chord": "A minor"},
                    {"start_time": 1.9, "end_time": 3.8, "chord": "F major"},
                ],
                "tags": ["electronic", "club", "synth"],
            }
        ],
        assistant=[
            {
                "question": "What is the tempo of this track?",
                "answer": "The track sits at about 128 beats per minute, a "
                "typical club tempo.",
            },
            {
                "question": "What key is the music in?",
                "answer": "It is in A minor.",
            },
            {
                "question": "How many beats are there per bar?",
                "answer": "The beats group into fours, so the piece is in 4/4 time.",
            },
            {
                "question": "Which chords open the progression?",
                "answer": "It opens on A minor and then moves to F major.",
            },
        ],
    ),
    FewShotExample(
        user=[
            {
                "tempo_in_beats_per_minute_madmom": 86.5,
                "key": "E major",
                "chords": [
                    {"start_time": 0.0, "end_time": 2.8, "chord": "E major"},
                    {"start_time": 2.8, "end_time": 5.5, "chord": "B major"},
                ],
                "tags": ["acoustic", "guitar", "folk"],
            }
        ],
        assistant=[
            {
                "question": "Roughly how fast is this song?",
                "answer": "It moves at a relaxed pace of roughly 86 beats per "
                "minute.",
            },
            {
                "question": "What harmony underpins the opening?",
                "answer": "The opening rests on an E major chord before moving "
                "to B major, and the overall key is E major.",
            },
        ],
    ),
]
