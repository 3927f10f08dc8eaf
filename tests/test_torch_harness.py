"""The port's evaluation harness (`python -m
llark_tpu_torch.evaluation.harness`) prints the JAX CLI's JSON on the same
files: every subcommand, and `genre` under each embedder ('offline' hashed
bag of words, 'openai' over a stub client, 'clap' with a tiny text tower
on the CPU). The JAX CLI's runs happen once, in a module fixture.
"""

import contextlib
import io
import json
import sys
import types

import numpy as np
import pytest
import torch

from llark_tpu.evaluation import harness as jharness
from llark_tpu_torch.encoders.clap import text as ttext
from llark_tpu_torch.evaluation import harness

# the JAX package's clap loader imports it: here, at collection, not in a test
pytest.importorskip("transformers")

RESULTS = """example_id,prompt,response,model_completion
1,What genre is this?,jazz,"This track is a smooth jazz piece with saxophone. ###"
2,What genre is this?,rock,"Assistant: A driving rock song with distorted electric guitars."
3,What genre is this?,classical,"This is a classical orchestral work featuring strings."
4,What key is this in?,C# minor,"The piece is in C-sharp minor."
5,What key is this in?,F major,"It is in F major. ###"
6,What tempo?,120,"The tempo is approximately 121 BPM."
7,What tempo?,90,"Roughly 180 beats per minute."
8,What instruments?,"violin,piano","I hear a violin and a piano playing together."
9,What instruments?,"cello","There are cellos and a flute in this recording."
10,What genre is this?,pop,"Catchy pop with synths and a big chorus."
"""

LABELS = [
    {"example_id": "1", "genre": "jazz"},
    {"example_id": "2", "genre": "Rock"},
    {"example_id": "3", "genre": "classical"},
    {"example_id": "4", "key": "Db minor"},
    {"example_id": "5", "key": "F major"},
    {"example_id": "6", "tempo": 120},
    {"example_id": "7", "tempo": 90},
    {"example_id": "8", "instruments": "violin,piano"},
    {"example_id": "9", "instruments": ["Cello"]},
    {"example_id": "10", "genre": "pop"},
]

GENRES = "jazz,rock,classical,pop"

# case -> the CLI's arguments after --results / --labels
CASES = {
    "genre_offline": ["genre", "--label-set", GENRES],
    "genre_openai": ["genre", "--label-set", GENRES, "--embedder", "openai",
                     "--embedding-model", "m-small"],
    "genre_clap": ["genre", "--label-set", GENRES, "--embedder", "clap"],
    "key": ["key"],
    "tempo": ["tempo"],
    "instruments": ["instruments", "--vocab", "violin,piano,cello,flute"],
    "genre_by_id_col": ["genre", "--label-set", GENRES, "--id-col", "example_id",
                        "--label-col", "genre"],
}


def _stub_openai():
    """An `openai` module whose embeddings are seeded noise a call."""
    calls = []

    class _Embeddings:
        def create(self, model, input):
            calls.append((model, list(input)))
            rng = np.random.RandomState(len(calls))
            data = [types.SimpleNamespace(embedding=rng.randn(8).tolist()) for _ in input]
            return types.SimpleNamespace(data=data)

    class _Client:
        def __init__(self):
            self.embeddings = _Embeddings()

    return types.SimpleNamespace(OpenAI=_Client), calls


def _argv(files, case):
    results, labels, ckpt = files
    argv = CASES[case][:1] + ["--results", results, "--labels", labels] + CASES[case][1:]
    if case == "genre_clap":
        argv += ["--clap-checkpoint", ckpt]
    return argv


def _run(main, argv):
    stub, calls = _stub_openai()
    saved = sys.modules.get("openai")
    sys.modules["openai"] = stub
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    finally:
        if saved is None:
            del sys.modules["openai"]
        else:
            sys.modules["openai"] = saved
    return json.loads(buf.getvalue().strip().splitlines()[-1]), calls


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness")
    (d / "results.csv").write_text(RESULTS)
    (d / "labels.jsonl").write_text("\n".join(json.dumps(r) for r in LABELS))
    cfg = ttext.ClapTextConfig.tiny()
    ttext.save_clap_text_checkpoint(str(d / "clap"), cfg,
                                    ttext.random_init(cfg, torch.Generator().manual_seed(0)))
    return str(d / "results.csv"), str(d / "labels.jsonl"), str(d / "clap")


@pytest.fixture(scope="module")
def reference(files):
    return {case: _run(jharness.main, _argv(files, case)) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_harness_prints_the_reference_json(files, reference, case):
    argv = _argv(files, case)
    if case == "genre_clap":
        argv += ["--device", "cpu"]
    got, calls = _run(harness.main, argv)
    want, want_calls = reference[case]
    assert got == want
    assert calls == want_calls
    if case.startswith("genre"):
        assert got["n"] == 4 and set(got) == {"acc@1", "acc@2", "acc@3", "acc@4", "n"}
    if case == "genre_openai":
        assert len(calls) == 2 and calls[0][0] == "m-small"  # completions, then labels
    if case == "key":
        assert got == {"mirex_weighted": 1.0, "exact": 1.0, "n": 2}
    if case == "tempo":
        assert got["acc_8pct"] == 0.5 and got["acc_8pct_octave"] == 1.0


def test_clap_embedder_needs_a_checkpoint(files):
    results, labels, _ = files
    argv = ["genre", "--results", results, "--labels", labels, "--label-set", GENRES,
            "--embedder", "clap"]
    for main, extra in ((harness.main, ["--device", "cpu"]), (jharness.main, [])):
        with pytest.raises(SystemExit, match="--clap-checkpoint"):
            main(argv + extra)
