"""The port's `instruct/`, `keys.py` and `notebook_lib.py` against the JAX
package's, on the same inputs.

Mirrors the instruction-data cases of tests/test_instruct_eval.py: JSON
repair, the prompt helpers and their registry, response validation,
caption QA, and the fetch pipeline over a fake transport (a first call
that fails and is retried, shards of one row). Every case runs both
packages and compares what they return or write. The OpenAI client is
never imported for real: `openai` is not installed, so `main` runs over a
stub module.
"""

import json
import os
import random
import sys
import types

import numpy as np
import pytest

from llark_tpu import keys as jkeys
from llark_tpu import notebook_lib as jnb
from llark_tpu.dataset_utils import DATASET_INFO as JDATASET_INFO
from llark_tpu.instruct import captioning as jcap
from llark_tpu.instruct import data_validation as jdv
from llark_tpu.instruct import fetch_openai as jfo
from llark_tpu.instruct import json_utils as jju
from llark_tpu.instruct import prompting as jpr
from llark_tpu_torch import keys, notebook_lib
from llark_tpu_torch.dataset_utils import DATASET_INFO
from llark_tpu_torch.instruct import FewShotExample
from llark_tpu_torch.instruct import captioning as cap
from llark_tpu_torch.instruct import data_validation as dv
from llark_tpu_torch.instruct import fetch_openai as fo
from llark_tpu_torch.instruct import json_utils as ju
from llark_tpu_torch.instruct import prompting as pr
from llark_tpu_torch.instruct.fewshot_examples.mirqa import MIRQA_FEWSHOT_EXAMPLES
from llark_tpu_torch.instruct.fewshot_examples.reasoning_qa import REASONING_QA_FEWSHOT_EXAMPLES

ALMOST_JSON = ['[{"a": 1}]', '```json\n[{"a": 1}]\n```', 'Sure! Here it is: [{"a": 1},]',
               '{"a": None, "b": True}', "[{'q': 'x'}]", "no json here at all"]


def _both(fn_port, fn_ref, *args):
    """Each package's result, or the type of what it raised."""
    out = []
    for fn in (fn_port, fn_ref):
        try:
            out.append(fn(*args))
        except Exception as e:  # noqa: BLE001 — the error is the result
            out.append(type(e))
    return out


@pytest.mark.parametrize("text", ALMOST_JSON)
def test_parse_almost_json_variants(text):
    got, want = _both(ju.parse_almost_json, jju.parse_almost_json, text)
    assert got == want
    if text == "no json here at all":
        assert got is ValueError


def test_oxford_comma_and_unnest():
    for items in ([], ["a"], ["a", "b"], ["a", "b", "c"]):
        assert ju.oxford_comma(items) == jju.oxford_comma(items)
    nested = ["x", ["y", ["z"]], {"drop": 1}]
    assert ju.unnest_list(nested) == jju.unnest_list(nested) == ["x", "y", "z"]


def test_correct_element():
    row = {"genre": "rock", "mood": ["happy", ["calm"]], "language": None,
           "invented": ["x"], "title": "t"}
    out = pr.correct_element(dict(row))
    assert out == jpr.correct_element(dict(row))
    assert out["genre"] == ["rock"] and out["mood"] == ["happy", "calm"]
    assert out["language"] == [] and "invented" not in out
    assert pr.EXPECTED_FIELDS == jpr.EXPECTED_FIELDS
    assert pr.OPTIONAL_FIELDS == jpr.OPTIONAL_FIELDS and pr.DEFAULT_PROMPT == jpr.DEFAULT_PROMPT


def test_dataset_info_is_the_reference():
    assert sorted(DATASET_INFO) == sorted(JDATASET_INFO)
    for name, info in DATASET_INFO.items():
        assert info.name == JDATASET_INFO[name].name


@pytest.mark.parametrize("dataset", ["mtg-jamendo", "fma", "musicnet", "musiccaps", "fsl10k"])
@pytest.mark.parametrize("prompt_type", ["default", "mir", "reasoning", "captioning"])
def test_prompt_helpers_build_messages(prompt_type, dataset):
    """The prompt text (a shipped .txt beside the module, else the
    template) and the messages, few-shot or not, equal the reference's."""
    for few_shot in (False, True):
        helper = pr.get_prompt_helper(prompt_type, DATASET_INFO[dataset], few_shot)
        ref = jpr.get_prompt_helper(prompt_type, JDATASET_INFO[dataset], few_shot)
        assert type(helper).__name__ == type(ref).__name__
        assert helper.get_prompt_text() == ref.get_prompt_text()
        query = {"tempo": 120, "name": "Song", "artist": [{"name": "A"}]}
        assert helper.get_chatgpt_query(query) == ref.get_chatgpt_query(query)
        assert helper.build_messages(helper.get_prompt_text(), query) == \
            ref.build_messages(ref.get_prompt_text(), query)
    msgs = pr.get_prompt_helper("mir", DATASET_INFO["mtg-jamendo"], True).build_messages("s", {})
    roles = [m["role"] for m in msgs[1:-1]]
    assert roles and roles[::2] == ["user"] * (len(roles) // 2)
    got, want = _both(lambda: pr.get_prompt_helper("nope", DATASET_INFO["fma"], False),
                      lambda: jpr.get_prompt_helper("nope", JDATASET_INFO["fma"], False))
    assert got == want == KeyError  # no template of that name


def test_prompt_files_ship_beside_the_module():
    here = os.path.dirname(pr.__file__)
    there = os.path.dirname(jpr.__file__)
    names = sorted(n for n in os.listdir(there) if n.endswith(".txt"))
    assert len(names) == 10 and sorted(n for n in os.listdir(here) if n.endswith(".txt")) == names
    for n in names:
        with open(os.path.join(here, n)) as a, open(os.path.join(there, n)) as b:
            assert a.read() == b.read()


def test_fewshot_examples_are_the_reference():
    from llark_tpu.instruct.fewshot_examples import mirqa as jm
    from llark_tpu.instruct.fewshot_examples import reasoning_qa as jr

    for got, want in ((MIRQA_FEWSHOT_EXAMPLES, jm.MIRQA_FEWSHOT_EXAMPLES),
                      (REASONING_QA_FEWSHOT_EXAMPLES, jr.REASONING_QA_FEWSHOT_EXAMPLES)):
        assert [(e.user, e.assistant) for e in got] == [(e.user, e.assistant) for e in want]
        assert all(isinstance(e, FewShotExample) for e in got)


@pytest.mark.parametrize("text", ['[{"question": "What key?", "answer": "A minor."}]',
                                  '[{"q": 1}]', '{"question": "x", "answer": "y"}'])
def test_mir_postprocess_and_schema(text):
    helper = pr.get_prompt_helper("mir", DATASET_INFO["fma"], False)
    ref = jpr.get_prompt_helper("mir", JDATASET_INFO["fma"], False)
    got, want = _both(lambda t: helper.postprocess_response_text(t, {"id": "x"}, "uri-1"),
                      lambda t: ref.postprocess_response_text(t, {"id": "x"}, "uri-1"), text)
    assert got == want
    if "What key" in text:
        assert got["response"][0]["answer"] == "A minor." and got["uri"] == "uri-1"
    else:
        assert got is ValueError


def test_basic_and_captioning_prompt_helpers_roundtrip():
    helper = pr.get_prompt_helper("default", DATASET_INFO["fma"], False)
    ref = jpr.get_prompt_helper("default", JDATASET_INFO["fma"], False)
    meta = {"name": "Song", "artist": [{"name": "A"}, {"name": "B"}]}
    q = helper.get_chatgpt_query(meta)
    assert q == ref.get_chatgpt_query(meta) == {"title": "Song", "artist": "A and B"}
    resp = {f: ["x"] for f in pr.EXPECTED_FIELDS}
    row = helper.postprocess_response_text(json.dumps([resp]), q, "u1")
    assert row == ref.postprocess_response_text(json.dumps([resp]), q, "u1")
    assert row["genre"] == ["x"] and row["uri"] == "u1"
    cap_helper = pr.get_prompt_helper("captioning", DATASET_INFO["musiccaps"], False)
    cap_ref = jpr.get_prompt_helper("captioning", JDATASET_INFO["musiccaps"], False)
    assert cap_helper.postprocess_response_text("A calm piece.", {"id": 1}, "u") == \
        cap_ref.postprocess_response_text("A calm piece.", {"id": 1}, "u")


QA = [{"question": "What key?", "answer": "A minor."},
      {"question": "What key?", "answer": "Based on the metadata, A minor."},
      {"question": "What does the JSON say?", "answer": "x"},
      {"question": "ok?", "answer": "fine."},
      {"question": "bad", "answer": "according to the annotations it is fast"},
      {"question": " ", "answer": "x"}, {"question": "q"}, "not a dict"]


def test_data_validation():
    for qa in QA:
        assert dv.qa_pair_is_valid(qa) == jdv.qa_pair_is_valid(qa)
    assert dv.qa_pair_is_valid(QA[0]) and not dv.qa_pair_is_valid(QA[1])
    out = dv.drop_invalid_qa_responses({"response": list(QA)})
    assert out == jdv.drop_invalid_qa_responses({"response": list(QA)})
    assert len(out["response"]) == 2
    assert dv.DISALLOWED_ANSWER_PHRASES == jdv.DISALLOWED_ANSWER_PHRASES
    assert dv.DISALLOWED_QUESTION_PHRASES == jdv.DISALLOWED_QUESTION_PHRASES


@pytest.mark.parametrize("dataset", ["musiccaps", "wavcaps", "unknown"])
def test_insert_caption_qa(dataset):
    got = cap.insert_caption_qa({"caption": "a jazz trio plays"}, dataset, rng=random.Random(0))
    want = jcap.insert_caption_qa({"caption": "a jazz trio plays"}, dataset,
                                  rng=random.Random(0))
    assert got == want and got["response"][0]["answer"] == "a jazz trio plays"
    pool = cap.LONG_CAPTION_PROMPTS if dataset == "musiccaps" else cap.SHORT_CAPTION_PROMPTS
    assert got["response"][0]["question"] in pool
    assert cap.LONG_CAPTION_PROMPTS == jcap.LONG_CAPTION_PROMPTS
    assert cap.SHORT_CAPTION_PROMPTS == jcap.SHORT_CAPTION_PROMPTS
    assert cap.insert_caption_qa({}, dataset) == {}


def _flaky_transport():
    calls = {"n": 0}

    def transport(messages):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("rate limit")  # first call fails -> retry
        return '[{"question": "Tempo?", "answer": "120 BPM."}]'

    return transport


def test_fetch_pipeline_with_fake_transport(tmp_path, monkeypatch):
    monkeypatch.setattr(fo.time, "sleep", lambda *_: None)  # the same module in both
    rows = [{"id": "a", "tempo": 120}, {"id": "b", "tempo": 90}]
    written = {}
    for name, mod, pmod, info in (("port", fo, pr, DATASET_INFO),
                                  ("reference", jfo, jpr, JDATASET_INFO)):
        helper = pmod.get_prompt_helper("mir", info["mtg-jamendo"], False)
        writer = mod.ShardedJsonlWriter(str(tmp_path / name), "mir-test", shard_size=1)
        n = mod.fetch_instruct_data(rows, helper, _flaky_transport(), writer, num_workers=1)
        assert n == 2
        shards = sorted((tmp_path / name).glob("mir-test-*.jsonl"))
        assert len(shards) == 2  # shard_size=1 -> one row per shard
        written[name] = [(p.name, p.read_text()) for p in shards]
    assert written["port"] == written["reference"]
    assert json.loads(written["port"][0][1])["response"][0]["answer"] == "120 BPM."


def test_prompt_one_gives_up(monkeypatch):
    monkeypatch.setattr(fo.time, "sleep", lambda *_: None)

    def transport(messages):
        raise RuntimeError("always fails")

    helper = pr.get_prompt_helper("mir", DATASET_INFO["fma"], False)
    assert fo.prompt_one({"id": "x"}, helper, transport, max_retries=2) is None
    assert fo.MAX_RETRIES == jfo.MAX_RETRIES


def _fake_openai(reply):
    """A stub `openai` module whose chat completions return `reply`."""
    calls = []

    class _Completions:
        def create(self, model, messages):
            calls.append((model, messages))
            msg = types.SimpleNamespace(content=reply)
            return types.SimpleNamespace(choices=[types.SimpleNamespace(message=msg)])

    class _Client:
        def __init__(self):
            self.chat = types.SimpleNamespace(completions=_Completions())

    return types.SimpleNamespace(OpenAI=_Client), calls


def test_fetch_main_over_a_stub_client(tmp_path, monkeypatch, capsys):
    """The CLI end to end: the input JSONL, `default_transport` over the
    (stubbed) client, sharded output named by prompt type and dataset."""
    stub, calls = _fake_openai('[{"question": "Key?", "answer": "E major."}]')
    monkeypatch.setitem(sys.modules, "openai", stub)
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps({"id": i, "key": "E major"}) + "\n" for i in range(3)))
    out = {}
    for name, mod in (("port", fo), ("reference", jfo)):
        mod.main(["--input", str(src), "--output-dir", str(tmp_path / name), "--prompt-type",
                  "reasoning", "--dataset-name", "fma", "--model", "m1", "--few-shot",
                  "--num-workers", "2", "--shard-size", "2"])
        assert capsys.readouterr().out.strip() == f"wrote 3/3 rows to {tmp_path / name}"
        out[name] = sorted((p.name, p.read_text()) for p in (tmp_path / name).iterdir())
    assert out["port"] == out["reference"]
    assert [n for n, _ in out["port"]] == ["reasoning-fma-00000.jsonl", "reasoning-fma-00001.jsonl"]
    assert len(calls) == 6 and {c[0] for c in calls} == {"m1"}
    assert calls[0][1] == calls[3][1]  # the same messages from both packages


def test_keys_read_the_environment(monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "k1")
    monkeypatch.delenv("OPENAI_ORGANIZATION", raising=False)
    monkeypatch.delenv("HUGGING_FACE_HUB_TOKEN", raising=False)
    monkeypatch.setenv("HF_TOKEN", "h1")
    for fn in ("openai_api_key", "openai_organization", "hugging_face_hub_token"):
        assert getattr(keys, fn)() == getattr(jkeys, fn)()
    assert keys.openai_api_key() == "k1" and keys.hugging_face_hub_token() == "h1"
    assert keys.openai_organization() is None


@pytest.mark.parametrize("shape", [(441,), (2, 441)])
def test_notebook_audio_player(shape, monkeypatch):
    audio = np.random.RandomState(0).uniform(-1.2, 1.2, shape).astype(np.float32)
    html = notebook_lib.audio_player_html(audio, 22050)
    assert html == jnb.audio_player_html(audio, 22050)
    assert html.startswith('<audio controls="controls">') and "base64," in html
    shown = []
    display = types.SimpleNamespace(HTML=lambda h: ("HTML", h), display=shown.append)
    monkeypatch.setitem(sys.modules, "IPython", types.SimpleNamespace(display=display))
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    assert notebook_lib.display_audio(audio, 22050) == html and shown == [("HTML", html)]
