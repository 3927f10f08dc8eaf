"""The port's WebDataset evaluation CLI (`inference/from_webdataset.py`)
against the JAX package's, on the CPU.

The same tar shard (written here: `.pyd` and `.npy` encodings, crop-window
keys, a sample without an encoding) goes through both packages' row
readers, which must give EQUAL rows. The CLI reads a run directory of the
port's `train()`; its CSV rows must EQUAL `batch_infer` /
`batch_infer_continuous` on the loaded model, and its greedy completions
the JAX package's `batch_infer` on the same numpy parameters (both sides
compute in fp32; greedy tokens are equal, as tests/test_torch_server.py
holds them).
"""

import csv
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu import infer as jinfer
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.data.shards import expand_url_to_file_list as jexpand
from llark_tpu.dataset_utils import wds_key_to_original_id as jkey
from llark_tpu.inference import beam as jbeam
from llark_tpu.inference import from_webdataset as jwds
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu_torch import generate as tgen
from llark_tpu_torch import infer as tinfer
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.dataset_utils import wds_key_to_original_id
from llark_tpu_torch.inference import from_webdataset
from llark_tpu_torch.inference.beam import BeamSearchConfig, BeamSearcher
from llark_tpu_torch.inference.speculative import SpeculativeGenerator
from llark_tpu_torch.models.utils import load_pretrained_model
from llark_tpu_torch.train.train import train

MM = 16
MAX_NEW = 5
QUESTIONS = ["what is the tempo ?", "what genre is this ?", "describe the mood .",
             "which instruments play ?"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = [
    "track001-start30_000-end60_000",
    "dir/track002-start0_500-end10_250",
    "my_song_with_underscores",
    "track003-start30_000",
    "plain",
    "a_1-start12_0-end13_5-extra_9",
]


@pytest.mark.parametrize("key", KEYS)
def test_wds_key_to_original_id_matches_jax(key):
    assert wds_key_to_original_id(key) == jkey(key)


def _write_eval_shards(directory):
    """Two shards: 7 samples, the odd ones with an .npy encoding, the even
    ones with .pyd, and sample 3 with none (skipped by both readers)."""
    rng = np.random.RandomState(11)
    writer = TarShardWriter(str(directory / "eval-%03d.tar"), max_count=4)
    for i in range(7):
        sample = {"__key__": f"track{i:03d}-start30_000-end60_000",
                  "json": {"response": [{"question": QUESTIONS[i % 4],
                                         "answer": f"answer {i} ."}]}}
        if i == 5:
            sample["json"] = {"response": []}  # no question: the default prompt
        if i != 3:
            enc = rng.randn(3 + i % 3, MM).astype(np.float32)
            sample["audio_encoding.npy" if i % 2 else "audio_encoding.pyd"] = enc
        writer.write(sample)
    writer.close()
    return str(directory / "eval-{000..001}.tar")


@pytest.mark.parametrize("max_samples", [None, 1, 4, 100])
def test_iter_eval_rows_matches_jax(tmp_path, max_samples):
    pattern = _write_eval_shards(tmp_path)
    urls = from_webdataset.expand_url_to_file_list(pattern)
    assert urls == jexpand(pattern) and len(urls) == 2
    got = list(from_webdataset.iter_eval_rows(urls, max_samples))
    want = list(jwds.iter_eval_rows(urls, max_samples))
    assert len(got) == len(want) == min(6, max_samples or 6)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g.pop("audio_encoding"), w.pop("audio_encoding"))
        assert g == w
    assert got[0]["example_id"] == "track000-start30.000-end60.000"


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory of the port's train() (tiny fp32 model, one step),
    an eval shard pattern, and the JAX package's greedy rows for the
    shard's samples on the same numpy parameters (and its 2-beam rows,
    under the key "beams")."""
    root = tmp_path_factory.mktemp("wds")
    writer = TarShardWriter(str(root / "mir-train-%05d.tar"), max_count=10)
    rng = np.random.RandomState(6)
    for i in range(4):
        writer.write({"__key__": f"t{i}", "json": {"response": [
            {"question": QUESTIONS[i], "answer": "ambient jazz at a slow tempo ."}]},
            "audio_encoding.pyd": rng.randn(4, MM).astype(np.float32)})
    writer.close()
    run = root / "run"
    train(ModelArguments(model_name_or_path="tiny", mm_hidden_size=MM),
          DataArguments(train_data_path=writer.written_paths[0], max_audio_frames=4,
                        task_sample_probs={"mir": 1.0}),
          TrainingArguments(output_dir=str(run), per_device_train_batch_size=2,
                            model_max_length=64, max_steps=1, save_steps=1, seed=0),
          model_cfg=ModelConfig.tiny(mm_hidden_size=MM, dtype="float32"), device="cpu")
    pattern = _write_eval_shards(root)
    cfg, params, bundle = load_pretrained_model(str(run), device="cpu")
    rows = list(from_webdataset.iter_eval_rows(from_webdataset.expand_url_to_file_list(pattern)))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jparams = {k: ({n: jnp.asarray(t.numpy()) for n, t in v.items()} if isinstance(v, dict)
                   else jnp.asarray(v.numpy())) for k, v in params.items()}
    jgen_cfg = jgen.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="###")
    generator = jgen.Generator(jcfg, jparams, bundle.audio_patch_id, jgen_cfg, max_cache_len=256)
    searcher = jbeam.BeamSearcher(
        jcfg, jparams, bundle.audio_patch_id,
        jbeam.BeamSearchConfig(num_beams=2, max_new_tokens=MAX_NEW, stop_text="###"),
        max_cache_len=256)
    jax_rows = {}
    for prompt, gen in ((None, generator), ("Describe the audio.", generator), ("beams", searcher)):
        # the word-level tokenizer interns words as it meets them: each run
        # starts from the saved vocabulary, as each CLI run does
        jbundle = JBundle.from_tokenizer(JWordTokenizer.from_dict(bundle.tokenizer.to_dict()),
                                         bundle.model_max_length)
        jax_rows[prompt] = jinfer.batch_infer(rows, gen, jbundle,
                                              prompt_override=None if prompt == "beams" else prompt)
    return run, pattern, jax_rows


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


CLI_RUNS = {
    "one_at_a_time": [],
    "prompt_override": ["--prompt", "Describe the audio."],
    "max_samples": ["--max-samples", "2"],
    "continuous_dense": ["--continuous-batching", "2"],
    "continuous_paged_int8": ["--continuous-batching", "3", "--kv-block-size", "16",
                              "--kv-cache-int8", "--prefill-chunk", "64"],
}


@pytest.mark.parametrize("run_name", list(CLI_RUNS))
def test_cli_rows_match_the_loaded_model_and_jax(run_dir, tmp_path, run_name):
    run, pattern, jax_rows = run_dir
    extra = CLI_RUNS[run_name]
    out_csv = tmp_path / "out.csv"
    from_webdataset.main(["--checkpoint-dir", str(run), "--input", pattern, "--output",
                          str(out_csv), "--max-new-tokens", str(MAX_NEW), "--max-cache-len",
                          "256", "--device", "cpu", *extra])
    got = _read_csv(out_csv)
    # the same rows through the port's batch_infer on the loaded model
    cfg, params, bundle = load_pretrained_model(str(run), device="cpu")
    rows = list(from_webdataset.iter_eval_rows(from_webdataset.expand_url_to_file_list(pattern)))
    prompt = extra[1] if "--prompt" in extra else None
    if "--max-samples" in extra:
        rows = rows[: int(extra[1])]
    gen_cfg = tgen.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="###")
    if "--continuous-batching" in extra:
        kw = dict(max_batch=int(extra[1]), max_cache_len=256, prompt_override=prompt,
                  device="cpu")
        if "--kv-block-size" in extra:
            cfg = dataclasses.replace(cfg, kv_cache_quant=True)
            kw.update(kv_block_size=16, prefill_chunk=64)
        want = tinfer.batch_infer_continuous(rows, cfg, params, bundle, gen_cfg=gen_cfg, **kw)
    else:
        generator = tgen.Generator(cfg, params, bundle.audio_patch_id, gen_cfg,
                                   max_cache_len=256, device="cpu")
        want = tinfer.batch_infer(rows, generator, bundle, prompt_override=prompt)
    assert got == [{k: str(v) for k, v in r.items()} for r in want]
    assert [r["example_id"] for r in got][:2] == ["track000-start30.000-end60.000",
                                                  "track001-start30.000-end60.000"]
    assert len(got) == (2 if "--max-samples" in extra else 6)
    # greedy completions equal to the JAX package's on the same parameters
    # (an int8 cache differs from JAX's fp32 one by quantization noise)
    if "--kv-cache-int8" not in extra:
        jax_want = jax_rows[prompt][: len(got)]
        assert [r["model_completion"] for r in got] == [r["model_completion"] for r in jax_want]
        assert [r["prompt"] for r in got] == [r["prompt"] for r in jax_want]


@pytest.mark.parametrize("flags", [["--speculative", "ngram"], ["--num-beams", "2"]])
def test_cli_refuses_what_the_port_does_not_run(run_dir, tmp_path, flags):
    # the CSV rows of n-gram speculation and of beam search equal the
    # loaded model's through the same generator, and the JAX package's:
    # plain greedy rows for n-gram speculation (equal at fp32), its
    # BeamSearcher's for beams
    run, pattern, jax_rows = run_dir
    out_csv = tmp_path / "out.csv"
    from_webdataset.main(["--checkpoint-dir", str(run), "--input", pattern, "--output",
                          str(out_csv), "--max-new-tokens", str(MAX_NEW), "--max-cache-len",
                          "256", "--device", "cpu", *flags])
    got = _read_csv(out_csv)
    cfg, params, bundle = load_pretrained_model(str(run), device="cpu")
    rows = list(from_webdataset.iter_eval_rows(from_webdataset.expand_url_to_file_list(pattern)))
    if flags[0] == "--num-beams":
        gen = BeamSearcher(cfg, params, bundle.audio_patch_id,
                           BeamSearchConfig(num_beams=2, max_new_tokens=MAX_NEW, stop_text="###"),
                           max_cache_len=256, device="cpu")
    else:
        gen = SpeculativeGenerator(
            cfg, params, bundle.audio_patch_id,
            tgen.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="###"),
            max_cache_len=256, device="cpu")
    want = tinfer.batch_infer(rows, gen, bundle)
    assert got == [{k: str(v) for k, v in r.items()} for r in want]
    jax_want = jax_rows["beams" if flags[0] == "--num-beams" else None]
    assert len(got) == 6
    assert [r["model_completion"] for r in got] == [r["model_completion"] for r in jax_want]
    assert [r["example_id"] for r in got] == [r["example_id"] for r in jax_want]
