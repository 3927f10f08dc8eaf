"""Scripted evaluation harness over inference CSVs (counterpart of
llark_tpu/evaluation/harness.py).

Replaces the reference's five evaluation notebooks (SURVEY.md §2.7/§6)
with one reproducible CLI. Input: the CSV produced by
llark_tpu_torch.inference.* (example_id, prompt, response, model_completion)
plus a labels JSONL mapping example_id -> ground truth.

  python -m llark_tpu_torch.evaluation.harness genre \
      --results results.csv --labels gtzan.jsonl --label-col genre \
      --label-set blues,classical,country,disco,hiphop,jazz,metal,pop,reggae,rock
  python -m llark_tpu_torch.evaluation.harness key    --results r.csv --labels g.jsonl
  python -m llark_tpu_torch.evaluation.harness tempo  --results r.csv --labels g.jsonl
  python -m llark_tpu_torch.evaluation.harness instruments --results r.csv \
      --labels m.jsonl --vocab violin,cello,piano,...

Each command prints one JSON metrics line. `genre --embedder clap` runs
the CLAP text tower on `--device` (the GPU unless the caller asks for the
CPU); no other command touches torch.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List

from llark_tpu_torch.evaluation.utils import (
    acc_at_k,
    bootstrap_ci,
    extract_instruments,
    map_keys_to_giantsteps,
    mirex_key_score,
    rank_labels_by_similarity,
    set_f1,
    tempo_acc,
)


def load_results(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_labels(path: str, id_col: str = "example_id") -> Dict[str, Dict]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                out[str(row[id_col])] = row
    return out


def _join(results, labels, label_col):
    pairs = []
    for r in results:
        lab = labels.get(str(r["example_id"]))
        if lab is not None and label_col in lab:
            pairs.append((r["model_completion"], lab[label_col]))
    return pairs


def _openai_embedder(model: str):
    """texts -> [N, D] via the OpenAI embeddings API — the embedder the
    reference notebooks use (eval_genre_gtzan.ipynb); requires the openai
    package and OPENAI_API_KEY."""
    import numpy as np
    import openai  # type: ignore

    client = openai.OpenAI()

    def embed(texts):
        out = client.embeddings.create(model=model, input=list(texts))
        vecs = np.asarray([d.embedding for d in out.data], np.float32)
        return vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)

    return embed


def cmd_genre(ns):
    results = load_results(ns.results)
    labels = load_labels(ns.labels, ns.id_col)
    pairs = _join(results, labels, ns.label_col)
    completions = [p[0] for p in pairs]
    truths = [str(p[1]).lower() for p in pairs]
    label_set = [l.strip().lower() for l in ns.label_set.split(",")]
    embedder = None  # offline hashed bag-of-words default
    if getattr(ns, "embedder", "offline") == "openai":
        embedder = _openai_embedder(ns.embedding_model)
    elif getattr(ns, "embedder", "offline") == "clap":
        # real on-device embeddings, no API: the CLAP text tower trained
        # contrastively against the HTSAT audio tower
        from llark_tpu_torch.encoders.clap.text import make_text_embedder

        if not ns.clap_checkpoint:
            raise SystemExit("--embedder clap requires --clap-checkpoint "
                             "(an HF CLAP dir, e.g. laion/clap-htsat-unfused)")
        embedder = make_text_embedder(ns.clap_checkpoint, device=ns.device)
    ranked = rank_labels_by_similarity(completions, label_set, embedder=embedder)
    metrics = {
        f"acc@{k}": round(acc_at_k(ranked, truths, k), 4) for k in (1, 2, 3, 4)
    }
    metrics["n"] = len(pairs)
    print(json.dumps(metrics))


def cmd_key(ns):
    results = load_results(ns.results)
    labels = load_labels(ns.labels, ns.id_col)
    pairs = _join(results, labels, ns.label_col)
    scores = [mirex_key_score(pred, truth) for pred, truth in pairs]
    # unparseable-on-both-sides must not count as a hit (None == None)
    exact = [
        float(
            map_keys_to_giantsteps(truth) is not None
            and map_keys_to_giantsteps(pred) == map_keys_to_giantsteps(truth)
        )
        for pred, truth in pairs
    ]
    print(
        json.dumps(
            {
                "mirex_weighted": round(sum(scores) / max(len(scores), 1), 4),
                "exact": round(sum(exact) / max(len(exact), 1), 4),
                "n": len(pairs),
            }
        )
    )


def cmd_tempo(ns):
    results = load_results(ns.results)
    labels = load_labels(ns.labels, ns.id_col)
    pairs = _join(results, labels, ns.label_col)
    texts = [p[0] for p in pairs]
    truths = [float(p[1]) for p in pairs]
    print(
        json.dumps(
            {
                "acc_8pct": round(tempo_acc(texts, truths, 0.08), 4),
                "acc_8pct_octave": round(
                    tempo_acc(texts, truths, 0.08, octave_tolerant=True), 4
                ),
                "n": len(pairs),
            }
        )
    )


def cmd_instruments(ns):
    results = load_results(ns.results)
    labels = load_labels(ns.labels, ns.id_col)
    # lowercase both sides (cmd_genre semantics): 'Violin' labels with a
    # 'violin' vocab scored 0.0 case-sensitively
    vocab = [v.strip().lower() for v in ns.vocab.split(",")]
    scores = []
    for r in results:
        lab = labels.get(str(r["example_id"]))
        if lab is None or ns.label_col not in lab:
            continue
        truth = lab[ns.label_col]
        if isinstance(truth, str):
            truth = [t.strip() for t in truth.split(",")]
        truth = [str(t).lower() for t in truth]
        pred = [p.lower() for p in extract_instruments(r["model_completion"], vocab)]
        scores.append(set_f1(pred, truth))
    center, half = bootstrap_ci(scores)
    print(
        json.dumps(
            {
                "f1": round(sum(scores) / max(len(scores), 1), 4),
                "bootstrap_center": round(center, 4),
                "bootstrap_halfwidth": round(half, 4),
                "n": len(scores),
            }
        )
    )


def main(argv=None):
    p = argparse.ArgumentParser("llark_tpu_torch.evaluation")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, extra in (
        ("genre", cmd_genre, ("--label-set",)),
        ("key", cmd_key, ()),
        ("tempo", cmd_tempo, ()),
        ("instruments", cmd_instruments, ("--vocab",)),
    ):
        c = sub.add_parser(name)
        c.add_argument("--results", required=True)
        c.add_argument("--labels", required=True)
        c.add_argument("--label-col", default={"genre": "genre", "key": "key",
                                               "tempo": "tempo",
                                               "instruments": "instruments"}[name])
        c.add_argument("--id-col", default="example_id")
        if name == "genre":
            c.add_argument("--embedder", choices=("offline", "openai", "clap"),
                           default="offline",
                           help="'openai' = the reference notebooks' text "
                                "embeddings (needs OPENAI_API_KEY); "
                                "'clap' = the CLAP text tower on-device "
                                "(needs --clap-checkpoint, no API); "
                                "'offline' = hashed bag of words")
            c.add_argument("--embedding-model", default="text-embedding-3-small")
            c.add_argument("--clap-checkpoint", default=None,
                           help="HF CLAP checkpoint dir for --embedder clap")
            c.add_argument("--device", default="cuda",
                           help="where --embedder clap runs the text tower (default: "
                                "the GPU; 'cpu' runs it on the host)")
        for e in extra:
            c.add_argument(e, required=True)
        c.set_defaults(fn=fn)
    ns = p.parse_args(argv)
    ns.fn(ns)


if __name__ == "__main__":
    main()
