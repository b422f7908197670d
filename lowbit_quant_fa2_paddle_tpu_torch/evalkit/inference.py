"""Batched inference with crash resume (reference inferenceKit
inference.py:37-50 + utils/file.py:121-127: exception -> gather partials ->
write RESUME_*.json, reload next run)."""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

from lowbit_quant_fa2_paddle_tpu_torch.evalkit.config import InferenceConfig
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.datasets import load_dataset
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.grader import extract_answer, grade_numeric


def _resume_path(cfg: InferenceConfig) -> str:
    return os.path.join(cfg.output_dir, f"RESUME_{cfg.model}_{cfg.dataset}.json")


def run_inference(
    cfg: InferenceConfig,
    generate_fn: Callable[[List[str], InferenceConfig], List[str]],
    examples: Optional[List[Dict[str, str]]] = None,
    grade_fn: Optional[Callable[[str, str], bool]] = None,
) -> Dict:
    """Run ``generate_fn`` over the dataset in batches, grading numerically
    by default (``grade_fn`` overrides — e.g. exact-match for the
    cache-precision ladder, tools/llm_accuracy_eval.py).

    Crash-safe: partial results are flushed to ``RESUME_*.json`` after every
    batch; a rerun resumes where it stopped. On success the resume file is
    replaced by ``result.json`` (the reference's rename-on-success pattern).
    """
    os.makedirs(cfg.output_dir, exist_ok=True)
    if examples is None:
        examples = load_dataset(cfg.dataset, **cfg.extra.get("dataset_args", {}))

    results: List[Dict] = []
    rp = _resume_path(cfg)
    if cfg.resume and os.path.exists(rp):
        with open(rp) as f:
            results = json.load(f)["results"]

    start = len(results)
    for i in range(start, len(examples), cfg.batch_size):
        batch = examples[i : i + cfg.batch_size]
        outputs = generate_fn([ex["question"] for ex in batch], cfg)
        for ex, out in zip(batch, outputs):
            if grade_fn is not None:
                pred, gold = out, ex.get("answer", "")
                correct = bool(grade_fn(pred, gold))
            else:
                pred = extract_answer(out)
                gold = extract_answer(ex.get("answer", ""))
                correct = grade_numeric(pred, gold)
            results.append(
                {
                    "question": ex["question"],
                    "output": out,
                    "pred": pred,
                    "gold": gold,
                    "correct": correct,
                }
            )
        with open(rp, "w") as f:
            json.dump({"results": results}, f)

    n = len(results)
    acc = sum(r["correct"] for r in results) / max(1, n)
    summary = {"model": cfg.model, "dataset": cfg.dataset, "n": n, "accuracy": acc,
               "results": results}
    with open(os.path.join(cfg.output_dir, "result.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if os.path.exists(rp):
        os.remove(rp)
    return summary
