"""Task-level accuracy ladder for the quantized KV-cache modes, on the port.

Counterpart of ``bench/llm_accuracy_eval.py`` (the inferenceKit purpose:
grade a real model per inference config). The default mode grades the
trained arithmetic LLM (checkpoint ``eval_out/arith_llm.npz``, read by
``utils/checkpoint.load_params_npz``): each cache mode (bf16, int8, k4v8,
int4) greedy-generates the answers to ``--n-prompts`` held-out three-shot
prompts through the evalkit pipeline (``evalkit.run_inference`` with its
default numeric grading, extract_answer + grade_numeric), so the task
accuracy is exact-match on margined logits. Then the window ladder
(``window_size=16, sink_size=4``; bf16, int8, k4v8), then the serving
engine rung: ``ServingEngine`` with pages of 8, plain against n-gram
speculation (``spec_ngram=2, spec_k=3``) on up to 16 prompts, with the
token agreement of the two streams and ``spec_tokens_per_round``.

``--random-weights`` runs the r4 ladder instead: generation exact-match
against the bf16 cache on a random-weight model (seeded), a pessimistic
bound (random logits sit near argmax ties).

The bf16 row is the gold and is generated before the loop over the cache
modes, whatever their order (the JAX script fills its gold only when its
loop reaches "bf16"). Each row also reports its kernel launches (A, C1, D,
...; zero on the CPU, where the plain versions run). The table is written
to ``--json`` (default ``eval_out/torch_llm_result.json``, never the JAX
package's ``eval_out/llm_result.json``) and printed as the last line.

Usage (on the card; ``--device cpu`` runs the plain versions):
  python -m lowbit_quant_fa2_paddle_tpu_torch.tools.llm_accuracy_eval \\
      [--checkpoint eval_out/arith_llm.npz] [--json eval_out/torch_llm_result.json]
  python -m lowbit_quant_fa2_paddle_tpu_torch.tools.llm_accuracy_eval --random-weights
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from lowbit_quant_fa2_paddle_tpu_torch.evalkit.config import InferenceConfig
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.inference import run_inference
from lowbit_quant_fa2_paddle_tpu_torch.models import llm

#: Cache modes by (K bits, V bits); "bf16" is the gold.
MODES = {"bf16": (16, 16), "int8": (8, 8), "k4v8": (4, 8), "int4": (4, 4)}
#: The window ladder's modes and window.
WINDOW_MODES = ("bf16", "int8", "k4v8")
WINDOW, SINK = 16, 4
#: The engine rung: prompts at most, pages, and the n-gram speculation.
ENGINE_PROMPTS, ENGINE_PAGE, SPEC_NGRAM, SPEC_K = 16, 8, 2, 3
DEFAULT_JSON = os.path.join("eval_out", "torch_llm_result.json")


def _launches() -> Dict[str, int]:
    """The port's kernel launch counters by kernel label."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention, attention_bwd, decode, fused_kv, gemv, quant

    wrappers = {"A": attention.lowbit_attention, "C1": quant.quant_int8, "C2": quant.quant_int4,
                "C3": quant.quant_int2, "D": decode.decode_attention, "E": fused_kv.fused_packed_kv_attention,
                "F1": gemv.wq_matmul_per_channel, "F2": gemv.wq_matmul_fused, "G1": attention_bwd.attention_bwd_dq,
                "G2": attention_bwd.attention_bwd_dkv}
    return {name: w.launches for name, w in wrappers.items()}


def _graded(name: str, generate_batch: Callable, examples: List[dict], n: int, max_new: int,
            grade_fn: Optional[Callable] = None) -> dict:
    """One row: ``run_inference`` over ``examples`` in one batch, with the
    launches it made."""
    before = _launches()
    with tempfile.TemporaryDirectory() as td:
        icfg = InferenceConfig(model=name, dataset="synthetic", batch_size=n, max_new_tokens=max_new,
                               output_dir=td, resume=False)
        summary = run_inference(icfg, generate_batch, examples=examples, grade_fn=grade_fn)
    after = _launches()
    return {"accuracy": summary["accuracy"], "results": summary["results"],
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def trained_ladder(args) -> dict:
    """The checkpoint's ladder: cache rows, window rows, the engine rung."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import train as T
    from lowbit_quant_fa2_paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

    dev = torch.device(args.device)
    cfg0 = T.arith_llm_config()
    params = llm.params_from_jax(load_params_npz(args.checkpoint), cfg0, device=dev)
    prompts, answers = T.make_eval_prompts(args.n_prompts, few_shot=3)
    examples = [{"question": T.decode_ids(p), "answer": f"#### {int(a)}"} for p, a in zip(prompts, answers)]

    def row(name: str, cfg_mode) -> dict:
        def generate_batch(qs, icfg):
            toks = torch.tensor([T.encode(q) for q in qs], dtype=torch.int32, device=dev)
            out = llm.generate(params, toks, icfg.max_new_tokens, cfg_mode)
            return [T.decode_ids(r) for r in out.cpu().numpy()]

        # default grading: extract_answer + grade_numeric (the reference's GSM8K path)
        r = _graded(f"arith_{name}", generate_batch, examples, args.n_prompts, T.ANS_LEN)
        return {"task_accuracy": r["accuracy"], "outputs": [x["output"] for x in r["results"]],
                "launches": r["launches"]}

    def mode_cfg(mode: str, **kw):
        kb, vb = MODES[mode]
        return T.arith_llm_config(kv_bits=8, k_bits=kb, v_bits=vb, **kw)

    gold = row("bf16", mode_cfg("bf16"))
    table, outputs = {}, {}
    for mode in MODES:
        r = gold if mode == "bf16" else row(mode, mode_cfg(mode))
        agree = float(np.mean([a == b for a, b in zip(r["outputs"], gold["outputs"])]))
        table[mode] = {"task_accuracy": r["task_accuracy"], "generation_agreement_vs_bf16": agree,
                       "launches": r["launches"]}
        outputs[mode] = r["outputs"]
        print(f"[llm_acc] {mode:5s}: task {r['task_accuracy']:.4f} | agree-bf16 {agree:.4f}", file=sys.stderr)

    # The question spans the last 6 positions, so a 16-token window (+ 4
    # sinks) keeps the context the answer needs.
    wtable = {}
    for mode in WINDOW_MODES:
        r = row(f"{mode}_w{WINDOW}s{SINK}", mode_cfg(mode, window_size=WINDOW, sink_size=SINK))
        wtable[mode] = {"task_accuracy": r["task_accuracy"], "launches": r["launches"]}
        outputs[f"{mode}_w{WINDOW}s{SINK}"] = r["outputs"]
        print(f"[llm_acc] {mode:5s} w{WINDOW}s{SINK}: task {r['task_accuracy']:.4f}", file=sys.stderr)

    # The engine rung: the n-gram engine's stream against the plain one's
    # (token agreement; on the card the verify tick batches T rows, so a
    # stream may part at an argmax near-tie).
    n_spec = min(args.n_prompts, ENGINE_PROMPTS)
    spec, streams = {}, {}
    for spec_on in (False, True):
        scfg = ServingConfig(page_size=ENGINE_PAGE, num_pages=96, max_batch=8, kv_bits=8, prefix_caching=False,
                             spec_ngram=SPEC_NGRAM if spec_on else 0, spec_k=SPEC_K)
        before = _launches()
        eng = ServingEngine(params, cfg0, scfg)
        rids = [eng.add_request([int(t) for t in prompts[i]], T.ANS_LEN, eos_token=T.EOS) for i in range(n_spec)]
        done = eng.run()
        after = _launches()
        key = "engine_spec_ngram" if spec_on else "engine_plain"
        streams[key] = [list(map(int, done[r])) for r in rids]
        preds = [T.decode_ids(s[:3]) for s in streams[key]]
        spec[key] = {"task_accuracy": float(np.mean([p == a for p, a in zip(preds, answers[:n_spec])])),
                     "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
        if spec_on:
            spec[key]["spec_tokens_per_round"] = eng.stats().get("spec_tokens_per_round")
    plain, ngram = streams["engine_plain"], streams["engine_spec_ngram"]
    n_tok = sum(len(t) for t in plain) or 1
    n_match = sum(sum(a == b for a, b in zip(x, y)) for x, y in zip(plain, ngram))
    for key in spec:
        spec[key]["tokens_identical"] = plain == ngram
        spec[key]["token_agreement"] = n_match / n_tok
    print(f"[llm_acc] engine: {spec}", file=sys.stderr)
    return {
        "model": "the trained arithmetic LLM (checkpoint eval_out/arith_llm.npz)",
        "task": "held-out fixed-format 2-digit addition, three-shot prompts (models/train.py)",
        "metric": "task exact-match via evalkit's default numeric grading (extract_answer + grade_numeric)",
        "config": dict(dim=cfg0.dim, depth=cfg0.depth, h=cfg0.num_heads, hk=cfg0.num_kv_heads,
                       n_prompts=args.n_prompts, device=_device_name(dev)),
        "table": table,
        "window_table": wtable,
        "serving_spec": spec,
        "outputs": outputs,
        "engine_streams": streams,
    }


def make_examples(n: int, prompt_len: int, vocab: int, seed: int = 0) -> List[dict]:
    rng = np.random.RandomState(seed)
    return [{"question": " ".join(map(str, rng.randint(0, vocab, size=prompt_len)))} for _ in range(n)]


def random_config(prompt_len: int, max_new: int, dtype: torch.dtype = torch.bfloat16, **kw) -> llm.LLMConfig:
    """The r4 ladder's model: vocab 256, dim 256, depth 4, 8 heads over 2
    KV heads, bf16 unless ``dtype`` says otherwise."""
    return llm.LLMConfig(vocab=256, dim=256, depth=4, num_heads=8, num_kv_heads=2,
                         max_seq=prompt_len + max_new + 8, dtype=dtype, **kw)


def random_weight_ladder(args, params: Optional[llm.LLM] = None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The r4 ladder: each cache mode's greedy generation graded
    exact-match against the bf16 cache's, with the mean agreeing prefix, on
    ``params`` (default: random weights from ``--seed``) in ``dtype``."""
    dev = torch.device(args.device)
    base = random_config(args.prompt_len, args.max_new, dtype)
    if params is None:
        params = llm.init_llm_params(base, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    examples = make_examples(args.n_prompts, args.prompt_len, base.vocab)

    def gen_fn_for(cfg_mode):
        def generate_batch(questions, icfg):
            toks = torch.tensor([[int(t) for t in q.split()] for q in questions], dtype=torch.int32, device=dev)
            out = llm.generate(params, toks, icfg.max_new_tokens, cfg_mode)
            return [" ".join(map(str, r)) for r in out.cpu().numpy().tolist()]
        return generate_batch

    def mode_cfg(mode):
        kb, vb = MODES[mode]
        return random_config(args.prompt_len, args.max_new, dtype, kv_bits=8, k_bits=kb, v_bits=vb)

    gold = gen_fn_for(mode_cfg("bf16"))([ex["question"] for ex in examples], InferenceConfig(max_new_tokens=args.max_new))
    for ex, g in zip(examples, gold):
        ex["answer"] = g
    table, outputs = {}, {}
    for mode in MODES:
        # The bf16 row grades the gold against itself (1.0, a sanity check).
        fn = (lambda qs, icfg: list(gold)) if mode == "bf16" else gen_fn_for(mode_cfg(mode))
        r = _graded(f"tiny_{mode}", fn, examples, args.n_prompts, args.max_new, grade_fn=lambda p, g: p == g)
        prefix = []
        for res in r["results"]:
            a, b = res["pred"].split(), res["gold"].split()
            m = 0
            while m < len(a) and m < len(b) and a[m] == b[m]:
                m += 1
            prefix.append(m / max(len(b), 1))
        table[mode] = {"exact_match_vs_bf16": r["accuracy"], "mean_prefix_agreement": float(np.mean(prefix)),
                       "launches": r["launches"]}
        outputs[mode] = [res["pred"] for res in r["results"]]
        print(f"[llm_acc] {mode:5s}: exact {r['accuracy']:.4f} | prefix {table[mode]['mean_prefix_agreement']:.4f}",
              file=sys.stderr)
    return {
        "config": dict(vocab=base.vocab, dim=base.dim, depth=base.depth, num_heads=base.num_heads,
                       num_kv_heads=base.num_kv_heads, max_seq=base.max_seq, dtype=str(base.dtype),
                       n_prompts=args.n_prompts, prompt_len=args.prompt_len, max_new=args.max_new,
                       device=_device_name(dev),
                       metric="greedy generation exact-match vs the bf16-cache model (fixed seed)",
                       caveat="random-weight logits sit near argmax ties, so these rates are a pessimistic "
                              "bound on a trained model's; the default mode grades the trained checkpoint"),
        "table": table,
        "outputs": outputs,
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-prompts", type=int, default=None,
                    help="default: 64 (trained ladder) / 32 (--random-weights)")
    ap.add_argument("--prompt-len", type=int, default=32, help="[--random-weights] prompt tokens")
    ap.add_argument("--max-new", type=int, default=32, help="[--random-weights] new tokens")
    ap.add_argument("--checkpoint", default=os.path.join("eval_out", "arith_llm.npz"))
    ap.add_argument("--random-weights", action="store_true",
                    help="run the r4 random-weight ladder instead of grading the trained checkpoint")
    ap.add_argument("--seed", type=int, default=0, help="[--random-weights] the weights' seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--json", default=DEFAULT_JSON)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    if args.n_prompts is None:
        args.n_prompts = 32 if args.random_weights else 64
    if os.path.abspath(args.json) == os.path.abspath(os.path.join("eval_out", "llm_result.json")):
        raise ValueError("eval_out/llm_result.json is the JAX package's table; write the port's elsewhere")
    with torch.no_grad():
        out = random_weight_ladder(args) if args.random_weights else trained_ladder(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("outputs", "engine_streams")}))
    return out


if __name__ == "__main__":
    main()
