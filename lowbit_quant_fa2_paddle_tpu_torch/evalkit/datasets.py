"""Dataset registry + loaders (reference inferenceKit basedataset.py:
GSM8K/MATH/simple loaders). Zero-egress environment: loaders read local
JSONL files in the GSM8K convention (``{"question": ..., "answer": ...}``,
final numeric answer after ``####``), plus a built-in synthetic arithmetic
set for self-contained tests."""

from __future__ import annotations

import json
import random
from typing import Callable, Dict, List, Tuple

Example = Dict[str, str]
DATASETS: Dict[str, Callable[..., List[Example]]] = {}


def register(name: str):
    def deco(fn):
        DATASETS[name] = fn
        return fn

    return deco


@register("jsonl")
def load_jsonl(path: str, limit: int = 0) -> List[Example]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(json.loads(line))
            if limit and len(out) >= limit:
                break
    return out


@register("gsm8k")
def load_gsm8k(path: str, limit: int = 0) -> List[Example]:
    """GSM8K-format JSONL: answer's final number follows '####'."""
    return load_jsonl(path, limit)


# Bundled MATH-style sample (zero-egress image: no dataset downloads).
# Numeric \boxed{} answers so the default numeric grading path applies;
# math_equal handles the symbolic cases when a real dump is pointed at.
_MATH_SAMPLE = [
    {"question": "What is the greatest common divisor of 84 and 126?",
     "answer": "Factor both: 84 = 2^2*3*7, 126 = 2*3^2*7, so the answer "
               "is \\boxed{42}."},
    {"question": "If 3x + 7 = 31, what is x?",
     "answer": "3x = 24 so x = \\boxed{8}."},
    {"question": "How many positive divisors does 36 have?",
     "answer": "36 = 2^2*3^2 gives (2+1)(2+1) = \\boxed{9} divisors."},
    {"question": "Evaluate 2^10 - 2^8.",
     "answer": "1024 - 256 = \\boxed{768}."},
    {"question": "What is the sum of the first 20 positive integers?",
     "answer": "n(n+1)/2 with n=20 gives \\boxed{210}."},
]


@register("math")
def load_math(path: str = None, limit: int = 0):
    """MATH-format loader (reference inferenceKit/dataset/mathdataset.py:
    ``{"problem": ..., "solution": ...}`` with the final answer in
    ``\\boxed{}`` — the grader's extract_answer/math_equal rung). Rows are
    normalized to the pipeline's question/answer schema. With no ``path``,
    returns the small bundled sample (zero-egress image)."""
    if path is None:
        rows = list(_MATH_SAMPLE)
    else:
        rows = [
            {"question": ex.get("problem", ex.get("question", "")),
             "answer": ex.get("solution", ex.get("answer", ""))}
            for ex in load_jsonl(path, limit)
        ]
    return rows[:limit] if limit else rows


@register("simple")
def load_simple(n: int = 32, seed: int = 0, **_) -> List[Example]:
    """Synthetic arithmetic QA (the reference's 'simple' dataset role)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        a, b = rng.randint(1, 99), rng.randint(1, 99)
        out.append(
            {"question": f"What is {a} + {b}?", "answer": f"#### {a + b}"}
        )
    return out


def load_dataset(name: str, **kw) -> List[Example]:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](**kw)
