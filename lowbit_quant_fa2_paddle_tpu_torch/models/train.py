"""The arithmetic task of the in-repo toy LLM: its alphabet, prompts and
grading, in numpy only.

Counterpart of the eval helpers of ``lowbit_quant_fa2_paddle_tpu/models/
train.py``: a character-level LM over fixed-format zero-padded addition
facts ``"07+42=049;"``, 10 characters each, so a few-shot prompt is
``k*10 + 6`` tokens ending in ``"ab+cd="`` and the answer is always 3 digits
and ``";"``. The committed checkpoint ``eval_out/arith_llm.npz`` was trained
on it. Training the toy LLM is not ported yet (ROADMAP item 4); the DiT's
training is (``models/dit.sgd_train_step``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lowbit_quant_fa2_paddle_tpu_torch.models import llm as L

CHARS = "0123456789+=;"
VOCAB = len(CHARS)  # 13
EOS = CHARS.index(";")
FACT_LEN = 10  # "ab+cd=xyz;"
ANS_LEN = 4  # "xyz;"
Q_LEN = 6  # "ab+cd="


def encode(s: str) -> List[int]:
    return [CHARS.index(c) for c in s]


def decode_ids(ids) -> str:
    return "".join(CHARS[int(i)] for i in ids if 0 <= int(i) < VOCAB)


def fact(a: int, b: int) -> str:
    return f"{a:02d}+{b:02d}={a + b:03d};"


def arith_llm_config(**kw) -> L.LLMConfig:
    """The checkpoint's geometry: dim 256, depth 4, 8 query heads, 2 KV
    heads (head dim 32), vocab 13, f32."""
    base = dict(vocab=VOCAB, dim=256, depth=4, num_heads=8, num_kv_heads=2, max_seq=128, dtype=torch.float32)
    base.update(kw)
    return L.LLMConfig(**base)


def make_eval_prompts(n: int, *, few_shot: int = 3, seed: int = 123) -> Tuple[np.ndarray, List[str]]:
    """Held-out eval set: ``n`` prompts ``[n, few_shot*10 + 6]`` ending in
    ``"ab+cd="`` and the true 3-digit answers; the same draws as the JAX
    package's for the same seed."""
    rng = np.random.RandomState(seed)
    prompts = np.empty((n, few_shot * FACT_LEN + Q_LEN), np.int32)
    answers = []
    for i in range(n):
        shots = "".join(fact(int(rng.randint(0, 100)), int(rng.randint(0, 100))) for _ in range(few_shot))
        a, b = int(rng.randint(0, 100)), int(rng.randint(0, 100))
        prompts[i] = encode(shots + f"{a:02d}+{b:02d}=")
        answers.append(f"{a + b:03d}")
    return prompts, answers


def grade_answer(gen_ids, answer: str) -> bool:
    """Exact task match: the 3 generated digits equal the true sum."""
    return decode_ids(gen_ids[:3]) == answer
