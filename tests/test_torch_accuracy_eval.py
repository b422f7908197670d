"""Port parity: the cache-accuracy ladder (``tools/llm_accuracy_eval.py``)
against the JAX package.

* The trained ladder on the checkpoint ``eval_out/arith_llm.npz`` (8
  prompts here, 64 on the card): every row (the bf16, int8, k4v8 and int4
  caches; the window ladder at window 16 + 4 sinks on bf16, int8 and k4v8)
  generates JAX's ``llm.generate`` tokens and grades them as JAX's evalkit
  does. The checkpoint's logits have real margins, so the tokens are equal.
* The engine rung: the plain and the n-gram engine give identical streams
  on the CPU (the plain versions run every tick the same way).
* The ``--random-weights`` ladder on JAX's own random init (carried across
  with ``params_from_jax``), 4 prompts: the same gold tokens and the same
  table as JAX's generations give. In f32: in bf16 the random logits sit
  at argmax near-ties, where the two sides' summation orders part the
  streams (measured: one of four int8 streams).
JAX's ``generate`` runs jitted, its Pallas kernels in interpret mode on the
CPU; the port runs its plain versions (``--device cpu``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.evalkit import extract_answer, grade_numeric
from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.models import train as JT
from lowbit_quant_fa2_paddle_tpu.utils.checkpoint import load_params
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.tools import llm_accuracy_eval as E

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "eval_out", "arith_llm.npz")
N_PROMPTS = 8
#: JAX's generate, jitted (a third faster here than its eager prefill).
JAX_GENERATE = jax.jit(JL.generate, static_argnums=(2, 3))
ROWS = [(mode, False) for mode in E.MODES] + [(mode, True) for mode in E.WINDOW_MODES]


@pytest.fixture(scope="module", autouse=True)
def _tuning_cache(tmp_path_factory):
    """The port's tuning cache is a file of this module's own: no user's
    cache reaches a test."""
    from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LOWBIT_FA_TORCH_TUNING_CACHE", str(tmp_path_factory.mktemp("tuning") / "tuning.json"))
        tuning.clear_memory_cache()
        yield
    tuning.clear_memory_cache()


def _row_name(mode, windowed):
    return f"{mode}_w{E.WINDOW}s{E.SINK}" if windowed else mode


@pytest.fixture(scope="module")
def jax_trained():
    """JAX's greedy answers and grades for every row, computed once."""
    like = JL.init_llm_params(jax.random.PRNGKey(0), JT.arith_llm_config())
    params = load_params(CKPT, like)
    prompts, answers = JT.make_eval_prompts(N_PROMPTS, few_shot=3)
    out = {}
    for mode, windowed in ROWS:
        kb, vb = E.MODES[mode]
        extra = dict(window_size=E.WINDOW, sink_size=E.SINK) if windowed else {}
        cfg = JT.arith_llm_config(kv_bits=8, k_bits=kb, v_bits=vb, **extra)
        toks = np.asarray(JAX_GENERATE(params, jnp.asarray(prompts), JT.ANS_LEN, cfg))
        outputs = [JT.decode_ids(r) for r in toks]
        grades = [grade_numeric(extract_answer(o), extract_answer(f"#### {int(a)}")) for o, a in zip(outputs, answers)]
        out[_row_name(mode, windowed)] = (outputs, float(np.mean(grades)))
    return out


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ladder") / "ladder.json")
    return E.main(["--device", "cpu", "--n-prompts", str(N_PROMPTS), "--checkpoint", CKPT, "--json", path]), path


@pytest.mark.parametrize("mode,windowed", ROWS, ids=[_row_name(*r) for r in ROWS])
def test_trained_ladder_rows_equal_jax(jax_trained, port_trained, mode, windowed):
    out, _ = port_trained
    want_outputs, want_acc = jax_trained[_row_name(mode, windowed)]
    assert out["outputs"][_row_name(mode, windowed)] == want_outputs
    row = (out["window_table"] if windowed else out["table"])[mode]
    assert row["task_accuracy"] == want_acc == 1.0
    assert row["launches"] == {}  # the CPU runs the plain versions
    if not windowed:
        gold = jax_trained["bf16"][0]
        assert row["generation_agreement_vs_bf16"] == float(np.mean([a == b for a, b in zip(want_outputs, gold)]))


def test_engine_rung_streams_are_identical_on_the_cpu(port_trained):
    out, path = port_trained
    spec = out["serving_spec"]
    streams = out["engine_streams"]
    assert len(streams["engine_plain"]) == min(N_PROMPTS, E.ENGINE_PROMPTS)
    assert streams["engine_plain"] == streams["engine_spec_ngram"]
    assert all(s[-1] == 12 and len(s) <= 4 for s in streams["engine_plain"])  # three digits and ";" (EOS)
    for key in ("engine_plain", "engine_spec_ngram"):
        assert spec[key]["tokens_identical"] and spec[key]["token_agreement"] == 1.0
        assert spec[key]["task_accuracy"] == 1.0
    assert spec["engine_spec_ngram"]["spec_tokens_per_round"] >= 1.0
    import json

    with open(path) as f:  # the table written to --json
        assert json.load(f)["table"] == out["table"]


def test_the_default_json_is_the_ports_own():
    assert E.DEFAULT_JSON != os.path.join("eval_out", "llm_result.json")
    with pytest.raises(ValueError, match="JAX package's table"):
        E.main(["--device", "cpu", "--json", os.path.join("eval_out", "llm_result.json")])


#: A parting of the port's stream from JAX's is a near-tie when, at the first
#: token that differs, the port's logits put JAX's token within this share of
#: their standard deviation below its own (measured: 0.15% and 0.25%).
TIE = 1e-2


def test_random_weight_ladder_matches_jax():
    """The gold (bf16 cache) tokens equal JAX's; each other cache mode's
    streams equal JAX's or part at a near-tie; the table is the ladder's
    scoring of the port's streams, which on equal streams is JAX's."""
    args = E.parser().parse_args(["--device", "cpu", "--random-weights", "--n-prompts", "4", "--prompt-len", "16",
                                  "--max-new", "8"])
    base = dict(vocab=256, dim=256, depth=4, num_heads=8, num_kv_heads=2, max_seq=16 + 8 + 8)
    params = JL.init_llm_params(jax.random.PRNGKey(0), JL.LLMConfig(**base, dtype=jnp.float32))
    model = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, params), E.random_config(16, 8, torch.float32),
                               device="cpu")
    out = E.random_weight_ladder(args, params=model, dtype=torch.float32)
    toks = np.asarray([[int(t) for t in ex["question"].split()] for ex in E.make_examples(4, 16, 256)], np.int32)
    gold = out["outputs"]["bf16"]
    parted = 0
    for mode, (kb, vb) in E.MODES.items():
        cfg = JL.LLMConfig(**base, dtype=jnp.float32, kv_bits=8, k_bits=kb, v_bits=vb)
        want = [" ".join(map(str, r)) for r in np.asarray(JAX_GENERATE(params, jnp.asarray(toks), 8, cfg)).tolist()]
        got = out["outputs"][mode]
        if mode == "bf16":
            assert got == want
        for row, (g, w) in enumerate(zip(got, want)):
            if g != w:
                parted += 1
                g, w = [int(t) for t in g.split()], [int(t) for t in w.split()]
                p = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
                logits = _port_logits(model, toks[row:row + 1], g[:p], E.random_config(16, 8, torch.float32, kv_bits=8,
                                                                                       k_bits=kb, v_bits=vb))
                assert int(logits.argmax()) == g[p]
                assert float(logits[g[p]] - logits[w[p]]) <= TIE * float(logits.std()), (mode, row, p)
        exact = float(np.mean([a == b for a, b in zip(got, gold)]))
        prefix = []
        for a, b in zip(got, gold):
            a, b = a.split(), b.split()
            prefix.append(next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b))) / len(b))
        assert out["table"][mode]["exact_match_vs_bf16"] == exact
        assert out["table"][mode]["mean_prefix_agreement"] == float(np.mean(prefix))
    assert out["table"]["bf16"]["exact_match_vs_bf16"] == 1.0 and parted <= 4


def _port_logits(model, prompt, fed, cfg):
    """The port's f32 logits of the token after ``prompt`` and the generated
    tokens ``fed``, through the path ``generate`` takes (the prefill, then a
    decode step a token)."""
    logits, caches = TL.llm_prefill(model, torch.from_numpy(prompt), cfg)
    last = logits[0, -1]
    for t in fed:
        step, caches = TL.llm_decode_step(model, torch.tensor([t], dtype=torch.int32), caches, cfg)
        last = step[0]
    return last.float()
