"""Port parity: the port's copies of the eval kit (``evalkit/``), the
logger, the benchmark parser and its profiling helpers, against the JAX
package's modules on the same inputs.

The copies are plain Python, numpy and the standard library (sympy
optional), so every result must be equal: configs, datasets, extracted
answers, grades, resume files and summaries, and each perceptual score to
the float on seeded arrays. ``utils/profiling.trace`` is the port's own (on
``torch.profiler``): on the CPU it writes a Chrome trace naming the ops it
ran.
"""

import json
import os

import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu import evalkit as JE
from lowbit_quant_fa2_paddle_tpu.evalkit import grader as JG
from lowbit_quant_fa2_paddle_tpu.evalkit import perceptual as JP
from lowbit_quant_fa2_paddle_tpu.utils import logger as JLOG
from lowbit_quant_fa2_paddle_tpu.utils import parser as JPAR
from lowbit_quant_fa2_paddle_tpu_torch import evalkit as TE
from lowbit_quant_fa2_paddle_tpu_torch.evalkit import grader as TG
from lowbit_quant_fa2_paddle_tpu_torch.evalkit import perceptual as TP
from lowbit_quant_fa2_paddle_tpu_torch.utils import logger as TLOG
from lowbit_quant_fa2_paddle_tpu_torch.utils import parser as TPAR
from lowbit_quant_fa2_paddle_tpu_torch.utils import profiling

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)


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


def test_config_precedence_matches_jax(tmp_path):
    cf = tmp_path / "cfg.json"
    cf.write_text(json.dumps({"batch_size": 2, "model": "from_file", "custom": 1}))
    kw = dict(config_file=str(cf), model_args={"model": "from_model", "attn_impl": "int4"},
              command_args={"model": "from_cmd", "resume": None}, runtime_args={"batch_size": 16})
    j, t = JE.InferenceConfig.resolve(**kw), TE.InferenceConfig.resolve(**kw)
    assert vars(t) == vars(j)
    assert (t.model, t.batch_size, t.attn_impl, t.extra) == ("from_cmd", 16, "int4", {"custom": 1})


@pytest.mark.parametrize("name,kw", [("simple", dict(n=5)), ("simple", dict(n=7, seed=3)), ("math", {}),
                                     ("math", dict(limit=2))])
def test_datasets_match_jax(name, kw):
    assert TE.load_dataset(name, **kw) == JE.load_dataset(name, **kw)
    assert sorted(TE.DATASETS) == sorted(JE.DATASETS)
    with pytest.raises(KeyError):
        TE.load_dataset("nope")


def test_jsonl_and_math_files_match_jax(tmp_path):
    p = tmp_path / "math.jsonl"
    p.write_text('{"problem": "1+1?", "solution": "\\\\boxed{2}"}\n\n{"question": "q", "answer": "#### 3"}\n')
    for name, kw in (("math", dict(path=str(p))), ("jsonl", dict(path=str(p))), ("gsm8k", dict(path=str(p), limit=1))):
        assert TE.load_dataset(name, **kw) == JE.load_dataset(name, **kw)


TEXTS = ["The answer is #### 42", "thus \\boxed{3.5} holds", "we get 7 then 12 finally 19.", "no numbers here",
         "#### 1,234.", "x = -3.25 and y = 4", "\\boxed{\\frac{1}{2}}", "", "answer: #### 042;"]


@pytest.mark.parametrize("text", TEXTS)
def test_extract_answer_matches_jax(text):
    assert TE.extract_answer(text) == JE.extract_answer(text)


PAIRS = [("42", "42.0"), ("1,000", "1000"), ("41", "42"), (None, "42"), ("Yes", "yes"),
         ("The answer is B. Wait, actually D.", "D"), ("so the answer is (C)", "C"), ("so the answer is (C)", "D"),
         ("50%", "0.5"), ("0.5", "50"), ("$1,234", "1234"), ("1/6", "\\frac1{6}"), ("\\frac{3}{4}", "0.75"),
         ("3, 1, 2", "1, 2, 3"), ("(2, pi)", "(pi, 2)"), ("(0.5, 2)", "(1/2, 2.0)"),
         ("\\begin{pmatrix}1 & 2\\\\3 & 4\\end{pmatrix}", "\\begin{pmatrix}1.0 & 2\\\\3 & 4.0\\end{pmatrix}"),
         ("\\begin{pmatrix}1 & 2\\\\3 & 4\\end{pmatrix}", "\\begin{pmatrix}1 & 2\\\\3 & 5\\end{pmatrix}"),
         ("2 \\pm \\sqrt{3}", "2+1*sqrt(3),2-1*sqrt(3)"), ("[1, 2]", "(1, 2)"), ("049", "49")]


@pytest.mark.parametrize("pred,ref", PAIRS)
def test_grading_ladder_matches_jax(pred, ref):
    """The ladder's rungs above the symbolic one (sympy is optional; where
    this image has it, both sides reach it alike)."""
    assert TG.math_equal(pred, ref) == JG.math_equal(pred, ref)
    assert TE.grade_numeric(pred, ref) == JE.grade_numeric(pred, ref)
    if pred is not None:
        assert TG.clean_choice_answer(pred) == JG.clean_choice_answer(pred)
        assert TG.parse_numeric_value(pred) == JG.parse_numeric_value(pred)


def test_grading_without_sympy_matches_jax(monkeypatch):
    """The card's machine has no sympy: the ladder must stand without it."""
    for mod in (TG, JG):
        monkeypatch.setattr(mod, "HAVE_SYMPY", False)
    for pred, ref in PAIRS + [("x + x", "2*x"), ("y = 2*x", "2*x = y")]:
        assert TG.math_equal(pred, ref) == JG.math_equal(pred, ref)
    assert not TG.symbolic_equal("x + x", "2*x") and not TG.math_equal("x + x", "2*x")


@pytest.mark.parametrize("pred,ref,timeout", [("x + x", "2*x", False), ("y = 2*x", "2*x = y", False),
                                              ("x + x", "2*x", True), ("x**2", "x*x*x", False)])
def test_symbolic_rung_matches_jax(pred, ref, timeout):
    pytest.importorskip("sympy")
    assert TG.math_equal(pred, ref, check_timeout=timeout) == JG.math_equal(pred, ref, check_timeout=timeout)


def _oracle(marker, crash_at):
    calls = {"n": 0}

    def gen(questions, cfg):
        calls["n"] += 1
        if calls["n"] == crash_at and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("simulated crash")
        outs = []
        for q in questions:
            a, b = [int(t) for t in q.replace("?", "").split() if t.isdigit()]
            outs.append(f"answer: #### {a + b + (a % 3 == 0)}")
        return outs

    return gen


def test_run_inference_with_resume_matches_jax(tmp_path):
    """The same crash, resume and summary on both kits (a generator that
    is wrong a third of the time), and the same result.json."""
    summaries = {}
    for name, E in (("jax", JE), ("torch", TE)):
        out = tmp_path / name
        cfg = E.InferenceConfig(dataset="simple", batch_size=4, output_dir=str(out),
                                extra={"dataset_args": {"n": 8, "seed": 1}})
        examples = E.load_dataset("simple", n=8, seed=1)
        gen = _oracle(tmp_path / f"{name}_", 2)
        with pytest.raises(RuntimeError):
            E.run_inference(cfg, gen, examples)
        assert [f for f in os.listdir(out) if f.startswith("RESUME_")]  # partial results persisted
        summaries[name] = E.run_inference(cfg, gen, examples)  # resumes cleanly
        assert not [f for f in os.listdir(out) if f.startswith("RESUME_")]
        with open(out / "result.json") as f:
            assert json.load(f) == summaries[name]
    assert summaries["torch"] == summaries["jax"]
    assert summaries["torch"]["n"] == 8 and 0 < summaries["torch"]["accuracy"] < 1


def test_run_inference_grade_fn_matches_jax(tmp_path):
    examples = [{"question": f"q{i}", "answer": f"a{i % 3}"} for i in range(7)]

    def gen(questions, cfg):
        return [f"a{int(q[1:]) % 2}" for q in questions]

    got = {}
    for name, E in (("jax", JE), ("torch", TE)):
        cfg = E.InferenceConfig(batch_size=3, output_dir=str(tmp_path / name), resume=False)
        got[name] = E.run_inference(cfg, gen, examples=examples, grade_fn=lambda p, g: p == g)
    assert got["torch"] == got["jax"]


# -- perceptual scorers -------------------------------------------------------


@pytest.mark.parametrize("shape,seed", [((3, 32, 32), 0), ((2, 2, 21, 17), 1), ((4, 101, 176), 2)])
def test_perceptual_scores_match_jax(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape)
    for other in (base, base + 0.05 * rng.standard_normal(shape), base + rng.standard_normal(shape)):
        assert TP.ssim(other, base) == JP.ssim(other, base)
        assert TP.random_feature_distance(other, base) == JP.random_feature_distance(other, base)
        assert TP.freq_band_mse(other, base) == JP.freq_band_mse(other, base)
        assert TP.perceptual_report(other, base) == JP.perceptual_report(other, base)
    assert TP.ssim(base, base) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        TP.ssim(base, base[..., :-1])


@pytest.mark.parametrize("shape", [(2, 48, 16), (64, 8), (1, 17776, 12)])
def test_latent_to_frames_matches_jax(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    t, j = TP.latent_to_frames(x), JP.latent_to_frames(x)
    assert t.shape == j.shape and np.array_equal(t, j)
    if shape[1] == 17776:  # the CogVideoX latent: 4 frames of 101 x 176
        assert t.shape == (4, 101, 176)


# -- logger, parser -----------------------------------------------------------


def test_logger_writes_the_same_file(tmp_path):
    lines = {}
    for name, L in (("jax", JLOG), ("torch", TLOG)):
        path = str(tmp_path / f"{name}.log")
        lg = L.Logger(f"t_{name}", path)
        lg.info("hello %d", 7)
        lg.warning("careful")
        lg.error("bad %s", "thing")
        for h in lg.logger.handlers:
            h.flush()
            h.close()
        lines[name] = [line.split(" ", 2)[2].replace(f"t_{name}", "t") for line in open(path).read().splitlines()]
    assert lines["torch"] == lines["jax"] and "hello 7" in lines["torch"][0]


def test_eval_log_renames_on_success_as_jax(tmp_path):
    for name, L in (("jax", JLOG), ("torch", TLOG)):
        path = str(tmp_path / f"{name}_run.log")

        @L.eval_log(path)
        def job(logger=None):
            logger.info("working")
            return 42

        assert job() == 42
        assert not os.path.exists(path) and os.path.exists(str(tmp_path / f"_eval_{name}_run.log"))


@pytest.mark.parametrize("argv", [[], ["--bits", "int4", "--causal"], ["--method", "fa2", "--seq_lens", "128", "256",
                                                                      "--head_dim", "128", "--output", "x.json"]])
def test_parser_and_save_name_match_jax(argv):
    j, t = JPAR.bench_parser().parse_args(argv), TPAR.bench_parser().parse_args(argv)
    assert vars(t) == vars(j)
    assert TPAR.save_name(t) == JPAR.save_name(j)


# -- profiling ----------------------------------------------------------------


def test_profiling_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        y = torch.matmul(x, x).relu()
    assert prof.trace_path.startswith(str(tmp_path / "trace")) and os.path.exists(prof.trace_path)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names and "aten::relu" in names
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    assert torch.isfinite(y).all()


def test_scope_timer_measures_the_block():
    with profiling.ScopeTimer("t") as t:
        sum(range(10000))
    assert t.name == "t" and t.elapsed > 0.0
