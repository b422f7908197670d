"""Answer extraction + math-equivalence grading.

Re-implements the full capability of the reference grader (inferenceKit
dataset/grader.py:14-259): answer extraction for GSM8K/MATH-style outputs,
then a `math_equal` ladder — exact string, multiple-choice letters, unordered
comma lists (with a polar-coordinate guard), percent-tolerant numerics, LaTeX
fraction / plus-minus rewrites, elementwise tuple and pmatrix/bmatrix
comparison, equation (lhs-rhs) equivalence, and finally sympy symbolic
equivalence with an optional subprocess timeout (sympy can hang on
pathological expressions).

Differences from the reference: zero-egress image, so `latex2sympy2` (an
extra pip package there) is not in the parsing ladder; sympy itself is
optional and everything above the symbolic rung works without it.
"""

from __future__ import annotations

import math
import multiprocessing
import re
from typing import Optional, Union

try:
    import sympy  # type: ignore
    from sympy.parsing.sympy_parser import parse_expr  # type: ignore

    try:  # parse_latex needs antlr; degrade to parse_expr-only if missing
        from sympy.parsing.latex import parse_latex  # type: ignore
    except Exception:  # pragma: no cover
        parse_latex = None
    HAVE_SYMPY = True
except Exception:  # pragma: no cover
    sympy = None
    parse_expr = None
    parse_latex = None
    HAVE_SYMPY = False

_NUM = re.compile(r"-?\d[\d,]*(?:\.\d+)?")
_CHOICES = ("A", "B", "C", "D", "E")

# Punctuation that wraps a model's final-answer string without being part of
# it.  Leading and trailing sets differ (":" only ever prefixes, "." "/" only
# ever trail), so normalization is a table, not a strip-chain.
_ANSWER_DECOR = {"lead": ": \n", "trail": "./ \n"}

# A polar coordinate "(r, theta)" — radius then an angle term (a number, or
# something built from pi/tau).  Order matters there, so the unordered-list
# comparison must not fire on these.
_ANGLE_TERM = r"(?:[0-9.]+|[0-9.*/ ]*(?:pi|π|tau)[0-9.*/ ]*)"
_POLAR = re.compile(
    r"^\(\s*[0-9]+(?:\.[0-9]+)?\s*,\s*" + _ANGLE_TERM + r"\s*\)", re.IGNORECASE
)


def extract_answer(text: str) -> Optional[str]:
    """Final answer: '#### x' (GSM8K), '\\boxed{x}' (MATH), else the last
    number in the text (reference grader conventions)."""
    m = re.search(r"####\s*([^\n]+)", text)
    if m:
        return m.group(1).strip().rstrip(".")
    m = re.search(r"\\boxed\{([^{}]+)\}", text)
    if m:
        return m.group(1).strip()
    nums = _NUM.findall(text)
    return nums[-1] if nums else None


def _strip_answer_decor(text: str) -> str:
    """Peel wrapper punctuation off an answer string using the decor table."""
    text = text.lstrip(_ANSWER_DECOR["lead"])
    return text.rstrip(_ANSWER_DECOR["trail"])


def clean_choice_answer(prediction: str) -> str:
    """Normalize a multiple-choice prediction to its final A-E letter
    (capability match for reference grader.py:24-31): the LAST standalone
    letter wins ('The answer is B. Actually, D' -> 'D')."""
    pred = _strip_answer_decor(prediction)
    letters = re.findall(r"\b([A-E])\b", pred.upper())
    if letters:
        return letters[-1]
    return _strip_answer_decor(pred)


def parse_numeric_value(value) -> Optional[float]:
    """Float parse tolerating thousands separators and a trailing percent
    sign ('1,000' -> 1000.0, '50%' -> 0.5); None if not numeric."""
    s = str(value).replace(",", "").replace("$", "").strip()
    try:
        return float(s)
    except ValueError:
        if s.endswith("%") or s.endswith("\\%"):
            try:
                return float(s.rstrip("\\%")) / 100.0
            except ValueError:
                return None
    return None


def _rewrite_latex(expr: str) -> str:
    """LaTeX -> plain-math rewrites the sympy parsers choke on: numeric
    \\frac variants (braced/unbraced operands) and \\pm roots expanded to
    their comma-separated pair."""
    # \frac{a}{b}, \dfrac{a}{b}, \frac{a}b, \fraca{b}, \fracab (digits only)
    expr = re.sub(r"\\d?frac\{(\d+)\}\{(\d+)\}", r"(\1/\2)", expr)
    expr = re.sub(r"\\d?frac\{(\d+)\}(\d+)", r"(\1/\2)", expr)
    expr = re.sub(r"\\d?frac(\d+)\{(\d+)\}", r"(\1/\2)", expr)
    expr = re.sub(r"\\d?frac(\d)(\d)", r"(\1/\2)", expr)
    # a \pm b\sqrt{c}  ->  both roots
    expr = re.sub(
        r"(\d+)\s*\\pm\s*(\d*)\s*\\sqrt\{(\d+)\}",
        lambda m: "{0}+{1}*sqrt({2}),{0}-{1}*sqrt({2})".format(
            m.group(1), m.group(2) or "1", m.group(3)
        ),
        expr,
    )
    return expr


def _matrix_rows(expr: str):
    body = re.sub(r"\\begin\{[pb]matrix\}|\\end\{[pb]matrix\}", "", expr)
    return [row.split("&") for row in body.split("\\\\") if row.strip()]


def math_equal(
    pred: Union[bool, float, str, None],
    ref: Union[float, str, None],
    allow_percentage: bool = True,
    rel_tol: float = 1e-4,
    check_timeout: bool = False,
) -> bool:
    """Mathematical equivalence ladder (reference math_equal,
    grader.py:97-190). Cheap exact/structural checks first, symbolic last."""
    if pred is None or ref is None:
        return False
    pred_s, ref_s = str(pred).strip(), str(ref).strip()
    if pred_s.lower() == ref_s.lower():
        return True
    # multiple choice: gold is a bare letter
    if ref_s in _CHOICES and clean_choice_answer(pred_s) == ref_s:
        return True
    # unordered comma lists, unless either side is a polar coordinate
    # (where (r, theta) order is meaningful)
    if "," in pred_s and "," in ref_s:
        if not (_POLAR.match(pred_s) or _POLAR.match(ref_s)):
            if {p.strip() for p in pred_s.split(",")} == {
                r.strip() for r in ref_s.split(",")
            }:
                return True
    # numeric, tolerating that either side may be the percent form of the
    # other (42 vs 42% vs 0.42)
    pn, rn = parse_numeric_value(pred_s), parse_numeric_value(ref_s)
    if pn is not None and rn is not None:
        candidates = [rn / 100.0, rn, rn * 100.0] if allow_percentage else [rn]
        return any(math.isclose(pn, c, rel_tol=rel_tol) for c in candidates)
    # structural LaTeX: fractions, plus-minus, brackets
    pred_s, ref_s = _rewrite_latex(pred_s), _rewrite_latex(ref_s)
    is_matrix = "matrix" in pred_s and "matrix" in ref_s
    if is_matrix:
        p_rows, r_rows = _matrix_rows(pred_s), _matrix_rows(ref_s)
        return len(p_rows) == len(r_rows) and all(
            len(pr) == len(rr)
            and all(
                math_equal(pc.strip(), rc.strip(), allow_percentage, rel_tol)
                for pc, rc in zip(pr, rr)
            )
            for pr, rr in zip(p_rows, r_rows)
        )
    # elementwise tuples/intervals: (a, b) vs (a, b)
    if (
        re.fullmatch(r"[(\[].+[)\]]", pred_s)
        and re.fullmatch(r"[(\[].+[)\]]", ref_s)
        and pred_s.count(",") == ref_s.count(",")
        and pred_s.count(",") > 0
    ):
        if all(
            math_equal(p.strip(), r.strip(), allow_percentage, rel_tol)
            for p, r in zip(pred_s[1:-1].split(","), ref_s[1:-1].split(","))
        ):
            return True
    stripped_p = re.sub(r"[{}()\[\]]", "", pred_s)
    stripped_r = re.sub(r"[{}()\[\]]", "", ref_s)
    if stripped_p.lower() == stripped_r.lower():
        return True
    # single equations: compare lhs - rhs (either sign)
    if pred_s.count("=") == 1 and ref_s.count("=") == 1:
        pl, pr_ = (x.strip() for x in pred_s.split("="))
        rl, rr_ = (x.strip() for x in ref_s.split("="))
        if symbolic_equal(f"({pl}) - ({pr_})", f"({rl}) - ({rr_})", check_timeout):
            return True
        if symbolic_equal(f"-(({pl}) - ({pr_}))", f"({rl}) - ({rr_})", check_timeout):
            return True
        return False
    return symbolic_equal(pred_s, ref_s, check_timeout)


def _symbolic_equal_impl(a_expr: str, b_expr: str) -> bool:
    if not HAVE_SYMPY:
        return False

    def _parse(expr):
        expr = expr.replace("\\\\", "\\")
        for parser in ([parse_latex] if parse_latex else []) + [parse_expr]:
            try:
                return parser(expr)
            except Exception:
                continue
        return expr

    a, b = _parse(a_expr), _parse(b_expr)
    try:
        if str(a) == str(b) or a == b:
            return True
    except Exception:
        pass
    try:
        if a.equals(b) or sympy.simplify(a - b) == 0:
            return True
    except Exception:
        pass
    try:
        return math.isclose(float(sympy.N(a)), float(sympy.N(b)), rel_tol=1e-4)
    except Exception:
        pass
    return False


def _symbolic_worker(a, b, q):  # pragma: no cover - subprocess body
    q.put(_symbolic_equal_impl(a, b))


def symbolic_equal(a_expr: str, b_expr: str, check_timeout: bool = False,
                   timeout: float = 1.0) -> bool:
    """sympy equivalence; with ``check_timeout`` the comparison runs in a
    subprocess killed after ``timeout`` seconds (sympy.simplify can hang on
    adversarial model outputs — reference call_with_timeout,
    grader.py:247-259)."""
    if not HAVE_SYMPY:
        return False
    if not check_timeout:
        return _symbolic_equal_impl(a_expr, b_expr)
    q: multiprocessing.Queue = multiprocessing.Queue()
    proc = multiprocessing.Process(target=_symbolic_worker, args=(a_expr, b_expr, q))
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        return False
    try:
        return q.get_nowait()
    except Exception:
        return False


def grade_numeric(pred: Optional[str], gold: Optional[str], tol: float = 1e-6) -> bool:
    """Back-compat wrapper kept for the eval loop: strict-tolerance numeric
    equivalence, falling through to the full math_equal ladder."""
    if pred is None or gold is None:
        return False
    pf, gf = parse_numeric_value(pred), parse_numeric_value(gold)
    if pf is not None and gf is not None:
        return abs(pf - gf) <= tol * max(1.0, abs(gf))
    return math_equal(pred, gold)
