"""LaTeX well-formedness checking for decoded formulas (the port of
``handwritten_math_ocr_api_tpu/eval/latex_check.py``).

Beyond the reference: its serving post-pass patched three cosmetic
malformations by regex (``clean_latex_output`` — app/src/utils.py:22-27)
but nothing ever *measured* whether a decoded formula is structurally
valid LaTeX. A decoder can emit unbalanced braces, a dangling ``\\left``,
or a ``\\begin{matrix}`` that never closes — all of which break downstream
rendering (KaTeX/MathJax) even when the CER is low. This module is a
lightweight structural validator used by the eval harness (per-sample
``valid_latex`` + summary fraction) and available to API clients who want
to gate on it.

Checks (on the space-separated token form the tokenizer produces —
src/utils.py:96-99 regex):
- brace balance and order (``{`` / ``}``),
- ``\\left``/``\\right`` pairing and nesting,
- ``\\begin{env}`` / ``\\end{env}`` stack matching (by environment name),
- argument-taking commands (``\\frac``, ``\\sqrt``, sub/superscript) not
  dangling at end-of-formula,
- sub/superscript operators having a base and an argument.

It deliberately does NOT validate command spelling against a whitelist:
the vocabulary is corpus-derived (src/build_vocab.py), so any command the
model can emit was a real token in training data.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# commands that consume one following group/token as an argument; a
# formula must not end right after one of these
_ARG_COMMANDS = {
    "\\frac": 2, "\\sqrt": 1, "\\hat": 1, "\\bar": 1, "\\vec": 1,
    "\\dot": 1, "\\ddot": 1, "\\tilde": 1, "\\overline": 1,
    "\\underline": 1, "\\mathbf": 1, "\\mathrm": 1, "\\mathcal": 1,
    "\\mathbb": 1, "\\boldsymbol": 1, "\\text": 1, "\\operatorname": 1,
    "\\overrightarrow": 1, "\\underbrace": 1, "\\overbrace": 1,
    "\\stackrel": 2, "\\binom": 2, "\\xrightarrow": 1,
}


def check_latex(latex: str) -> Tuple[bool, List[str]]:
    """Validate a space-joined token string. Returns (valid, errors) —
    errors is a list of human-readable findings, empty when valid."""
    toks = latex.split()
    errors: List[str] = []
    brace_depth = 0
    left_depth = 0
    env_stack: List[str] = []
    i = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        if t == "{":
            brace_depth += 1
        elif t == "}":
            brace_depth -= 1
            if brace_depth < 0:
                errors.append(f"unmatched '}}' at token {i}")
                brace_depth = 0
        elif t == "\\left":
            left_depth += 1
            if i + 1 >= n:
                errors.append("\\left without a delimiter")
        elif t == "\\right":
            left_depth -= 1
            if left_depth < 0:
                errors.append(f"unmatched \\right at token {i}")
                left_depth = 0
            if i + 1 >= n:
                errors.append("\\right without a delimiter")
        elif t == "\\begin":
            env, skip = _read_env(toks, i + 1)
            if env is None:
                errors.append(f"\\begin without {{env}} at token {i}")
            else:
                env_stack.append(env)
            i += skip
        elif t == "\\end":
            env, skip = _read_env(toks, i + 1)
            if env is None:
                errors.append(f"\\end without {{env}} at token {i}")
            elif not env_stack:
                errors.append(f"\\end{{{env}}} without matching \\begin")
            else:
                opened = env_stack.pop()
                if opened != env:
                    errors.append(
                        f"\\begin{{{opened}}} closed by \\end{{{env}}}")
            i += skip
        elif t in _ARG_COMMANDS:
            need = _ARG_COMMANDS[t]
            # remaining non-closing tokens must cover the arguments
            if i + 1 >= n or toks[i + 1] == "}":
                errors.append(f"{t} with no argument at token {i}")
            elif need == 2 and _ends_after_one_group(toks, i + 1):
                errors.append(f"{t} with only one argument at token {i}")
        elif t in ("^", "_"):
            if i == 0:
                errors.append(f"'{t}' with no base at token 0")
            if i + 1 >= n or toks[i + 1] in ("}", "^", "_"):
                errors.append(f"'{t}' with no argument at token {i}")
        i += 1
    if brace_depth > 0:
        errors.append(f"{brace_depth} unclosed '{{'")
    if left_depth > 0:
        errors.append(f"{left_depth} unclosed \\left")
    for env in env_stack:
        errors.append(f"unclosed \\begin{{{env}}}")
    return (not errors), errors


def _read_env(toks: Sequence[str], i: int) -> Tuple[str, int]:
    """Parse '{ name }' starting at toks[i]; returns (env_name | None,
    tokens consumed after the \\begin/\\end itself)."""
    if i < len(toks) and toks[i] == "{":
        j = i + 1
        parts = []
        while j < len(toks) and toks[j] != "}":
            parts.append(toks[j])
            j += 1
        if j < len(toks) and parts:
            return " ".join(parts), j - i + 1
    return None, 0


def _ends_after_one_group(toks: Sequence[str], i: int) -> bool:
    """True if the token stream ends after exactly one balanced group (or
    single token) starting at i — i.e. a 2-argument command got only 1."""
    if toks[i] != "{":
        return i + 1 >= len(toks)
    depth = 0
    j = i
    while j < len(toks):
        if toks[j] == "{":
            depth += 1
        elif toks[j] == "}":
            depth -= 1
            if depth == 0:
                return j + 1 >= len(toks)
        j += 1
    return True  # unbalanced: reported separately by the brace check


def validity_fraction(formulas: Sequence[str]) -> float:
    """Fraction of formulas that pass check_latex."""
    if not formulas:
        return 0.0
    return sum(1 for f in formulas if check_latex(f)[0]) / len(formulas)


def summarize_errors(formulas: Sequence[str]) -> Dict[str, int]:
    """Histogram of error kinds (first word group of each message)."""
    hist: Dict[str, int] = {}
    for f in formulas:
        for e in check_latex(f)[1]:
            key = e.split(" at ")[0]
            hist[key] = hist.get(key, 0) + 1
    return hist
