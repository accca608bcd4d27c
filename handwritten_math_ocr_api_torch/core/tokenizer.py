"""LaTeX tokenizer, vocabulary loader and detokenizer.

A copy of ``handwritten_math_ocr_api_tpu/core/tokenizer.py``'s serving
part: the token regex, the vocab JSON schema (``{"vocab": {...},
"idx2char": {...}}``), ``Tokenizer`` and the LaTeX cleanup regexes, so that
vocab files and decoded strings are interchangeable between the packages.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Tuple

from .config import (
    EOS_ID,
    EOS_TOKEN,
    PAD_ID,
    PAD_TOKEN,
    SOS_ID,
    SOS_TOKEN,
    UNK_ID,
    UNK_TOKEN,
)

# a LaTeX command, a structural character, a digit run, a letter run, or
# any single non-space character
TOKEN_PATTERN = re.compile(r"(\\[a-zA-Z]+|[{}_^$%&#]|[0-9]+|[a-zA-Z]+|[^\s])")


def tokenize_latex(formula: str) -> List[str]:
    return TOKEN_PATTERN.findall(formula)


def load_vocab(path: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Load vocab JSON -> (token->id, id->token)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    vocab = data["vocab"]
    idx2char = {int(k): v for k, v in data["idx2char"].items()}
    return vocab, idx2char


class Tokenizer:
    """Encode/decode between LaTeX strings and id sequences."""

    def __init__(self, vocab: Dict[str, int],
                 idx2char: Dict[int, str] | None = None):
        self.vocab = vocab
        self.idx2char = idx2char or {v: k for k, v in vocab.items()}
        self.pad_id = vocab.get(PAD_TOKEN, PAD_ID)
        self.sos_id = vocab.get(SOS_TOKEN, SOS_ID)
        self.eos_id = vocab.get(EOS_TOKEN, EOS_ID)
        self.unk_id = vocab.get(UNK_TOKEN, UNK_ID)

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, formula: str, max_len: int | None = None) -> List[int]:
        """``<sos> tokens <eos>``, truncated (after the eos) and padded to
        ``max_len``."""
        ids = [self.sos_id]
        ids += [self.vocab.get(t, self.unk_id)
                for t in tokenize_latex(formula)]
        ids.append(self.eos_id)
        if max_len is not None:
            ids = ids[:max_len]
            ids += [self.pad_id] * (max_len - len(ids))
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        """Ids -> space-joined tokens; stop at eos, skip pad/sos."""
        tokens = []
        for idx in ids:
            token = self.idx2char.get(int(idx), UNK_TOKEN)
            if token == EOS_TOKEN:
                break
            if skip_special and token in (PAD_TOKEN, SOS_TOKEN):
                continue
            tokens.append(token)
        return " ".join(tokens)

    def decode_batch(self, batch_ids) -> List[str]:
        return [self.decode(row) for row in batch_ids]


# fixes artifacts of space-joined detokenization
_RE_BEGIN = re.compile(r"\\begin\s+\{")
_RE_END = re.compile(r"\\end\s+\{")
_RE_BRACED_WORD = re.compile(r"\{(\s+)([a-zA-Z]+)(\s+)\}")
_RE_DOUBLE_BACKSLASH = re.compile(r"\\\s+\\")


def clean_latex_output(latex_str: str) -> str:
    latex_str = _RE_BEGIN.sub(r"\\begin{", latex_str)
    latex_str = _RE_END.sub(r"\\end{", latex_str)
    latex_str = _RE_BRACED_WORD.sub(r"{\2}", latex_str)
    latex_str = _RE_DOUBLE_BACKSLASH.sub(r"\\\\", latex_str)
    return latex_str
