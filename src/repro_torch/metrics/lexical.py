"""Lexical metrics (the port's copy of ``repro/metrics/lexical.py``): exact
match, contains, token F1, BLEU and ROUGE-L over the SQuAD normaliser.
Pure Python; each gives the reference's floats."""

from __future__ import annotations

import math
import re
import string
from collections import Counter

import numpy as np

_PUNCT = str.maketrans("", "", string.punctuation)
_ARTICLES = re.compile(r"\b(a|an|the)\b")
_WS = re.compile(r"\s+")


def normalize(text: str) -> str:
    """SQuAD-style normalization: lowercase, strip punctuation/articles."""
    text = text.lower().translate(_PUNCT)
    text = _ARTICLES.sub(" ", text)
    return _WS.sub(" ", text).strip()


def _tokens(text: str) -> tuple[str, ...]:
    return tuple(normalize(text).split())


def exact_match(pred: str, ref: str, *, normalized: bool = True) -> float:
    if normalized:
        return float(normalize(pred) == normalize(ref))
    return float(pred == ref)


def contains(pred: str, ref: str, *, normalized: bool = True) -> float:
    if normalized:
        return float(normalize(ref) in normalize(pred))
    return float(ref in pred)


def token_f1(pred: str, ref: str) -> float:
    """Token-level F1 (Rajpurkar et al., 2016)."""
    p_toks = _tokens(pred)
    r_toks = _tokens(ref)
    if not p_toks or not r_toks:
        return float(p_toks == r_toks)
    n_common = sum((Counter(p_toks) & Counter(r_toks)).values())
    if n_common == 0:
        return 0.0
    precision = n_common / len(p_toks)
    recall = n_common / len(r_toks)
    return 2 * precision * recall / (precision + recall)


def _ngrams(tokens: tuple[str, ...], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(pred: str, ref: str, *, max_n: int = 4, smooth: float = 1.0) -> float:
    """Sentence BLEU with brevity penalty and add-k smoothing
    (Papineni et al., 2002; Lin & Och smoothing)."""
    p_toks = _tokens(pred)
    r_toks = _tokens(ref)
    if not p_toks:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        p_ng = _ngrams(p_toks, n)
        r_ng = _ngrams(r_toks, n)
        overlap = sum((p_ng & r_ng).values())
        total = sum(p_ng.values())
        if total == 0:
            log_precisions.append(math.log(1e-9))
            continue
        num = overlap + (smooth if n > 1 else 0.0)
        den = total + (smooth if n > 1 else 0.0)
        log_precisions.append(math.log(num / den) if num > 0 else math.log(1e-9))
    geo = math.exp(sum(log_precisions) / max_n)
    bp = 1.0 if len(p_toks) >= len(r_toks) else math.exp(1 - len(r_toks) / len(p_toks))
    return bp * geo


def _lcs_len(a: tuple[str, ...], b: tuple[str, ...]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(pred: str, ref: str) -> float:
    """ROUGE-L F1 (longest common subsequence; Lin 2004)."""
    p_toks = _tokens(pred)
    r_toks = _tokens(ref)
    lcs = _lcs_len(p_toks, r_toks)
    if lcs == 0:
        return 0.0
    prec = lcs / len(p_toks)
    rec = lcs / len(r_toks)
    return 2 * prec * rec / (prec + rec)


SCALAR = {
    "exact_match": exact_match,
    "contains": contains,
    "token_f1": token_f1,
    "bleu": bleu,
    "rouge_l": rouge_l,
}


def batch_lexical(name: str, preds: list[str], refs: list[str], **kw) -> np.ndarray:
    fn = SCALAR[name]
    return np.asarray([fn(p, r, **kw) for p, r in zip(preds, refs)], np.float64)
