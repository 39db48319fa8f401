"""LLM-as-judge metrics (``repro/metrics/judge.py``): pointwise grading and
pairwise comparison by a judge engine, the score read from the answer by
regular expression and unparseable answers logged.

Judge prompts follow the MT-Bench structure: the rubric, the material to
grade and an explicit ``Score: <int>`` (or ``Winner: A|B``) answer format.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

POINTWISE_TEMPLATE = (
    "[Judge] Rate the following response on a 1-{scale} scale.\n"
    "Rubric: {rubric}\n"
    "Question: {question}\n"
    "Response: {response}\n"
    "Answer with 'Score: <number>' then a one-sentence explanation."
)

PAIRWISE_TEMPLATE = (
    "[Judge] Compare two responses to the question below.\n"
    "Rubric: {rubric}\n"
    "Question: {question}\n"
    "Response A: {response_a}\n"
    "Response B: {response_b}\n"
    "Answer with 'Winner: A' or 'Winner: B' then one sentence."
)

_SCORE_RE = re.compile(r"score\s*[:=]?\s*(\d+(?:\.\d+)?)", re.IGNORECASE)
_WINNER_RE = re.compile(r"winner\s*[:=]?\s*([AB])", re.IGNORECASE)


@dataclasses.dataclass
class JudgeOutcome:
    scores: np.ndarray           # (n,) float, NaN where unparseable
    unparseable: list[dict]      # logged for review

    @property
    def unparseable_rate(self) -> float:
        return len(self.unparseable) / max(len(self.scores), 1)


def extract_score(text: str, scale: int) -> float | None:
    m = _SCORE_RE.search(text)
    if m is None:
        return None
    val = float(m.group(1))
    if not 1.0 <= val <= scale:
        return None
    return val


def _requests(prompts: list[str], max_tokens: int) -> list:
    # imported here: the core package imports the metric registry, which
    # imports this module
    from repro_torch.core.engines import InferenceRequest

    return [InferenceRequest(p, max_tokens=max_tokens) for p in prompts]


def pointwise_judge(
    engine: Any,
    questions: list[str],
    responses: list[str],
    *,
    rubric: str = "helpfulness and accuracy",
    scale: int = 5,
    max_tokens: int = 48,
) -> JudgeOutcome:
    """Grade each response on a 1-``scale`` scale in one ``infer_batch``
    call; an answer without a score in range (or an engine error) is NaN
    and logged with its first 200 characters."""
    prompts = [
        POINTWISE_TEMPLATE.format(scale=scale, rubric=rubric, question=q, response=r)
        for q, r in zip(questions, responses)
    ]
    outs = engine.infer_batch(_requests(prompts, max_tokens))
    scores = np.full(len(prompts), np.nan)
    bad: list[dict] = []
    for i, o in enumerate(outs):
        val = extract_score(o.text, scale) if o.error is None else None
        if val is None:
            bad.append({"index": i, "raw": o.text[:200], "error": o.error})
        else:
            scores[i] = val
    return JudgeOutcome(scores=scores, unparseable=bad)


def pairwise_judge(
    engine: Any,
    questions: list[str],
    responses_a: list[str],
    responses_b: list[str],
    *,
    rubric: str = "helpfulness and accuracy",
    max_tokens: int = 32,
    debias_position: bool = True,
) -> JudgeOutcome:
    """1.0 where A wins, 0.0 where B wins, NaN where unparseable.  With
    ``debias_position`` each comparison also runs with the two responses
    swapped and the two verdicts are averaged (against position bias)."""

    def run(order_ab: bool) -> list[float | None]:
        prompts = [
            PAIRWISE_TEMPLATE.format(
                rubric=rubric, question=q,
                response_a=a if order_ab else b,
                response_b=b if order_ab else a,
            )
            for q, a, b in zip(questions, responses_a, responses_b)
        ]
        outs = engine.infer_batch(_requests(prompts, max_tokens))
        vals: list[float | None] = []
        for o in outs:
            m = _WINNER_RE.search(o.text) if o.error is None else None
            if m is None:
                vals.append(None)
                continue
            a_won = m.group(1).upper() == "A"
            vals.append(float(a_won if order_ab else not a_won))
        return vals

    first = run(True)
    second = run(False) if debias_position else first
    scores = np.full(len(questions), np.nan)
    bad: list[dict] = []
    for i, (x, y) in enumerate(zip(first, second)):
        if x is None and y is None:
            bad.append({"index": i, "raw": "", "error": "unparseable"})
        else:
            scores[i] = float(np.mean([v for v in (x, y) if v is not None]))
    return JudgeOutcome(scores=scores, unparseable=bad)
