"""``EvalRunner``, the reference's single-task facade
(``repro/core/runner.py``): each ``evaluate`` opens a fresh session, runs
the task and closes it, so every call pays for its own engine and cache
handles.  Code that runs several tasks should hold an
:class:`~repro_torch.core.session.EvalSession` instead."""

from __future__ import annotations

import torch

from repro_torch.core.config import EvalTask
from repro_torch.core.engines import InferenceEngine
from repro_torch.core.session import EvalSession
from repro_torch.core.stages import EvalResult, MetricValue

__all__ = ["EvalResult", "EvalRunner", "MetricValue"]


class EvalRunner:
    """``device`` is where each session runs (the card unless
    ``device="cpu"``); the other arguments are the reference's."""

    def __init__(
        self,
        *,
        judge_engine: InferenceEngine | None = None,
        wall_clock_rate_limit: bool = False,
        device: torch.device | str | None = None,
    ):
        self._judge_engine = judge_engine
        self._wall_clock = wall_clock_rate_limit
        self._device = device

    def evaluate(self, rows: list[dict], task: EvalTask) -> EvalResult:
        with EvalSession(
            device=self._device,
            judge_engine=self._judge_engine,
            wall_clock_rate_limit=self._wall_clock,
        ) as session:
            return session.run_task(rows, task)
