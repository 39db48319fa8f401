"""Multi-task, multi-model evaluation suites (the port of
``repro/core/suite.py``, paper sections 4.3-4.4).

``EvalSuite`` is a fluent builder: declare tasks once, sweep them across a
model list, and hand the suite to ``EvalSession.run_suite``::

    suite = (
        EvalSuite("regression")
        .add_task(qa_task, qa_rows)
        .add_task(summarization_task, sum_rows)
        .sweep_models([qwen, mamba])
    )
    with EvalSession() as session:
        res = session.run_suite(suite)
    print(res.to_markdown())

``SuiteResult`` keeps every per-(model, task) :class:`EvalResult` and the
pairwise :class:`Comparison` matrix (per task, per shared metric, per model
pair), plus text and markdown reports; a suite run by
:func:`~repro_torch.core.budget.run_adaptive_suite` also carries its
``adaptive`` payload (examples consumed, certified verdicts, the budget
spent), which the markdown report tabulates.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Iterable, Sequence, Union

import torch

from repro_torch.core.compare import Comparison, compare_scores, compare_stream_stats
from repro_torch.core.config import EngineModelConfig, EvalTask
from repro_torch.core.stages import EvalResult

#: comparisons key layout: task_id -> metric -> (label_a, label_b)
ComparisonMatrix = dict[str, dict[str, dict[tuple[str, str], Comparison]]]

#: examples for a task: a materialized list, or (for streaming tasks) a
#: zero-arg factory returning a fresh iterator per run
RowSource = Union[list[dict], Callable[[], Iterable[dict]]]


@dataclasses.dataclass(frozen=True)
class SuiteJob:
    model_label: str
    task: EvalTask
    rows: RowSource


class EvalSuite:
    def __init__(self, name: str = "suite"):
        self.name = name
        self._tasks: list[tuple[EvalTask, RowSource]] = []
        self._models: list[EngineModelConfig] = []

    # -- fluent builder ----------------------------------------------------------

    def add_task(
        self, task: EvalTask, rows: Sequence[dict] | Callable[[], Iterable[dict]]
    ) -> "EvalSuite":
        """Register a task template and its examples.  The task's own
        ``model`` is used unless :meth:`sweep_models` overrides it.

        For streaming tasks pass a zero-arg callable (e.g.
        ``lambda: iter_qa_examples(1_000_000)``) so each (model, task) job
        consumes a fresh iterator without materializing the dataset."""
        if task.task_id in self.task_ids():
            raise ValueError(f"duplicate task_id {task.task_id!r}")
        self._tasks.append((task, rows if callable(rows) else list(rows)))
        return self

    def sweep_models(
        self, models: Sequence[EngineModelConfig]
    ) -> "EvalSuite":
        """Evaluate every registered task under each of these models."""
        self._models.extend(models)
        return self

    def with_streaming(self, **kw) -> "EvalSuite":
        """Apply :meth:`EvalTask.with_streaming` to every registered task —
        e.g. ``.with_streaming(concurrency=4, max_memory_rows=2048)`` turns
        on N-way concurrent chunk execution suite-wide.  Tasks added later
        are not affected; call this after the last ``add_task``."""
        self._tasks = [
            (task.with_streaming(**kw), rows) for task, rows in self._tasks
        ]
        return self

    # -- expansion ---------------------------------------------------------------

    def task_ids(self) -> list[str]:
        return [t.task_id for t, _ in self._tasks]

    def model_configs(self) -> list[EngineModelConfig]:
        if self._models:
            return list(self._models)
        # no sweep: each task runs under its own configured model
        seen: list[EngineModelConfig] = []
        for task, _ in self._tasks:
            if task.model not in seen:
                seen.append(task.model)
        return seen

    def model_labels(self) -> list[str]:
        cfgs = self.model_configs()
        names = [c.model_name for c in cfgs]
        return [
            c.model_name
            if names.count(c.model_name) == 1
            else f"{c.provider}:{c.model_name}"
            for c in cfgs
        ]

    def jobs(self) -> list[SuiteJob]:
        """Expand to the (model × task) job list, grouped by model so a
        session touches each engine's working set contiguously."""
        if not self._tasks:
            raise ValueError("suite has no tasks; call add_task first")
        labels = self.model_labels()
        out: list[SuiteJob] = []
        if self._models:
            for label, model in zip(labels, self._models):
                for task, rows in self._tasks:
                    out.append(
                        SuiteJob(label, task.with_model(model), rows)
                    )
        else:
            by_cfg = dict(zip(self.model_configs(), labels))
            for task, rows in self._tasks:
                out.append(SuiteJob(by_cfg[task.model], task, rows))
        return out


def build_comparisons(
    suite: EvalSuite,
    results: dict[tuple[str, str], EvalResult],
    *,
    device: torch.device | str | None = None,
) -> ComparisonMatrix:
    """Pairwise significance matrix: for each task and each metric shared
    by all models, compare every model pair — on aligned score vectors for
    in-memory runs (the difference's interval resampled on ``device``), or
    on shared-weight-stream bootstrap replicate state
    (:func:`~repro_torch.core.compare.compare_stream_stats`) for streaming
    runs that never materialize per-example scores."""
    labels = suite.model_labels()
    out: ComparisonMatrix = {}
    for task, _ in suite._tasks:
        stats = task.statistics
        per_result = {
            label: results[(label, task.task_id)]
            for label in labels
            if (label, task.task_id) in results
        }
        per_model = {label: r.scores for label, r in per_result.items()}
        if len(per_model) < 2:
            out[task.task_id] = {}
            continue
        task_cmp: dict[str, dict[tuple[str, str], Comparison]] = {}
        present = [lab for lab in labels if lab in per_model]
        shared = set.intersection(*(set(s) for s in per_model.values()))
        for metric in sorted(shared):
            cells: dict[tuple[str, str], Comparison] = {}
            for i, a in enumerate(present):
                for b in present[i + 1:]:
                    cells[(a, b)] = compare_scores(
                        metric,
                        per_model[a][metric],
                        per_model[b][metric],
                        confidence=stats.confidence_level,
                        n_boot=stats.bootstrap_iterations,
                        seed=stats.seed,
                        device=device,
                    )
            task_cmp[metric] = cells
        if not shared and any(not s for s in per_model.values()):
            task_cmp = _stream_comparisons(task, per_result, present)
        out[task.task_id] = task_cmp
    return out


def _stream_comparisons(
    task: EvalTask,
    per_result: dict[str, EvalResult],
    present: list[str],
) -> dict[str, dict[tuple[str, str], Comparison]]:
    """Pairwise comparisons for streaming runs: paired-delta bootstrap on
    the replicate state the runs carried instead of per-example scores.
    Warns (and yields no cells) when that state is absent — analytical
    ``ci_method`` maintains no replicates — or when two runs' weight
    streams are not shared (mismatched seed/B/backend/chunk layout)."""
    stats = task.statistics
    streams = {
        label: r.stream_stats
        for label, r in per_result.items()
        if r.stream_stats is not None
    }
    if len(streams) < 2:
        warnings.warn(
            f"task {task.task_id!r}: no per-example scores and no streaming "
            "replicate state to compare",
            stacklevel=3,
        )
        return {}
    shared = set.intersection(*(set(s.accs) for s in streams.values()))
    task_cmp: dict[str, dict[tuple[str, str], Comparison]] = {}
    warned: set[tuple[str, str]] = set()
    for metric in sorted(shared):
        cells: dict[tuple[str, str], Comparison] = {}
        for i, a in enumerate(present):
            for b in present[i + 1:]:
                if a not in streams or b not in streams:
                    continue
                reason = streams[a].comparable_with(streams[b])
                if reason is not None:
                    if (a, b) not in warned:
                        warned.add((a, b))
                        warnings.warn(
                            f"task {task.task_id!r}: streaming runs "
                            f"{a!r} vs {b!r} are not paired-comparable: "
                            f"{reason}",
                            stacklevel=3,
                        )
                    continue
                cells[(a, b)] = compare_stream_stats(
                    metric, streams[a], streams[b],
                    confidence=stats.confidence_level,
                )
        if cells:
            task_cmp[metric] = cells
    return task_cmp


@dataclasses.dataclass
class SuiteResult:
    name: str
    models: list[str]
    tasks: list[str]
    results: dict[tuple[str, str], EvalResult]
    comparisons: ComparisonMatrix
    accounting: dict
    #: adaptive-run payload from :func:`repro_torch.core.budget.
    #: run_adaptive_suite` (empty for exhaustive runs): per-task consumed
    #: examples, certified verdicts, stop reasons and the budget spent
    adaptive: dict = dataclasses.field(default_factory=dict)

    # -- lookups -----------------------------------------------------------------

    def result(self, model: str, task_id: str) -> EvalResult:
        return self.results[(model, task_id)]

    def comparison(
        self, task_id: str, metric: str, a: str, b: str
    ) -> Comparison:
        cells = self.comparisons[task_id][metric]
        if (a, b) in cells:
            return cells[(a, b)]
        return cells[(b, a)]

    def significant_pairs(
        self, alpha: float = 0.05
    ) -> list[tuple[str, str, str, str, Comparison]]:
        out = []
        for task_id, metrics in self.comparisons.items():
            for metric, cells in metrics.items():
                for (a, b), cmp in cells.items():
                    if cmp.test.p_value < alpha:
                        out.append((task_id, metric, a, b, cmp))
        return out

    # -- reports -----------------------------------------------------------------

    def summary(self, alpha: float = 0.05) -> str:
        lines = [f"suite {self.name!r}: {len(self.models)} models × "
                 f"{len(self.tasks)} tasks"]
        for task_id in self.tasks:
            lines.append(f"  task {task_id}:")
            for model in self.models:
                res = self.results.get((model, task_id))
                if res is None:
                    continue
                vals = ", ".join(
                    f"{n}={mv.value:.3f}" for n, mv in res.metrics.items()
                )
                lines.append(f"    {model:28s} {vals}")
            for metric, cells in self.comparisons.get(task_id, {}).items():
                for (a, b), cmp in cells.items():
                    lines.append(f"    {cmp.summary(alpha)}")
        return "\n".join(lines)

    def to_markdown(self, alpha: float = 0.05) -> str:
        lines = [f"# Suite report: {self.name}", ""]
        for task_id in self.tasks:
            lines.append(f"## Task `{task_id}`")
            metrics: list[str] = []
            for model in self.models:
                res = self.results.get((model, task_id))
                if res is not None:
                    for m in res.metrics:
                        if m not in metrics:
                            metrics.append(m)
            lines.append("")
            lines.append("| model | " + " | ".join(metrics) + " |")
            lines.append("|---" * (len(metrics) + 1) + "|")
            for model in self.models:
                res = self.results.get((model, task_id))
                if res is None:
                    continue
                cells = []
                for m in metrics:
                    mv = res.metrics.get(m)
                    cells.append(
                        f"{mv.value:.3f} [{mv.ci[0]:.3f}, {mv.ci[1]:.3f}]"
                        if mv is not None else "—"
                    )
                lines.append(f"| {model} | " + " | ".join(cells) + " |")
            cmp_rows = [
                (metric, pair, cmp)
                for metric, cellmap in self.comparisons.get(task_id, {}).items()
                for pair, cmp in cellmap.items()
            ]
            if cmp_rows:
                lines.append("")
                lines.append("| metric | pair | Δ | 95% CI | test | p | verdict |")
                lines.append("|---|---|---|---|---|---|---|")
                for metric, (a, b), cmp in cmp_rows:
                    verdict = (
                        "**significant**"
                        if cmp.test.p_value < alpha else "n.s."
                    )
                    lines.append(
                        f"| {metric} | {a} vs {b} | {cmp.diff:+.4f} "
                        f"| ({cmp.diff_ci[0]:+.4f}, {cmp.diff_ci[1]:+.4f}) "
                        f"| {cmp.test.test} | {cmp.test.p_value:.4g} "
                        f"| {verdict} |"
                    )
            lines.append("")
        if self.adaptive:
            b = self.adaptive.get("budget", {})
            lines.append("## Adaptive evaluation")
            lines.append("")
            lines.append(
                f"budget: {b.get('spent', 0)} / {b.get('total_examples', 0)} "
                f"examples spent over {b.get('rounds', 0)} round(s) "
                f"(alpha={b.get('alpha', 0)}, margin={b.get('margin', 0)})"
            )
            lines.append("")
            lines.append(
                "| task | metric | consumed | exhausted | outcome "
                "| n at stop | half-width | certified verdicts |"
            )
            lines.append("|---" * 8 + "|")
            for tid in self.tasks:
                t = self.adaptive.get("tasks", {}).get(tid)
                if t is None:
                    continue
                consumed = ", ".join(
                    f"{lab}: {n}" for lab, n in t.get("consumed", {}).items()
                )
                verdicts = "; ".join(
                    f"{pair}: {v}" for pair, v in t.get("verdicts", {}).items()
                ) or "—"
                hw = t.get("half_width", float("inf"))
                hw_s = f"{hw:.4f}" if math.isfinite(hw) else "inf"
                lines.append(
                    f"| {tid} | {t.get('metric', '?')} | {consumed} "
                    f"| {'yes' if t.get('exhausted') else 'no'} "
                    f"| {t.get('reason') or 'open'} "
                    f"| {t.get('n_at_stop', 0)} "
                    f"| {hw_s} | {verdicts} |"
                )
            lines.append("")
        serving = self.accounting.get("serving") or []
        if serving:
            lines.append("## Inference service")
            lines.append("")
            lines.append(
                "| engine | mode | replicas | submitted | dispatched "
                "| coalesced | dedup | occupancy | tok/step | admissions "
                "| recompiles | prefix hits | prefix tok saved "
                "| kv B/tok | preempt | restarts | hedges |"
            )
            lines.append("|---" * 17 + "|")
            for s in serving:
                b = s.get("batcher") or {}
                lines.append(
                    f"| {s.get('engine', '?')} | {s.get('mode', '?')} "
                    f"| {s.get('replicas', 1)} "
                    f"| {s.get('submitted', 0)} | {s.get('dispatched', 0)} "
                    f"| {s.get('coalesced', 0)} "
                    f"| {s.get('dedup_rate', 0.0):.1%} "
                    f"| {b.get('slot_occupancy', '—')} "
                    f"| {b.get('tokens_per_step', '—')} "
                    f"| {b.get('admissions', '—')} "
                    f"| {b.get('prefill_recompiles', '—')} "
                    f"| {b.get('prefix_pages_hit', '—')} "
                    f"| {b.get('prefix_tokens_saved', '—')} "
                    f"| {b.get('kv_bytes_per_token', '—')} "
                    f"| {b.get('preemptions', '—')} "
                    f"| {s.get('restarts', 0)} "
                    f"| {s.get('hedges_issued', 0)}/{s.get('hedges_won', 0)} |"
                )
            lines.append("")
        acct = ", ".join(
            f"{k}={v}" for k, v in self.accounting.items() if k != "serving"
        )
        lines.append(f"_session accounting: {acct}_")
        return "\n".join(lines)
