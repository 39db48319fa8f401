"""Suite-level inference-budget scheduler (the port of
``repro/core/budget.py``): certify verdicts, not datasets.

An exhaustive suite scores every example of every task under every model.
The adaptive scheduler instead treats scored examples as a *budget* and
spends it where the statistics say the answer is still open: after a seed
round, each subsequent round of chunks goes to the tasks whose relevant
anytime-valid intervals are widest, until every task is **certified**
(pairwise verdicts decided at the caller's margin, or a single-arm CI at
target width), its data source is exhausted, or the budget runs out.

Optional stopping is safe here *by construction*: all intervals come from
the confidence sequences of :mod:`repro_torch.stats.sequential`, which hold
simultaneously over all sample sizes — peeking after every round cannot
inflate the error beyond alpha.  Pairwise verdicts ride on the shared
Poisson-bootstrap weight streams of :mod:`repro_torch.stats.streaming` (paired
replicate-delta variance, no per-example scores).

Mechanically the scheduler is a thin loop over the existing machinery:

* **rounds are resumes** — each round re-runs a task over a fresh source
  iterator with its declared example cap
  (``StreamingConfig.max_examples``) raised by a chunk multiple.  Because
  caps are exact chunk multiples, the chunk layout — and therefore every
  chunk digest and bootstrap offset — is identical across rounds, so the
  spill manifest replays all prior rounds' chunks and only the newly
  allocated chunks run inference.  Crash-resume and incremental
  evaluation are literally the same code path.
* **pairing is preserved** — per-arm width stopping is disabled for
  multi-arm tasks (arms stopping at different n would desynchronize the
  shared weight streams and break paired comparison); all pair-level
  stopping happens here, through equal round caps per arm.  Single-arm
  tasks keep their own :class:`~repro_torch.stats.sequential.StoppingRule`.
* **determinism** — allocation decisions are pure functions of the
  (deterministic) round results, so re-running a finished or interrupted
  adaptive suite with the same budget over the same spill dirs reproduces
  the identical stop points, consumed counts and certified matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.config import EvalTask
from repro_torch.core.suite import EvalSuite, SuiteJob, SuiteResult, build_comparisons
from repro_torch.metrics.registry import resolve_metrics
from repro_torch.stats.sequential import (
    StoppingRule,
    rho_opt,
    sequential_ci,
    sequential_compare,
)


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Suite-wide adaptive sampling budget, in scored examples.

    ``total_examples`` bounds the *fresh* examples scored across all
    (model, task) arms; chunks replayed from a spill manifest are free.
    Each task's first (seed) round always runs — a certification needs at
    least ``min_examples`` to stand on — even if it overshoots a tiny
    budget; every later allocation is refused once it would exceed the
    total.
    """

    total_examples: int
    #: examples added per arm when a task wins a round (rounded up to the
    #: task's chunk size so the chunk layout never shifts between rounds)
    round_examples: int = 1024
    #: seed-round size per arm, and the sample size the confidence
    #: sequence is tuned to be tightest at (when ``rho`` is 0)
    min_examples: int = 256
    #: single-arm tasks certify when their CI half-width reaches this
    #: (0 = single-arm tasks only finish by stopping rule / exhaustion)
    target_half_width: float = 0.0
    alpha: float = 0.05
    #: certification margin for pairwise verdicts (0 = any difference)
    margin: float = 0.0
    #: metric to certify on ("" = the task's first metric)
    metric: str = ""
    rho: float = 0.0
    method: str = "acs"
    #: backstop on scheduler iterations, not a statistical parameter
    max_rounds: int = 1000

    def effective_rho(self) -> float:
        """Fixed mixture parameter for the whole run: anytime validity
        needs one rho across all looks, so it is tuned once (at
        ``min_examples``), never re-tuned at the current n."""
        if self.rho > 0.0:
            return self.rho
        return rho_opt(max(self.min_examples, 2), self.alpha)


def _round_up(n: int, chunk: int) -> int:
    return ((max(n, 1) + chunk - 1) // chunk) * chunk


def _cert_metric(task: EvalTask, budget: BudgetConfig) -> str:
    names = [name for name, _ in resolve_metrics(task.metrics)]
    if budget.metric:
        if budget.metric not in names:
            raise ValueError(
                f"budget certifies on metric {budget.metric!r} but task "
                f"{task.task_id!r} computes {names}"
            )
        return budget.metric
    return names[0]


def _arm_task(task: EvalTask, n_arms: int) -> EvalTask:
    if n_arms > 1 and task.stopping.enabled:
        # per-arm width stopping would stop arms at different n, which
        # desynchronizes the shared bootstrap weight streams and forfeits
        # the paired comparison — pair-level stopping belongs to the
        # scheduler's equal round caps
        return dataclasses.replace(task, stopping=StoppingRule())
    return task


def run_adaptive_suite(
    session: Any, suite: EvalSuite, budget: BudgetConfig
) -> SuiteResult:
    """Run ``suite`` adaptively under ``budget`` and return a
    :class:`~repro_torch.core.suite.SuiteResult` whose ``adaptive`` payload
    records, per task: examples consumed per arm, whether the source was
    exhausted, the certified verdicts with the sample size they were
    certified at, and the budget spent."""
    jobs = suite.jobs()
    by_task: dict[str, list[SuiteJob]] = {}
    for job in jobs:
        by_task.setdefault(job.task.task_id, []).append(job)
    task_order = suite.task_ids()

    for tid in task_order:
        arms = by_task[tid]
        t = arms[0].task
        if not t.streaming.enabled or not t.streaming.spill_dir:
            raise ValueError(
                f"adaptive suite requires streaming with a spill_dir "
                f"(rounds resume prior rounds' chunks); task {tid!r} has "
                f"enabled={t.streaming.enabled} "
                f"spill_dir={t.streaming.spill_dir!r}"
            )
        if not callable(arms[0].rows):
            raise ValueError(
                f"adaptive suite requires a zero-arg rows factory (each "
                f"round re-slices a fresh iterator); task {tid!r} was "
                "added with a materialized list"
            )

    chunk = {tid: by_task[tid][0].task.streaming.max_memory_rows
             for tid in task_order}
    caps = {tid: _round_up(budget.min_examples, chunk[tid])
            for tid in task_order}
    consumed: dict[tuple[str, str], int] = {}
    results: dict[tuple[str, str], Any] = {}
    state: dict[str, dict] = {
        tid: {"done": False, "reason": "", "half_width": float("inf"),
              "exhausted": False, "verdicts": {}, "metric": "",
              "certified_n": 0}
        for tid in task_order
    }

    def spent() -> int:
        # chunks replayed across rounds are counted once: `consumed` holds
        # the latest (cumulative) count per arm, overwritten each round
        return sum(consumed.values())

    def assess(tid: str) -> None:
        arms = by_task[tid]
        task = arms[0].task
        labels = [j.model_label for j in arms]
        metric = _cert_metric(task, budget)
        st = state[tid]
        st["metric"] = metric
        streams = {
            lab: results[(lab, tid)].stream_stats
            for lab in labels if (lab, tid) in results
        }
        n_max = max(
            (consumed.get((lab, tid), 0) for lab in labels), default=0
        )
        if len(labels) >= 2:
            undecided_w: list[float] = []
            all_w: list[float] = []
            verdicts: dict[str, str] = {}
            for i, a in enumerate(labels):
                for b in labels[i + 1:]:
                    c = sequential_compare(
                        metric, streams[a], streams[b],
                        alpha=budget.alpha, margin=budget.margin,
                        rho=budget.effective_rho(), method=budget.method,
                    )
                    verdicts[f"{a} vs {b}"] = c.verdict
                    all_w.append(c.half_width)
                    if c.verdict == "undecided":
                        undecided_w.append(c.half_width)
            st["verdicts"] = verdicts
            # allocation ranks open tasks by their widest *undecided* pair;
            # once everything is decided this is the half-width at stop
            st["half_width"] = max(
                undecided_w, default=max(all_w, default=0.0)
            )
            if not undecided_w:
                st["done"], st["reason"] = True, "certified"
                st["certified_n"] = n_max
        else:
            lab = labels[0]
            iv = sequential_ci(
                streams[lab].accs[metric], alpha=budget.alpha,
                rho=budget.effective_rho(), method=budget.method,
            )
            st["half_width"] = iv.half_width
            if (
                budget.target_half_width > 0.0
                and iv.half_width <= budget.target_half_width
            ):
                st["done"], st["reason"] = True, "certified"
                st["certified_n"] = n_max
        if not st["done"]:
            adaptive_logs = [
                results[(lab, tid)].logs.get("adaptive") or {}
                for lab in labels if (lab, tid) in results
            ]
            if any(a.get("stopped") for a in adaptive_logs):
                st["done"] = True
                st["reason"] = next(
                    a.get("reason", "stopped")
                    for a in adaptive_logs if a.get("stopped")
                )
                st["certified_n"] = n_max
            elif st["exhausted"]:
                st["done"], st["reason"] = True, "exhausted"
                st["certified_n"] = n_max

    rounds = 0
    pending = set(task_order)
    while pending and rounds < budget.max_rounds:
        rounds += 1
        if rounds == 1:
            order = [t for t in task_order if t in pending]
        else:
            # widest open interval first; suite order breaks ties so the
            # schedule is a pure function of the (deterministic) results
            idx = {t: i for i, t in enumerate(task_order)}
            order = sorted(
                pending, key=lambda t: (-state[t]["half_width"], idx[t])
            )
        ran_any = False
        for tid in order:
            arms = by_task[tid]
            prev = sum(consumed.get((j.model_label, tid), 0) for j in arms)
            alloc = caps[tid] * len(arms) - prev
            if alloc <= 0:
                continue
            # seed rounds (prev == 0) always run — a certification needs
            # min_examples to stand on; every later allocation respects
            # the budget
            if prev > 0 and spent() + alloc > budget.total_examples:
                continue
            for job in arms:
                task = _arm_task(job.task, len(arms)).with_streaming(
                    max_examples=caps[tid]
                )
                res = session.run_task(job.rows(), task)
                key = (job.model_label, tid)
                results[key] = res
                n = res.logs["streaming"]["n_examples"]
                consumed[key] = n
                if n < caps[tid]:
                    state[tid]["exhausted"] = True
            ran_any = True
            assess(tid)
            if state[tid]["done"]:
                pending.discard(tid)
            else:
                caps[tid] += _round_up(budget.round_examples, chunk[tid])
        if not ran_any:
            break  # nothing affordable: remaining tasks end undecided

    for tid in pending:
        state[tid]["reason"] = state[tid]["reason"] or "budget_exhausted"

    comparisons = build_comparisons(suite, results, device=session.device)
    accounting = session.accounting.as_dict()
    serving = session.serving_stats()
    if serving:
        accounting["serving"] = serving
    adaptive = {
        "budget": {
            **dataclasses.asdict(budget),
            "spent": spent(),
            "rounds": rounds,
        },
        "tasks": {
            tid: {
                "consumed": {
                    j.model_label: consumed.get((j.model_label, tid), 0)
                    for j in by_task[tid]
                },
                "exhausted": state[tid]["exhausted"],
                "certified": state[tid]["reason"] == "certified",
                "reason": state[tid]["reason"],
                "metric": state[tid]["metric"],
                "half_width": state[tid]["half_width"],
                "verdicts": state[tid]["verdicts"],
                "n_at_stop": state[tid]["certified_n"] or max(
                    (consumed.get((j.model_label, tid), 0)
                     for j in by_task[tid]), default=0,
                ),
            }
            for tid in task_order
        },
    }
    return SuiteResult(
        name=suite.name,
        models=suite.model_labels(),
        tasks=suite.task_ids(),
        results=results,
        comparisons=comparisons,
        accounting=accounting,
        adaptive=adaptive,
    )
