"""Local experiment tracking in the MLflow style (``repro/core/tracking.py``).

One directory per run under ``root``: ``params.json`` (the whole task
config), ``metrics.json`` (each value, its interval's ends, its scored and
unscored counts as separate entries, the throughput and the stage seconds),
``tags.json`` and ``artifacts/`` (the per-example responses and scores, and
the run's cache, engine and failure stats).  A suite gets a directory of
its report, its comparisons and its accounting."""

from __future__ import annotations

import gzip
import json
import os
import time
import uuid

import numpy as np

from repro_torch.core.config import EvalTask
from repro_torch.core.stages import EvalResult


class RunTracker:
    def __init__(self, root: str = "experiments/runs"):
        self.root = root
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def _new_id(prefix: str = "") -> str:
        return f"{prefix}{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:6]}"

    def _write_json(self, path: str, obj, **kw) -> None:
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, **kw)

    def log_run(self, task: EvalTask, result: EvalResult, **tags: str) -> str:
        run_id = self._new_id()
        rdir = os.path.join(self.root, run_id)
        os.makedirs(os.path.join(rdir, "artifacts"), exist_ok=True)

        with open(os.path.join(rdir, "params.json"), "w") as f:
            f.write(task.to_json())

        metrics_flat: dict[str, float] = {}
        for name, mv in result.metrics.items():
            metrics_flat[name] = mv.value
            metrics_flat[f"{name}_ci_lower"] = mv.ci[0]
            metrics_flat[f"{name}_ci_upper"] = mv.ci[1]
            metrics_flat[f"{name}_n"] = mv.n
            metrics_flat[f"{name}_unscored"] = mv.n_unscored
        metrics_flat["throughput_per_min"] = result.throughput_per_min
        for k, v in result.timing.items():
            metrics_flat[f"time_{k}"] = v
        self._write_json(os.path.join(rdir, "metrics.json"), metrics_flat)

        self._write_json(os.path.join(rdir, "tags.json"), {
            "model": task.model.model_name,
            "provider": task.model.provider,
            "task_id": task.task_id,
            "fingerprint": task.fingerprint(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            **tags,
        })

        with gzip.open(os.path.join(rdir, "artifacts", "results.jsonl.gz"), "wt") as f:
            for i, text in enumerate(result.responses):
                row = {"index": i, "response": text}
                for m, vals in result.scores.items():
                    v = float(vals[i])
                    row[m] = None if np.isnan(v) else v
                f.write(json.dumps(row) + "\n")
        self._write_json(
            os.path.join(rdir, "artifacts", "run_stats.json"),
            {"cache": result.cache_stats, "engine": result.engine_stats,
             "failures": result.failures},
            default=str,
        )
        return run_id

    def log_suite(self, suite_result, **tags: str) -> str:
        """Persist a :class:`~repro_torch.core.suite.SuiteResult`: the
        markdown report, the pairwise comparisons and the session
        accounting, in a directory beside the runs."""
        suite_id = self._new_id("suite-")
        sdir = os.path.join(self.root, suite_id)
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, "report.md"), "w") as f:
            f.write(suite_result.to_markdown())
        comparisons = [
            {
                "task": task_id,
                "metric": metric,
                "a": a,
                "b": b,
                "diff": cmp.diff,
                "p_value": cmp.test.p_value,
                "test": cmp.test.test,
                "effect": cmp.effect.value,
                "summary": cmp.summary(),
            }
            for task_id, metrics in suite_result.comparisons.items()
            for metric, cells in metrics.items()
            for (a, b), cmp in cells.items()
        ]
        self._write_json(os.path.join(sdir, "comparisons.json"), comparisons)
        self._write_json(os.path.join(sdir, "tags.json"), {
            "suite": suite_result.name,
            "models": suite_result.models,
            "tasks": suite_result.tasks,
            "accounting": suite_result.accounting,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            **tags,
        })
        return suite_id

    def list_runs(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def load_metrics(self, run_id: str) -> dict:
        with open(os.path.join(self.root, run_id, "metrics.json")) as f:
            return json.load(f)

    def load_tags(self, run_id: str) -> dict:
        with open(os.path.join(self.root, run_id, "tags.json")) as f:
            return json.load(f)
