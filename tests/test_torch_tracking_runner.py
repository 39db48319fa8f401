"""The port's experiment tracking and ``EvalRunner`` shim against the JAX
package's, on the CPU, over simulated API engines (dyadic metrics, so the
two packages' values are equal bit for bit):

* ``RunTracker.log_run`` writes the reference's ``metrics.json`` (but for
  the clock's entries), ``tags.json`` (but for the time; the task
  fingerprint too, since the task JSON is the reference's) and artifacts,
  and the reference's whole ``params.json``;
* ``log_suite`` writes the reference's report, comparisons and tags;
* ``TrackingMiddleware`` logs every task a session runs;
* ``EvalRunner.evaluate`` gives the reference's result.
"""

import gzip
import json
import os
import re

import numpy as np

import repro.core as R
import repro_torch.core as P
from repro.core.tracking import RunTracker as JaxTracker
from repro.data import rag_examples

METRICS = (("exact_match", "lexical"), ("contains", "lexical"),
           ("llm_judge", "llm_judge"), ("faithfulness", "rag"))
#: metrics.json entries that read a clock
TIMED = ("throughput_per_min",)


def _task(mod, task_id="track", model="gpt-4o-mini"):
    return mod.EvalTask(
        task_id, model=mod.EngineModelConfig(provider="openai", model_name=model),
        metrics=tuple(mod.MetricConfig(m, type=t) for m, t in METRICS),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200),
    )


def _session(mod, **kw):
    return mod.EvalSession(**({} if mod is R else {"device": "cpu"}), **kw)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_log_run_writes_the_references_files(tmp_path):
    rows = rag_examples(24, seed=3)
    dirs = {}
    for mod, tracker_cls in ((R, JaxTracker), (P, P.RunTracker)):
        task = _task(mod)
        with _session(mod) as s:
            res = s.run_task(rows, task)
        tracker = tracker_cls(str(tmp_path / mod.__name__))
        run_id = tracker.log_run(task, res, suite="nightly")
        assert tracker.list_runs() == [run_id]
        dirs[mod] = (tracker, run_id, os.path.join(tracker.root, run_id), task)
    (pt, pid, pdir, ptask), (jt, jid, jdir, _) = dirs[P], dirs[R]

    pm, jm = pt.load_metrics(pid), jt.load_metrics(jid)
    assert pm.keys() == jm.keys()
    assert sorted(k for k in pm if k.startswith("time_")) == [
        "time_infer_s", "time_metrics_s", "time_prepare_s", "time_stats_s"]
    untimed = [k for k in pm if not k.startswith("time_") and k not in TIMED]
    np.testing.assert_array_equal([pm[k] for k in untimed], [jm[k] for k in untimed])

    ptags, jtags = pt.load_tags(pid), jt.load_tags(jid)
    assert ptags.pop("fingerprint") == ptask.fingerprint() == jtags.pop("fingerprint")
    assert ptags.pop("timestamp")[:4] == jtags.pop("timestamp")[:4]
    assert ptags == jtags == {"model": "gpt-4o-mini", "provider": "openai",
                              "task_id": "track", "suite": "nightly"}

    mine, theirs = (_read(os.path.join(pdir, "params.json")),
                    _read(os.path.join(jdir, "params.json")))
    assert mine == theirs
    assert {"model", "inference", "metrics", "statistics", "data", "streaming",
            "stopping"} <= mine.keys()
    assert {"use_service", "n_workers", "max_retries", "rate_limit_rpm"} <= mine["inference"].keys()

    assert _read(os.path.join(pdir, "artifacts", "run_stats.json")) == _read(
        os.path.join(jdir, "artifacts", "run_stats.json"))
    lines = {}
    for mod, d in ((P, pdir), (R, jdir)):
        with gzip.open(os.path.join(d, "artifacts", "results.jsonl.gz"), "rt") as f:
            lines[mod] = [json.loads(line) for line in f]
    assert lines[P] == lines[R] and len(lines[P]) == len(rows)


def _suite(mod):
    models = [mod.EngineModelConfig(provider="openai", model_name=m)
              for m in ("gpt-4o", "gpt-3.5-turbo")]
    return (mod.EvalSuite("tracked")
            .add_task(_task(mod, "rag"), rag_examples(30, seed=4))
            .sweep_models(models))


def test_log_suite_writes_the_references_files(tmp_path):
    dirs = {}
    for mod, tracker_cls in ((R, JaxTracker), (P, P.RunTracker)):
        with _session(mod) as s:
            res = s.run_suite(_suite(mod))
        tracker = tracker_cls(str(tmp_path / mod.__name__))
        sid = tracker.log_suite(res, owner="ci")
        assert sid.startswith("suite-")
        dirs[mod] = (os.path.join(tracker.root, sid), res)
    (pdir, pres), (jdir, _) = dirs[P], dirs[R]
    reports = []
    for d in (pdir, jdir):
        with open(os.path.join(d, "report.md")) as f:
            # the accounting line ends with the session's wall clock
            reports.append(re.sub(r"wall_s=[0-9.e+-]+", "wall_s=*", f.read()))
    assert reports[0] == reports[1] and "wall_s=*" in reports[0]
    assert _read(os.path.join(pdir, "comparisons.json")) == _read(
        os.path.join(jdir, "comparisons.json"))
    ptags, jtags = (_read(os.path.join(d, "tags.json")) for d in (pdir, jdir))
    for tags in (ptags, jtags):
        tags.pop("timestamp")
        tags["accounting"].pop("wall_s")
        tags["accounting"].pop("serving", None)
    assert ptags == jtags and ptags["owner"] == "ci"
    assert len(pres.comparisons["rag"]) == len(METRICS)


def test_tracking_middleware_logs_every_task(tmp_path):
    rows = rag_examples(10, seed=5)
    tracker = P.RunTracker(str(tmp_path / "runs"))
    mw = P.TrackingMiddleware(tracker, stage="smoke")
    with _session(P, middleware=[mw]) as s:
        s.run_task(rows, _task(P, "a"))
        s.run_task(rows, _task(P, "b").with_streaming(max_memory_rows=4))
    assert sorted(mw.run_ids) == tracker.list_runs() and len(mw.run_ids) == 2
    tags = [tracker.load_tags(r) for r in mw.run_ids]
    assert [t["task_id"] for t in tags] == ["a", "b"]
    assert all(t["stage"] == "smoke" for t in tags)
    assert tracker.load_metrics(mw.run_ids[1])["exact_match_n"] == 10


def test_eval_runner_evaluates_as_the_reference():
    rows = rag_examples(20, seed=6)
    out = {}
    for mod in (R, P):
        judge = mod.engines.SimulatedAPIEngine(
            mod.EngineModelConfig(provider="google", model_name="gemini-1.5-flash"))
        runner = (mod.EvalRunner(judge_engine=judge) if mod is R
                  else mod.EvalRunner(judge_engine=judge, device="cpu"))
        out[mod] = (runner.evaluate(rows, _task(mod)), runner.evaluate(rows, _task(mod)))
    for p, j in zip(out[P], out[R]):
        assert p.responses == j.responses and p.engine_stats == j.engine_stats
        assert p.cache_stats == j.cache_stats == {}
        for name, jm in j.metrics.items():
            pm = p.metrics[name]
            np.testing.assert_array_equal([pm.value, *pm.ci, pm.n], [jm.value, *jm.ci, jm.n])
            np.testing.assert_array_equal(p.scores[name], j.scores[name])
    # each evaluate opens a fresh session: the second run calls the engine again
    assert out[P][1].engine_stats["calls"] == len(rows)
