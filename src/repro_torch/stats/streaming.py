"""Mergeable streaming statistics for chunked evaluation (the port of
``repro/stats/streaming.py``).

* :class:`MetricAccumulator` — count / sum / sum-of-squares moments plus a
  NaN (unscorable) counter; mergeable, and enough for the mean and the
  analytical intervals.
* :class:`PoissonBootstrap` — B replicate ``(sum w*x, sum w)`` pairs under
  Poisson(1) resampling weights, and their percentile interval.
* The bootstrap engines (``StatisticsConfig.backend``) hold the replicate
  state of every metric of a task, fed one chunk at a time:

  - :class:`NumpyBootstrapEngine` (``"numpy"``, the default, as in the
    reference): host ``Philox(seed, chunk_start)`` weight blocks, one
    (B, chunk) draw masked per metric — the reference's engine bit for bit;
  - :class:`DeviceBootstrapEngine` (``"device"``; ``"pallas"`` is the
    reference's name for the same weight stream): the bootstrap-partials
    kernel on the card (its plain version on the CPU), weights keyed by
    ``(seed, absolute example position, replicate)``, one launch a chunk
    for every metric.

The two engines draw different weight streams, and the kernel and its plain
version share the weights but sum in different orders, so an engine
records which stream it holds (``stream_id``) and refuses to merge state
from another; :meth:`StreamingStats.comparable_with` refuses to pair two
runs' replicates across streams for the same reason.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bootstrap.ops import bootstrap_partials, partials_path
from repro_torch.stats.bootstrap import Interval, wilson_interval
from repro_torch.stats.special import t_ppf


class MetricAccumulator:
    """Mergeable moment accumulator for one metric's per-example scores."""

    def __init__(self) -> None:
        self.n = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.n_nan = 0

    def update(self, scores: np.ndarray) -> None:
        scores = np.asarray(scores, np.float64)
        ok = scores[~np.isnan(scores)]
        self.n += int(ok.size)
        self.total += float(ok.sum())
        self.total_sq += float((ok * ok).sum())
        self.n_nan += int(scores.size - ok.size)

    def merge(self, other: "MetricAccumulator") -> "MetricAccumulator":
        self.n += other.n
        self.total += other.total
        self.total_sq += other.total_sq
        self.n_nan += other.n_nan
        return self

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    @property
    def variance(self) -> float:
        """Unbiased (ddof=1) variance from the accumulated moments."""
        if self.n < 2:
            return 0.0
        var = (self.total_sq - self.total * self.total / self.n) / (self.n - 1)
        return max(var, 0.0)  # clamp catastrophic-cancellation dust


class PoissonBootstrap:
    """One metric's B bootstrap replicates as ``(sum w*x, sum w)`` pairs."""

    def __init__(self, n_boot: int = 1000, seed: int = 0):
        self.n_boot = int(n_boot)
        self.seed = int(seed)
        self.sum_wx = np.zeros(self.n_boot, np.float64)
        self.sum_w = np.zeros(self.n_boot, np.float64)

    def means(self) -> np.ndarray:
        return self.sum_wx / np.maximum(self.sum_w, 1.0)

    def interval(self, value: float, n: int, *, confidence: float = 0.95) -> Interval:
        alpha = (1 - confidence) / 2
        lo, hi = np.quantile(self.means(), [alpha, 1 - alpha])
        return Interval(value, float(lo), float(hi), "poisson", n)


class BootstrapEngine:
    """Mergeable multi-metric Poisson-bootstrap replicate state; subclasses
    decide where the weights come from and how ``update`` runs."""

    backend = ""

    def __init__(self, n_boot: int, seed: int, metrics: tuple[str, ...]):
        self.n_boot = int(n_boot)
        self.seed = int(seed)
        self.metrics = tuple(metrics)
        self.sum_wx = np.zeros((self.n_boot, len(self.metrics)), np.float64)
        self.sum_w = np.zeros((self.n_boot, len(self.metrics)), np.float64)

    def update(self, scores: dict[str, np.ndarray], start: int) -> None:
        raise NotImplementedError

    def stream_id(self) -> str:
        """Names the exact float-accumulation variant of the weight stream;
        partials merge only within one stream."""
        return self.backend

    def spawn(self) -> "BootstrapEngine":
        """A zero-state engine with this one's configuration."""
        return type(self)(self.n_boot, self.seed, self.metrics)

    def merge(self, other: "BootstrapEngine") -> "BootstrapEngine":
        ours = (self.stream_id(), self.n_boot, self.seed, self.metrics)
        theirs = (other.stream_id(), other.n_boot, other.seed, other.metrics)
        if ours != theirs:
            raise ValueError(f"cannot merge bootstrap states: {ours} != {theirs}")
        self.sum_wx += other.sum_wx
        self.sum_w += other.sum_w
        return self

    def view(self, metric: str) -> PoissonBootstrap:
        """One metric's replicate state as a :class:`PoissonBootstrap`."""
        j = self.metrics.index(metric)
        boot = PoissonBootstrap(self.n_boot, self.seed)
        boot.sum_wx = self.sum_wx[:, j].copy()
        boot.sum_w = self.sum_w[:, j].copy()
        return boot


class NumpyBootstrapEngine(BootstrapEngine):
    """Host backend: ``Philox(seed, chunk_start)`` weight blocks.  Every
    metric uses the same key, so the (B, chunk) block is drawn once and
    masked per metric, as the reference's engine does."""

    backend = "numpy"

    def update(self, scores: dict[str, np.ndarray], start: int) -> None:
        chunk = np.asarray(scores[self.metrics[0]], np.float64).size
        if chunk == 0:
            return
        rng = np.random.Generator(np.random.Philox(key=[self.seed, start]))
        w = rng.poisson(1.0, (self.n_boot, chunk)).astype(np.float64)
        for j, m in enumerate(self.metrics):
            x = np.asarray(scores[m], np.float64)
            valid = ~np.isnan(x)
            wm = w * valid[None, :]
            self.sum_wx[:, j] += wm @ np.where(valid, x, 0.0)
            self.sum_w[:, j] += wm.sum(axis=1)


class DeviceBootstrapEngine(BootstrapEngine):
    """One bootstrap-partials launch per chunk covers every metric: the
    chunk's (n, m) score matrix goes to ``device`` and the (B, m) f32 pair
    comes back, accumulated in f64 on the host."""

    backend = "device"

    def __init__(
        self,
        n_boot: int,
        seed: int,
        metrics: tuple[str, ...],
        *,
        device: torch.device,
    ):
        super().__init__(n_boot, seed, metrics)
        self.device = torch.device(device)

    def stream_id(self) -> str:
        return f"device-{partials_path(self.device)}"

    def spawn(self) -> "DeviceBootstrapEngine":
        return DeviceBootstrapEngine(
            self.n_boot, self.seed, self.metrics, device=self.device
        )

    def update(self, scores: dict[str, np.ndarray], start: int) -> None:
        mat = np.stack(
            [np.asarray(scores[m], np.float32) for m in self.metrics], axis=1
        )
        if mat.shape[0] == 0:
            return
        x = torch.from_numpy(mat).to(self.device)
        swx, sw = bootstrap_partials(x, self.seed, start, n_boot=self.n_boot)
        self.sum_wx += swx.cpu().numpy().astype(np.float64)
        self.sum_w += sw.cpu().numpy().astype(np.float64)


#: backend name -> engine; "pallas" is the reference's name for the weight
#: stream that the device engine draws
_ENGINES = {
    "numpy": NumpyBootstrapEngine,
    "device": DeviceBootstrapEngine,
    "pallas": DeviceBootstrapEngine,
}


def make_bootstrap_engine(
    backend: str,
    n_boot: int,
    seed: int,
    metrics: tuple[str, ...],
    *,
    device: torch.device | str | None = None,
) -> BootstrapEngine:
    """``device`` is where the device engine launches (the session's; the
    card when None); the numpy engine runs on the host whatever it is."""
    if backend not in _ENGINES:
        raise ValueError(
            f"unknown statistics backend {backend!r}; "
            f"available: {sorted(_ENGINES)}"
        )
    if _ENGINES[backend] is DeviceBootstrapEngine:
        return DeviceBootstrapEngine(
            n_boot, seed, metrics, device=resolve_device(device)
        )
    return NumpyBootstrapEngine(n_boot, seed, metrics)


@dataclasses.dataclass
class StreamingStats:
    """A streaming run's aggregate statistical state, carried on the result
    in place of per-example scores.  ``engine`` is ``None`` under
    ``ci_method="analytical"``, which keeps no replicate state."""

    accs: dict[str, MetricAccumulator]
    engine: BootstrapEngine | None
    chunk_size: int
    n_examples: int

    def comparable_with(self, other: "StreamingStats") -> str | None:
        """None when paired replicate deltas are valid (the same weight
        stream, B, seed and chunk layout), else the reason they are not."""
        if self.engine is None or other.engine is None:
            return (
                "no bootstrap replicate state (analytical ci_method); "
                "use a bootstrap ci_method to enable paired comparisons"
            )
        a, b = self.engine, other.engine
        if (a.stream_id(), a.n_boot, a.seed) != (
            b.stream_id(), b.n_boot, b.seed
        ):
            return (
                f"bootstrap streams differ: "
                f"({a.stream_id()}, B={a.n_boot}, seed={a.seed}) vs "
                f"({b.stream_id()}, B={b.n_boot}, seed={b.seed})"
            )
        if (self.chunk_size, self.n_examples) != (
            other.chunk_size, other.n_examples
        ):
            return (
                f"chunk layouts differ: "
                f"(chunk={self.chunk_size}, n={self.n_examples}) vs "
                f"(chunk={other.chunk_size}, n={other.n_examples})"
            )
        return None


def streaming_ci(
    acc: MetricAccumulator,
    boot: PoissonBootstrap | None,
    *,
    method: str = "bca",
    confidence: float = 0.95,
    binary: bool = False,
) -> Interval:
    """A metric's interval from its streaming state.  ``analytical`` is
    exact from the moments (Wilson for binary metrics, t otherwise); the
    bootstrap methods (``percentile`` and ``bca``) both give the
    Poisson-bootstrap percentile interval, as the reference's do."""
    if acc.n == 0:
        return Interval(float("nan"), float("nan"), float("nan"), "none", 0)
    if method == "analytical":
        if binary:
            return wilson_interval(
                int(round(acc.total)), acc.n, confidence=confidence
            )
        se = math.sqrt(acc.variance / acc.n) if acc.n > 1 else 0.0
        tcrit = t_ppf(1 - (1 - confidence) / 2, acc.n - 1) if acc.n > 1 else 0.0
        return Interval(
            acc.mean, acc.mean - tcrit * se, acc.mean + tcrit * se, "t", acc.n
        )
    if method not in ("percentile", "bca"):
        raise ValueError(f"unknown ci method {method!r}")
    if boot is None:
        raise ValueError(f"ci method {method!r} needs a PoissonBootstrap")
    return boot.interval(acc.mean, acc.n, confidence=confidence)
