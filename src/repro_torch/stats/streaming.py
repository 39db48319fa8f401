"""Mergeable streaming statistics for chunked evaluation (the port of
``repro/stats/streaming.py``).

* :class:`MetricAccumulator` — count / sum / sum-of-squares moments plus a
  NaN (unscorable) counter; mergeable, and enough for the mean and the
  analytical intervals.
* :class:`PoissonBootstrap` — B replicate ``(sum w*x, sum w)`` pairs under
  Poisson(1) resampling weights, and their percentile interval.
* :class:`DeviceBootstrapEngine` (``backend="device"``) — the replicate
  state of every metric of a task, fed one chunk at a time by the
  bootstrap-partials kernel on the card (its plain version on the CPU).
  Weights are keyed by ``(seed, absolute example position, replicate)``, so
  partials are independent of chunk order, and the kernel's weight stream
  is bit-identical to the JAX package's.

The kernel and its plain version share the weights but sum in different
orders, so an engine records which one ran (``stream_id``) and refuses to
merge state from the other, as the JAX engine's ``resolve_partials_mode``
makes it refuse.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

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
        raise NotImplementedError

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


def make_bootstrap_engine(
    backend: str,
    n_boot: int,
    seed: int,
    metrics: tuple[str, ...],
    *,
    device: torch.device,
) -> BootstrapEngine:
    if backend != DeviceBootstrapEngine.backend:
        raise ValueError(
            f"unknown statistics backend {backend!r}; the port has 'device'"
        )
    return DeviceBootstrapEngine(n_boot, seed, metrics, device=device)


@dataclasses.dataclass
class StreamingStats:
    """A streaming run's aggregate statistical state, carried on the result
    in place of per-example scores.  ``engine`` is ``None`` under
    ``ci_method="analytical"``, which keeps no replicate state."""

    accs: dict[str, MetricAccumulator]
    engine: BootstrapEngine | None
    chunk_size: int
    n_examples: int


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
