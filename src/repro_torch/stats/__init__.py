from repro_torch.kernels.bootstrap.ops import bootstrap_ci
from repro_torch.stats.bootstrap import (
    Interval,
    bca_bootstrap,
    compute_ci,
    percentile_bootstrap,
    replicate_p_value,
    t_interval,
    wilson_interval,
)
from repro_torch.stats.streaming import (
    BootstrapEngine,
    DeviceBootstrapEngine,
    MetricAccumulator,
    NumpyBootstrapEngine,
    PoissonBootstrap,
    StreamingStats,
    make_bootstrap_engine,
    streaming_ci,
)

__all__ = [
    "BootstrapEngine",
    "DeviceBootstrapEngine",
    "Interval",
    "MetricAccumulator",
    "NumpyBootstrapEngine",
    "PoissonBootstrap",
    "StreamingStats",
    "bca_bootstrap",
    "bootstrap_ci",
    "compute_ci",
    "make_bootstrap_engine",
    "percentile_bootstrap",
    "replicate_p_value",
    "streaming_ci",
    "t_interval",
    "wilson_interval",
]
