from repro_torch.core.config import (
    DataConfig,
    EngineModelConfig,
    EvalTask,
    InferenceConfig,
    MetricConfig,
    StatisticsConfig,
    StreamingConfig,
)
from repro_torch.core.engines import (
    InferenceRequest,
    InferenceResponse,
    TorchLocalEngine,
)
from repro_torch.core.session import EvalSession
from repro_torch.core.stages import EvalResult, MetricValue
from repro_torch.core.streaming import StreamingPipeline

__all__ = [
    "DataConfig",
    "EngineModelConfig",
    "EvalResult",
    "EvalSession",
    "EvalTask",
    "InferenceConfig",
    "InferenceRequest",
    "InferenceResponse",
    "MetricConfig",
    "MetricValue",
    "StatisticsConfig",
    "StreamingConfig",
    "StreamingPipeline",
    "TorchLocalEngine",
]
