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
from repro_torch.core.stages import (
    AggregateStage,
    EvalArtifact,
    EvalResult,
    InferStage,
    MetricValue,
    PrepareStage,
    ScoreStage,
    default_stages,
)
from repro_torch.core.streaming import StreamingPipeline

__all__ = [
    "AggregateStage",
    "DataConfig",
    "EngineModelConfig",
    "EvalArtifact",
    "EvalResult",
    "EvalSession",
    "EvalTask",
    "InferStage",
    "InferenceConfig",
    "InferenceRequest",
    "InferenceResponse",
    "MetricConfig",
    "MetricValue",
    "PrepareStage",
    "ScoreStage",
    "StatisticsConfig",
    "StreamingConfig",
    "StreamingPipeline",
    "TorchLocalEngine",
    "default_stages",
]
