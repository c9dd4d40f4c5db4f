from repro_torch.serving.api import (FINISH_ABORT, FINISH_EOS, FINISH_LENGTH,
                                     FINISH_STOP, RequestOutput,
                                     SamplingParams, SharedContext,
                                     UnknownModelError)
from repro_torch.serving.autoscale import (AutoscaleConfig, AutoscaleSignals,
                                           Autoscaler, ResizeDecision)
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.decode import FusedDecodePlane, StackedDecoders
from repro_torch.serving.engine import LocalDisaggEngine
from repro_torch.serving.metrics import (MetricsRegistry, RequestTrace,
                                         lint_prometheus)
from repro_torch.serving.registry import (DecodeModelSpec, LoRAAdapter,
                                          ModelRegistry)
from repro_torch.serving.simulator import ServingConfig, Simulator
from repro_torch.serving.workload import PATTERNS, Session, make_sessions

__all__ = [
    "FINISH_ABORT", "FINISH_EOS", "FINISH_LENGTH", "FINISH_STOP",
    "RequestOutput", "SamplingParams", "SharedContext", "UnknownModelError",
    "AutoscaleConfig", "AutoscaleSignals", "Autoscaler", "ResizeDecision",
    "CostModel", "FusedDecodePlane", "StackedDecoders", "LocalDisaggEngine",
    "MetricsRegistry", "RequestTrace", "lint_prometheus",
    "DecodeModelSpec", "LoRAAdapter", "ModelRegistry",
    "ServingConfig", "Simulator", "PATTERNS", "Session", "make_sessions",
]
