from repro_torch.serving.api import (FINISH_ABORT, FINISH_EOS, FINISH_LENGTH,
                                     FINISH_STOP, RequestOutput,
                                     SamplingParams, SharedContext,
                                     UnknownModelError)
from repro_torch.serving.autoscale import (AutoscaleConfig, AutoscaleSignals,
                                           Autoscaler, ResizeDecision)
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.decode import FusedDecodePlane, StackedDecoders
from repro_torch.serving.engine import LocalDisaggEngine
from repro_torch.serving.registry import (DecodeModelSpec, LoRAAdapter,
                                          ModelRegistry)

__all__ = [
    "FINISH_ABORT", "FINISH_EOS", "FINISH_LENGTH", "FINISH_STOP",
    "RequestOutput", "SamplingParams", "SharedContext", "UnknownModelError",
    "AutoscaleConfig", "AutoscaleSignals", "Autoscaler", "ResizeDecision",
    "CostModel", "FusedDecodePlane", "StackedDecoders", "LocalDisaggEngine",
    "DecodeModelSpec", "LoRAAdapter", "ModelRegistry",
]
