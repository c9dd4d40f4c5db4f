from repro_torch.serving.api import (FINISH_ABORT, FINISH_EOS, FINISH_LENGTH,
                                     FINISH_STOP, RequestOutput,
                                     SamplingParams, SharedContext,
                                     UnknownModelError)
from repro_torch.serving.decode import FusedDecodePlane, StackedDecoders
from repro_torch.serving.engine import LocalDisaggEngine
from repro_torch.serving.registry import DecodeModelSpec, ModelRegistry

__all__ = [
    "FINISH_ABORT", "FINISH_EOS", "FINISH_LENGTH", "FINISH_STOP",
    "RequestOutput", "SamplingParams", "SharedContext", "UnknownModelError",
    "FusedDecodePlane", "StackedDecoders", "LocalDisaggEngine",
    "DecodeModelSpec", "ModelRegistry",
]
