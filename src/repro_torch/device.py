"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. There is no fallback to the CPU: a caller
    that wants the CPU passes ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def synchronize(device: torch.device) -> None:
    """Wait for the card, so host clocks around device work measure it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
