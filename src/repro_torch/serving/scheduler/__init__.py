"""Engine step loop (``scheduler.py``); eager mode in this slice."""
from repro_torch.serving.scheduler.scheduler import ChunkedScheduler

__all__ = ["ChunkedScheduler"]
