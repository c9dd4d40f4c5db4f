"""Engine step loop (``scheduler.py``) and admission ordering
(``queue.py``)."""
from repro_torch.serving.scheduler.queue import POLICIES, order_requests
from repro_torch.serving.scheduler.scheduler import (ChunkedScheduler,
                                                     Request, SchedStats,
                                                     SchedulerConfig)

__all__ = ["ChunkedScheduler", "Request", "SchedStats", "SchedulerConfig",
           "POLICIES", "order_requests"]
