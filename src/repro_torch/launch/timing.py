"""Device time of the kernels a call launches, from torch.profiler."""
from __future__ import annotations


def device_ms(fn, iters: int = 20, tries: int = 3):
    """Device time per call of the kernels ``fn`` launches, from
    torch.profiler's CUDA activity records: the sum of their durations over
    ``iters`` calls, divided by ``iters``. Unlike back-to-back CUDA events
    it leaves out the gaps in which the card waits for the host to launch,
    which decide event times when a kernel is shorter than its wrapper. A
    trace that comes back without device records (it happens) is taken
    again, up to ``tries`` times; then the result is None, not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA]
        if us:
            return sum(us) / iters / 1e3
    return None
