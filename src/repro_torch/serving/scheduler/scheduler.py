"""The engine's step loop, eager mode.

Port of the eager half of ``repro.serving.scheduler.scheduler``. In eager
mode ``generate`` prefills whole prompts synchronously and hands each
request to decode at once, so nothing ever waits in a queue and a step is:
reap finished sequences (their pages free before anything else happens),
apply deferred model churn at the step boundary, then advance every active
sequence one token. Chunked prefill, with its admission queue, chunk
packing under a token budget and page backpressure, arrives with port
slice 2.
"""
from __future__ import annotations


class ChunkedScheduler:
    """Owns the engine step loop (eager mode in this slice)."""

    def __init__(self, engine):
        self.engine = engine
        self.active: list = []           # DecodeSeqs (engine dataclass)

    def add_decode_seq(self, seq) -> None:
        """Register an already-prefilled sequence (eager submit)."""
        self.active.append(seq)

    def has_work(self) -> bool:
        return bool(self.active)

    def run(self) -> None:
        while self.has_work():
            self.step()

    def step(self) -> None:
        """One engine step: reap finished sequences (EOS/stop/length); apply
        deferred model churn; advance every active sequence one token."""
        self._reap_finished()
        # step boundary: finalize drained unregisters (the reap may have
        # retired a draining model's last sequence) and relayout the fused
        # plane; lane indices are re-derived from the new plane this step
        self.engine.models.sync()
        self._decode_phase()

    def _reap_finished(self) -> int:
        """Retire sequences whose generation is over: length exhausted OR
        ended early by an eos/stop token (``decode_step`` zeroes
        ``remaining``)."""
        still = []
        finished = 0
        for s in self.active:
            if s.remaining > 0:
                still.append(s)
            else:
                self.engine._finish(s)
                finished += 1
        self.active = still
        return finished

    def _decode_phase(self) -> int:
        """Advance every active sequence one token. The engine steps a COPY
        of the active list: stream callbacks fire inside decode_step and may
        re-enter the engine (abort() removes from ``self.active``, an eager
        generate() appends to it)."""
        if not self.active:
            return 0
        stepped = list(self.active)
        self.engine.decode_step(stepped)
        return len(stepped)
