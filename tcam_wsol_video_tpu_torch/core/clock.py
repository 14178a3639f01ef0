"""The program's spans and counters, and spans of device work.

TRACE is the process's recorder (one a process, as the profiler is):
- `TRACE.span(name)`, a context manager (or `TRACE.wrap(name)`, a
  decorator), records a stretch of host work: its name, its start and end
  on the host clock (time.perf_counter_ns), its parent (the span open
  around it) and the step identifier the trainer set (`TRACE.step`, (epoch,
  step index)), which the spans of one step share.  Spans nest on one
  thread: the program opens them on its main thread only, and never
  across a generator's yield.
- `TRACE.count(name, n)` adds to a counter.
- `TRACE.tally(name, n)` adds an integer tensor's sum to a counter kept on
  its device, without reading it (a CUDA graph captures the add, and each
  replay adds again); `TRACE.fetch()`, inside the wait for the device that
  ends an epoch, enqueues its copy to the host, and the next take() counts
  what it gained, under the counters, in every epoch that added to it.
- `TRACE.device(name, ms)` takes spans timed on the device's clock
  (SpanClock below), read at a sync the program makes anyway.
- `TRACE.take()` aggregates what was recorded into {name: [count, ms,
  self ms]} (self ms: the span's time less what its child spans cover)
  and the counters, and clears both.  The trainer takes them at each
  epoch's end (engine/trainer.py).

Off the profiler a span costs two host clock reads and one append: it
synchronizes nothing, makes no CUDA event, allocates nothing on the
device, starts no thread and writes no file.  While a torch.profiler is
active (the profiler's own enabled flag, read at each span's start) a span
also opens a record_function range of its name, so the profiler's trace
holds the program's spans, nested as they ran, on the clock of the
kernels.

SpanClock: spans of device work without a host sync: CUDA events recorded
at the start and end of each span on the card and read at the end (the
first read synchronizes), the host clock on the CPU.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


class Span:
    """One recorded span; the context manager that records it."""

    __slots__ = ("name", "start", "end", "child", "parent", "step", "_rec",
                 "_range")

    def __init__(self, rec: "Recorder", name: str):
        self.name = name
        self._rec = rec

    def __enter__(self) -> "Span":
        rec = self._rec
        self.parent = rec._open[-1] if rec._open else None
        self.step = rec.step
        self.child = 0
        self.end = 0
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        rec._open.append(self)
        rec.spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        self._rec._open.pop()
        if self.parent is not None:
            self.parent.child += self.end - self.start
        if self._range is not None:
            self._range.__exit__(*exc)

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def self_ms(self) -> float:
        return (self.end - self.start - self.child) * 1e-6


class Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        # (epoch, step index) of the spans opened from now on; None
        # outside the steps
        self.step: Optional[Tuple[int, Optional[int]]] = None
        self._open: List[Span] = []
        self._device: List[Tuple[str, List[float]]] = []
        # device counters: name -> [sum on the device, its host copy,
        # the value the last take() read]
        self._tallies: Dict[str, list] = {}

    def span(self, name: str) -> Span:
        return Span(self, name)

    def wrap(self, name: str):
        """A decorator: each call of the function is a span `name`."""
        def deco(fn):
            @functools.wraps(fn)
            def traced(*a, **k):
                with Span(self, name):
                    return fn(*a, **k)
            return traced
        return deco

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def tally(self, name: str, n: torch.Tensor) -> None:
        """Adds the sum of `n`, an integer or boolean tensor, to the device
        counter `name`, on n's device and without reading it.  The counter
        is made at its first add, which must not be under a capture."""
        t = self._tallies.get(name)
        if t is None:
            if n.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"device counter {name!r} made under a "
                                   "CUDA graph capture")
            t = self._tallies[name] = [
                torch.zeros((), dtype=torch.int64, device=n.device),
                torch.zeros((), dtype=torch.int64, pin_memory=n.is_cuda), 0]
        t[0].add_(n.sum())
        self.counts.setdefault(name, 0)

    def fetch(self) -> None:
        """Enqueues each device counter's copy to the host; the wait for the
        device that follows makes it readable to take()."""
        for acc, host, _ in self._tallies.values():
            if acc.is_cuda:
                host.copy_(acc, non_blocking=True)

    def counters(self) -> tuple:
        """The counters as they stand, for rewind(): the host counts and
        a device copy of each device counter."""
        return dict(self.counts), {k: t[0].clone()
                                   for k, t in self._tallies.items()}

    def rewind(self, saved: tuple) -> None:
        """The counters put back as counters() saw them (device counters
        made since, to zero)."""
        counts, tallies = saved
        self.counts.clear()
        self.counts.update(counts)
        for name, t in self._tallies.items():
            if name in tallies:
                t[0].copy_(tallies[name])
            else:
                t[0].zero_()

    def device(self, name: str, ms: List[float]) -> None:
        """Spans of `name` timed on the device's clock (their self ms is
        their ms)."""
        self._device.append((name, ms))

    def take(self) -> Tuple[Dict[str, List[float]], Dict[str, int]]:
        """({name: [count, ms, self ms]} of the closed spans and the
        device spans, the counters: a device counter added to since the
        last take() with its gain up to the last fetch()); clears them.
        Open spans stay."""
        spans: Dict[str, List[float]] = {}
        still_open = []
        for s in self.spans:
            if not s.end:
                still_open.append(s)
                continue
            agg = spans.setdefault(s.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += s.ms
            agg[2] += s.self_ms
        for name, ms in self._device:
            agg = spans.setdefault(name, [0, 0.0, 0.0])
            agg[0] += len(ms)
            agg[1] += sum(ms)
            agg[2] += sum(ms)
        counts = self.counts
        for name, t in self._tallies.items():
            if name in counts:
                value = int(t[1] if t[0].is_cuda else t[0])
                counts[name] += value - t[2]
                t[2] = value
        self.spans, self.counts, self._device = still_open, {}, []
        return spans, counts


TRACE = Recorder()


class SpanClock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, begin) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((begin, e))
        else:
            self.marks.append((begin, time.perf_counter()))

    def millis(self) -> List[float]:
        """ms of each span, in order (on the card, after a sync when any
        span was recorded)."""
        if self.cuda:
            if self.marks:
                torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]

    def gaps(self) -> List[float]:
        """ms from each span's end to the next one's start, from the same
        marks, after millis(): on the card the stream's time between two
        spans (idle, or the work enqueued between them)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [end.elapsed_time(nxt) for (_, end), (nxt, _) in pairs]
        return [(nxt - end) * 1e3 for (_, end), (nxt, _) in pairs]
