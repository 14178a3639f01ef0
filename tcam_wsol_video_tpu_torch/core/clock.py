"""Spans of device work without a host sync: CUDA events recorded at the
start and end of each span on the card and read at the end (the first
read synchronizes), the host clock on the CPU."""
from __future__ import annotations

import time
from typing import List

import torch


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
        """ms of each span, in order."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]
