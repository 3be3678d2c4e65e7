"""Reading a torch.profiler trace of the traced window: device busy time,
device operations by name, and the idle gaps between them, each named by
what the host was doing then."""
from __future__ import annotations

from collections import defaultdict

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10


def profiler():
    """A profiler of the host's operations and the device's."""
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return float(f()) if f is not None else 1e3 * float(
        getattr(e, f"{what}_us")())


class Trace:
    """Events of a finished profiler: device operations [(name, start,
    end)] and host operations [(name, start, end)], in nanoseconds."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + (_ns(e, "duration") if hasattr(e, "duration_ns")
                           else 1e3 * float(e.duration_us()))
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if e.device_type() == DeviceType.CUDA:
                # the harness's spans are mirrored on the device's timeline
                # as annotations: they are not device operations
                if not annotation and not e.name().startswith("bench."):
                    dev.append((e.name(), start, end))
            elif e.device_type() == DeviceType.CPU:
                host.append((e.name(), start, end))
        dev.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        self.dev, self.host = dev, host
        self._merge()

    def _merge(self):
        merged = []
        for _, s, e in self.dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged) / 1e9

    def device_time(self, match) -> float:
        """Seconds of device operations whose name satisfies match."""
        return sum(e - s for n, s, e in self.dev if match(n)) / 1e9

    def device_ops(self):
        """The device operations that took most time: [[name, s]]."""
        tot = defaultdict(float)
        for n, s, e in self.dev:
            tot[n] += (e - s) / 1e9
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:120], v] for n, v in top]

    def idle_gaps(self):
        """The longest gaps between device operations, each named by the
        harness span around it and the host operation that overlaps it
        most: [[name, s]]."""
        gaps = [(self.busy[i + 1][0] - self.busy[i][1], self.busy[i][1],
                 self.busy[i + 1][0]) for i in range(len(self.busy) - 1)]
        gaps.sort(key=lambda g: -g[0])
        starts = np.array([h[1] for h in self.host]) if self.host else \
            np.zeros(0)
        out = []
        for length, s, e in gaps[:TOP]:
            span, best, best_ov = "outside", "host code", 0.0
            hi = int(np.searchsorted(starts, e))
            for name, hs, he in self.host[:hi]:
                ov = min(he, e) - max(hs, s)
                if ov <= 0:
                    continue
                if name.startswith("bench."):
                    span = name[len("bench."):]
                elif ov > best_ov:
                    best, best_ov = name, ov
            out.append([f"{span}: {best}"[:120], length / 1e9])
        return out
