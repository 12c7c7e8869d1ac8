"""The device trace of a traced run: ``torch.profiler`` over the first
requests of the window, reduced to plain lists that the per-layer readers
take.

``torch.profiler`` has been seen to drop the first device records of a
profiling window. So the profiled stretch opens with a separator: a few
spin kernels and a synchronise, and only records after the marker
``gb:window`` opens count. Device records are kernels, copies and
memsets; the profiler's device-side copies of the benchmark's own
annotations (``span:...``, ``gb:...``) are not device work and are left
out.
"""
from __future__ import annotations

import torch

MARK = "gb:window"
SEPARATOR_SPINS = 4


def _is_annotation(name: str) -> bool:
    return name.startswith(("span:", "gb:"))


class DeviceTrace:
    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self._mark = None
        self.stopped = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.device.type == "cuda":
            for _ in range(SEPARATOR_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        self.stopped = True
        self._mark.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """{"ops": [(name, start_us, end_us)] device records in the window,
        "spans": [(label, start_us, end_us)] host annotations,
        "t0_us", "t1_us": the window's bounds}."""
        from torch.autograd import DeviceType
        t0 = t1 = None
        ops, spans = [], []
        for e in self.prof.events():
            name = e.name
            tr = e.time_range
            if e.device_type == DeviceType.CPU:
                if name == MARK:
                    t0, t1 = tr.start, tr.end
                elif name.startswith("span:"):
                    spans.append((name[5:], tr.start, tr.end))
            elif not _is_annotation(name):
                ops.append((name, tr.start, tr.end))
        if t0 is None:
            return {"ops": [], "spans": [], "t0_us": 0.0, "t1_us": 0.0}
        ops = sorted((o for o in ops if t0 <= o[1] <= t1),
                     key=lambda o: o[1])
        spans = sorted((s for s in spans if s[1] >= t0),
                       key=lambda s: s[1])
        t_whole = _first_whole(ops, spans)
        return {"ops": [o for o in ops if o[1] >= t_whole],
                "spans": [s for s in spans if s[1] >= t_whole],
                "t0_us": t_whole, "t1_us": t1,
                "dropped_spans": sum(s[1] < t_whole for s in spans)}


def _first_whole(ops: list, spans: list) -> float:
    """Where the profiler's records are whole: the start of the first
    neighborhood RPC whose device records number the most common count
    (each such RPC launches the same work; the profiler drops a window's
    first records, so RPCs before that one are left out)."""
    import bisect
    starts = [o[1] for o in ops]
    rpcs = [s for s in spans if s[0] == "rpc.query"]
    counts = [bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
              for _, s, e in rpcs]
    if not counts:
        return spans[0][1] if spans else 0.0
    usual = max(set(counts), key=counts.count)
    return next(s for (_, s, _), c in zip(rpcs, counts) if c == usual)
