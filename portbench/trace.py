"""The device trace of a traced call: ``torch.profiler`` over the call,
reduced to the device's busy time (the union of its activity intervals;
``chip_smoke.py``'s ``_trace_events``), the device time by kernel name,
and the idle gaps between device activities by the host operation that
was running when each gap began.  The profiler slows the host, so an idle
share read from it is the traced run's."""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch


def _events(prof):
    """Device intervals, device time by name ``{name: ns}``, and host
    events ``(thread, start, end, name)``."""
    ivs, by_name, host = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((e.start_thread_id(), start, end, e.name()))
            continue
        # A host annotation mirrored on the device timeline is no device
        # activity.
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        ivs.append((start, end))
        by_name[e.name()] = by_name.get(e.name(), 0) + end - start
    return ivs, by_name, host


def union(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals, as disjoint sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps_by_host(busy: List[Tuple[int, int]], host, top: int = 10
                 ) -> List[Tuple[str, float]]:
    """Idle time between device activities, summed by the innermost host
    operation of the launching thread open at each gap's start (``idle``
    where none is), longest first."""
    if not host:
        return []
    counts: Dict[int, int] = {}
    for tid, *_ in host:
        counts[tid] = counts.get(tid, 0) + 1
    main = max(counts, key=counts.get)
    evs = sorted((s, -e, name) for tid, s, e, name in host if tid == main)
    starts = [s for s, _, _ in evs]
    by: Dict[str, int] = {}
    stack: List[Tuple[int, str]] = []
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gap = b - a
        j_end = bisect.bisect_right(starts, a, lo=j)
        for s, neg_e, name in evs[j:j_end]:
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_e, name))
        j = j_end
        while stack and stack[-1][0] <= a:
            stack.pop()
        name = stack[-1][1] if stack else "idle"
        by[name] = by.get(name, 0) + gap
    return [(k, v / 1e9) for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:top]]


def traced(fn: Callable[[], object], sync: Callable[[], None]):
    """Run ``fn`` under the profiler; return its result and the trace's
    summary: ``busy_s``, ``window_s`` (the call's wall, ending in a
    device synchronisation), ``device_ops`` and ``idle_gaps`` (the ten
    largest of each, in seconds)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    ivs, by_name, host = _events(prof)
    busy = union(ivs)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return out, {"busy_s": sum(b - a for a, b in busy) / 1e9,
                 "window_s": window,
                 "device_ops": [[k, v / 1e9] for k, v in ops],
                 "idle_gaps": [list(g) for g in gaps_by_host(busy, host)]}
