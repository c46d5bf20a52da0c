"""The program's own spans and counters in the traced window, placed on the
window's device clock. Shared by the readers ``nms_rounds``,
``host_work_ms_p50``, ``merge_idle_ms`` and ``forward_idle_ms``.

The program records its spans in ``facedet_tpu_torch.utils.profiling.SPANS``,
a ring of the last closed spans, each with a name, a request id, a parent
span, a thread, ``perf_counter_ns`` start and end, and counters. A program
without that recorder gives no window, and every reader then returns None.

A request is every span that carries its id, on any thread: the single-image
path nests its stages under one root span named ``request``, and the stream
paths give one id to roots on several threads (``stage``, ``upload``,
``enqueue``, ``fetch_wait``). Each root records whether a profiler was
recording it. The traced window's requests are the last ``trace_requests``
requests recorded under a profiler: ``trace.py`` retakes a window by running
its requests anew, so the last ones are those of the window it kept. The same
requests run untraced just before (``run.py``) are the last
``trace_requests`` recorded under none, and the host's own time is read from
them, since the profiler stretches it.

The clock: ``_Fetch.result`` waits for each request's result in a
``fetch_wait`` span around one ``cudaEventSynchronize``, which the trace's
runtime records hold too. The window's ``fetch_wait`` spans are paired in
order with its ``cudaEventSynchronize`` records; the offset between the two
clocks is the median of their end-minus-end differences, and its error the
largest residual. Where the counts differ or the error exceeds
``MAX_ERROR_S``, there is no clock, and the readers that need one return
None rather than a guess.

Device-idle time is the union of the trace's device operations taken from
the interval of the window's requests: each gap is split over the innermost
spans whose self time (the span less its children) it meets, equally where
spans of several threads meet it at once. Idle time inside no span is
outside the program (the benchmark's own loop between requests).
"""
from __future__ import annotations

import collections
import statistics

SYNC = "cudaEventSynchronize"
MAX_ERROR_S = 50e-6
HOST_WAITS = ("readback", "fetch_wait", "enhance")


def recorder():
    """The program's span recorder, or None for a program without one."""
    from facedet_tpu_torch.utils import profiling

    return getattr(profiling, "SPANS", None)


def window(ctx, profiled: bool = True):
    """The requests of the cell's window, each the list of its spans, oldest
    request first: the last ``trace_requests`` recorded under a profiler
    (``profiled``), or under none (the same requests untraced). None where
    the program records no spans or fewer such requests than the window
    ran."""
    rec = recorder()
    if rec is None:
        return None
    by_id = collections.defaultdict(list)
    for s in rec.spans():
        by_id[s.request].append(s)
    n = ctx.cell.spec["trace_requests"]
    picked = [members for _, members in sorted(by_id.items())
              if any(s.parent is None for s in members)
              and any(bool(s.profiled) for s in members if s.parent is None) == profiled][-n:]
    return picked if picked and len(picked) == n else None


def ancestors(span):
    """The span and its parents, innermost first."""
    while span is not None:
        yield span
        span = span.parent


def outermost(spans, names):
    """The spans named in ``names`` that have no parent named in them."""
    return [s for s in spans if s.name in names and not any(p.name in names for p in ancestors(s.parent))]


def counter(requests, name: str) -> int:
    return sum(s.counts.get(name, 0) for members in requests for s in members if s.counts)


def host_ms(requests) -> list:
    """Per request, the ms of its root spans less those of its spans where
    the host waits for the device (``HOST_WAITS``): each such wait lies in
    the root it descends from, and a wait that is a root (the stream's
    ``fetch_wait``) takes away its own length."""
    out = []
    for members in requests:
        roots = sum(s.end_ns - s.start_ns for s in members if s.parent is None)
        waits = sum(s.end_ns - s.start_ns for s in outermost(members, HOST_WAITS))
        out.append((roots - waits) / 1e6)
    return out


def clock(trace, members):
    """(offset, error) in seconds, with trace time = ``perf_counter_ns`` /
    1e9 - offset; None where the anchors do not pair or the error exceeds
    ``MAX_ERROR_S``."""
    waits = sorted(s.end_ns for s in members if s.name == "fetch_wait")
    syncs = sorted(e for name, _, e in trace.runtime if name == SYNC)
    if not waits or len(waits) != len(syncs):
        return None
    diffs = [w / 1e9 - e for w, e in zip(waits, syncs)]
    offset = statistics.median(diffs)
    error = max(abs(d - offset) for d in diffs)
    return (offset, error) if error <= MAX_ERROR_S else None


def self_segments(members, offset: float) -> list:
    """(start, end, span) of every stretch of each span's self time, on the
    trace's clock."""
    children = collections.defaultdict(list)
    for s in members:
        if s.parent is not None:
            children[id(s.parent)].append(s)
    segments = []
    for s in members:
        t = s.start_ns / 1e9 - offset
        for c in sorted(children[id(s)], key=lambda c: c.start_ns):
            if c.start_ns / 1e9 - offset > t:
                segments.append((t, c.start_ns / 1e9 - offset, s))
            t = max(t, c.end_ns / 1e9 - offset)
        if s.end_ns / 1e9 - offset > t:
            segments.append((t, s.end_ns / 1e9 - offset, s))
    return segments


def idle_gaps(ops, start: float, end: float) -> list:
    """(start, end) of the stretches of [start, end] that no device
    operation covers."""
    gaps, t = [], start
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if end > t:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def split_idle(gaps, segments) -> tuple[dict, float]:
    """({id(span): (span, idle seconds of its self time)}, idle seconds
    inside no span): a sweep over the gaps and the self-time stretches."""
    points = []
    for i, (s, e, _) in enumerate(segments):
        points += [(s, 1, i), (e, -1, i)]
    for s, e in gaps:
        points += [(s, 2, None), (e, -2, None)]
    points.sort(key=lambda p: (p[0], p[1] < 0))
    active, in_gap, last = set(), 0, None
    idle: dict = {}
    outside = 0.0
    for t, kind, i in points:
        if in_gap and last is not None and t > last:
            dt = t - last
            if active:
                for j in active:
                    span = segments[j][2]
                    prev = idle.get(id(span), (span, 0.0))[1]
                    idle[id(span)] = (span, prev + dt / len(active))
            else:
                outside += dt
        last = t
        if kind == 1:
            active.add(i)
        elif kind == -1:
            active.discard(i)
        else:
            in_gap += 1 if kind == 2 else -1
    return idle, outside


def device_idle(ctx):
    """The traced window's device-idle time split over the program's spans:
    a dict with ``idle`` ({id(span): (span, seconds)}), ``outside``
    (seconds in no span), ``error`` (the clock's, seconds); or None without
    spans, a trace or a clock."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    requests = window(ctx)
    if requests is None:
        return None
    members = [s for m in requests for s in m]
    found = clock(ctx.trace, members)
    if found is None:
        return None
    offset, error = found
    start = min(s.start_ns for s in members) / 1e9 - offset
    end = max(s.end_ns for s in members) / 1e9 - offset
    idle, outside = split_idle(idle_gaps(ctx.trace.ops, start, end), self_segments(members, offset))
    return {"idle": idle, "outside": outside, "error": error}


def idle_ms_per_image(ctx, inside, leave_out=()):
    """Device-idle ms per image in the self time of spans that lie under a
    span named in ``inside`` and under none named in ``leave_out``."""
    split = device_idle(ctx)
    if split is None or not ctx.images:
        return None
    total = 0.0
    for span, seconds in split["idle"].values():
        names = [p.name for p in ancestors(span)]
        if any(n in inside for n in names) and not any(n in leave_out for n in names):
            total += seconds
    return 1e3 * total / ctx.images


def stage_path(span) -> str:
    """``request/forward.tiles/nms/readback``: the span's names from its root."""
    return "/".join(reversed([p.name for p in ancestors(span)]))


def report(ctx) -> dict:
    """What ``stages.py`` prints of a traced window: device-idle ms per
    request by stage path (``stages_ms``), idle ms per request inside no
    span (``outside_ms``) and the share inside spans, the clock's error in
    us, spans per request, fixpoint rounds and calls per request by the span
    that holds the ``nms`` span, and the median host ms of a request
    (``host_work_ms_p50``'s reading) untraced and traced. Each part that
    cannot be read is None."""
    out = {"stages_ms": None, "outside_ms": None, "share_inside": None, "clock_error_us": None}
    split = device_idle(ctx)
    n = ctx.cell.spec["trace_requests"]
    if split is not None:
        stages = collections.Counter()
        for span, seconds in split["idle"].values():
            stages[stage_path(span)] += 1e3 * seconds / n
        inside = sum(stages.values())
        outside = 1e3 * split["outside"] / n
        out.update(stages_ms=dict(stages.most_common()), outside_ms=outside,
                   share_inside=inside / (inside + outside) if inside + outside else None,
                   clock_error_us=1e6 * split["error"])
    traced, plain = window(ctx), window(ctx, profiled=False)
    out["spans_per_request"] = sum(map(len, traced)) / n if traced else None
    rounds = collections.defaultdict(list)
    for s in (s for m in traced or () for s in m if s.name == "nms"):
        rounds[s.parent.name if s.parent else None].append(s.counts.get("nms_rounds", 0) if s.counts else 0)
    out["nms_by_site"] = {site: {"rounds_per_call": statistics.mean(v), "calls_per_request": len(v) / n}
                          for site, v in rounds.items()}
    out["host_ms_p50"] = {k: statistics.median(host_ms(w)) if w else None
                          for k, w in (("untraced", plain), ("traced", traced))}
    return out
