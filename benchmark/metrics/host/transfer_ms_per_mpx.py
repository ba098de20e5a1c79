"""host.transfer_ms_per_mpx: host ms that the port's `sjpeg.upload` and
`sjpeg.fetch` spans own in the traced slice, a megapixel of its requests,
with the card's idle ms inside them.

The four host readers read the spans that the port's `device_trace` kept
from the trace file it wrote (`profiling.trace_spans()`), on the clock of
the slice's device events.  Each instant of a thread belongs to the
innermost span open on it; a span's share of the slice is the time it
owns inside [lo, hi], and its idle part what of that time the busy union
of the card's kernels, copies and memsets leaves.  A program without
spans gives nothing."""

from benchmark import tracing

NAMES = ("sjpeg.upload", "sjpeg.fetch")


def slice_spans(t) -> list:
    """[(start, end, name, tid)] of the spans that overlap [lo, hi]."""
    from sjpeg_tpu_torch.utils import profiling
    kept = getattr(profiling, "trace_spans", None)
    if kept is None:
        return []
    return [(s["ts"], s["ts"] + s["dur"], s["name"], s["tid"])
            for s in kept() if s["ts"] < t.hi and s["ts"] + s["dur"] > t.lo]


def owned(spans) -> list:
    """[(start, end, name)]: each thread's time, each instant given to the
    innermost span open on it.  Spans of one thread nest; a child that
    outlasts its parent by a rounding is cut at the parent's end."""
    pieces = []
    threads = {}
    for start, end, name, tid in spans:
        threads.setdefault(tid, []).append((start, end, name))
    for rows in threads.values():
        stack, t = [], None
        for start, end, name in sorted(rows, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= start:
                t = _close(stack, t, pieces)
            if stack:
                pieces.append((t, start, stack[-1][1]))
                end = min(end, stack[-1][0])
            stack.append((end, name))
            t = start
        while stack:
            t = _close(stack, t, pieces)
    return [p for p in pieces if p[1] > p[0]]


def _close(stack, t, pieces) -> float:
    end, name = stack.pop()
    pieces.append((t, end, name))
    return end


def host_ms(t, names):
    """{"value": ms/Mpx that spans named `names` own in the slice,
    "idle_ms_per_mpx": the card's idle ms inside that time, a megapixel},
    or None when the slice holds no span."""
    spans = slice_spans(t)
    if not spans:
        return None
    busy = tracing.merge_spans((e["ts"], e["ts"] + e["dur"])
                               for e in t.events)
    own = idle = 0.0
    for start, end, name in owned(spans):
        lo, hi = max(start, t.lo), min(end, t.hi)
        if name in names and hi > lo:
            own += hi - lo
            idle += hi - lo - tracing.busy_us(busy, lo, hi)
    return {"value": own / 1e3 / t.mpx, "idle_ms_per_mpx": idle / 1e3 / t.mpx}


def read(t):
    return host_ms(t, NAMES)
