"""Arithmetic over a torch.profiler Chrome trace: the busy union of the
device's kernel, memcpy and memset intervals, the device ops that took most
time, and the longest idle gaps with the CPU op running when each began.
`prime_trace` runs small copies and kernels first, for a profiler that
loses the first device records of a trace late in a long process."""

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_WORK = "host (no torch op)"
NAME_CHARS = 120
PRIME_RECORDS = 256


def prime_trace(dev) -> None:
    """PRIME_RECORDS small host-to-device copies and kernels, then a
    synchronise."""
    host = torch.zeros(256, dtype=torch.int32)
    for _ in range(PRIME_RECORDS):
        host.to(dev).add_(1)
    torch.cuda.synchronize(dev)


def merge_spans(spans) -> list:
    """[(start, end)] -> their union as sorted, disjoint pairs."""
    out = []
    for start, end in sorted(sp for sp in spans if sp[1] > sp[0]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(sp) for sp in out]


def busy_us(spans, lo: float, hi: float) -> float:
    """Length of the union of `spans` inside [lo, hi]."""
    return sum(max(0.0, min(end, hi) - max(start, lo))
               for start, end in merge_spans(spans))


def idle_gaps(spans, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no span covers, in order."""
    gaps, t = [], lo
    for start, end in merge_spans(spans):
        if end <= t:
            continue
        if start >= hi:
            break
        if start > t:
            gaps.append((t, start))
        t = end
    if t < hi:
        gaps.append((t, hi))
    return gaps


def op_at(t: float, ops) -> str:
    """The innermost CPU op of [(start, end, name)] running at t (the
    latest start, then the shortest), or HOST_WORK."""
    best = None
    for start, end, name in ops:
        if start <= t < end and (best is None or (start, best[1]) >
                                 (best[0], end)):
            best = (start, end, name)
    return best[2] if best else HOST_WORK


def device_events(events, lo: float, hi: float) -> list:
    """The trace's device events that overlap [lo, hi]."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]


def trace_summary(events, lo: float, hi: float, top: int = 10,
                  n_gaps: int = 10) -> dict:
    """The device's busy µs in [lo, hi], the `top` device ops by µs with
    their launches, and the `n_gaps` longest idle gaps with the CPU op
    running when each began."""
    dev = device_events(events, lo, hi)
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    by_name = {}
    for e in dev:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
    return {"busy_us": busy_us(spans, lo, hi),
            "top_device_ops": [{"name": k[:NAME_CHARS], "us": v[0],
                                "launches": v[1]} for k, v in top_ops],
            "longest_gaps": [{"us": end - start, "at_us": start - lo,
                              "began_in": op_at(start, ops)}
                             for start, end in gaps[:n_gaps]]}
