"""Reading a torch.profiler trace of a slot's first program: the device's
busy time (the union of every device interval), time and count of each
hand-written kernel class, the device operations that took most time,
and the idle time by what the host was doing (the plane program in
flight, or none).

The events are read straight from the profiler's kineto results: the span
holds hundreds of thousands of device events, and building the
profiler's own event tree over them takes minutes."""

from __future__ import annotations

from collections import defaultdict

# the kernel classes the rooflines read, by a part of the kernel's name in
# a trace (the int8 kernels' names contain "mxu" and are left out here)
CLASSES = {
    "mont_mul": ("mont_mul_fp", "mont_mul_fr"),
    "fp2_mul": ("fp2_mul",),
    "fp2_sqr": ("fp2_sqr",),
}


def kernel_class(name: str) -> str | None:
    if "mxu" in name:
        return None
    for cls in CLASSES:
        if cls in name:
            return cls
    return None


def _union(starts, ends) -> int:
    """Length of the union of the intervals [starts[i], ends[i])."""
    import numpy as np

    starts, ends = np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64)
    if not starts.size:
        return 0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    before = np.concatenate(([np.iinfo(np.int64).min], np.maximum.accumulate(e)[:-1]))
    return int(np.clip(e - np.maximum(s, before), 0, None).sum())


def summarize(traced: dict, top: int = 10) -> dict:
    """busy_s and window_s of the traced span, its per-class {count,
    device_s}, top device operations, idle seconds by host activity, and
    launches by kernel and row count (system.Program.traced_slot). Device
    events are placed on the host's wall clock and cut to the span."""
    import numpy as np
    from torch.autograd import DeviceType

    begin, end = traced["start_ns"], traced["end_ns"]
    starts, durs, names = [], [], []
    offset = 0
    if traced["prof"] is not None:
        results = traced["prof"].profiler.kineto_results
        for e in results.events():
            if e.device_type() == DeviceType.CUDA:
                starts.append(e.start_ns())
                durs.append(e.duration_ns())
                names.append(e.name())
        # kineto stamps events on the wall clock; where its clock differs, anchor it at the profile's start
        offset = begin - results.trace_start_ns()
        offset = offset if abs(offset) > 1_000_000_000 else 0
    starts = np.array(starts, dtype=np.int64) + offset
    ends = starts + np.array(durs, dtype=np.int64)
    keep = starts < end
    starts, ends = starts[keep], np.minimum(ends[keep], end)
    names = [n for n, k in zip(names, keep) if k]
    by_name = defaultdict(lambda: [0, 0])  # name -> [events, ns]
    for name, d in zip(names, (ends - starts).tolist()):
        agg = by_name[name]
        agg[0] += 1
        agg[1] += d
    classes = {cls: {"count": 0, "device_s": 0.0} for cls in CLASSES}
    for name, (n, d) in by_name.items():
        cls = kernel_class(name)
        if cls is not None:
            classes[cls]["count"] += n
            classes[cls]["device_s"] += d / 1e9
    ops = sorted(((name, d) for name, (_, d) in by_name.items()), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": _union(starts, ends) / 1e9,
        "window_s": (end - begin) / 1e9,
        "events": len(names),
        "classes": classes,
        "device_ops": [[name[:120], d / 1e9] for name, d in ops],
        "idle_gaps": idle_by_program(starts, ends, begin, end, traced["programs"]),
        "launches": traced["launches"],
        "rows": traced["rows"],
    }


def idle_by_program(starts, ends, begin: int, end: int, programs: list) -> list:
    """Idle seconds of the span [begin, end) by the plane program the host
    was running (on_program spans), and outside every program (decode,
    root hashing, pack)."""
    import numpy as np

    windows = [(fam, max(begin, t_end - round(secs * 1e9)), min(end, t_end)) for fam, secs, _, t_end in programs]
    idle = defaultdict(float)
    outside = np.ones(starts.shape, dtype=bool)
    for fam, a, b in windows:
        inside = (ends > a) & (starts < b)
        idle[fam] += ((b - a) - _union(np.maximum(starts[inside], a), np.minimum(ends[inside], b))) / 1e9
        outside &= ~((starts >= a) & (starts < b))
    covered = sum(b - a for _, a, b in windows)
    idle["outside programs"] += ((end - begin - covered) - _union(starts[outside], ends[outside])) / 1e9
    return sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]


def roofline(trace: dict, cls: str) -> float | None:
    """A kernel class's share of its roofline, %: the least time its
    launches could take at their row counts over the time the trace gives
    them, the bound scaled by the share of launches the trace holds (the
    profiler can drop events). None where the class did not run."""
    from portbench import peaks

    seen = trace["classes"][cls]
    launched = sum(trace["launches"].get(k, 0) for k in CLASSES[cls])
    if not launched or not seen["count"] or seen["device_s"] <= 0:
        return None
    bound = sum(peaks.bound_s(k, rows) * n for k in CLASSES[cls] for rows, n in trace["rows"].get(k, {}).items())
    return 100.0 * bound * seen["count"] / launched / seen["device_s"]
