"""Readings from `torch.profiler`'s trace of the measured window.

The window runs under the profiler with the benchmark's spans marked as
`record_function` ranges ("ingest", "decide", "digest") inside one
"window" range, and the simulated instances' `submit` as "fleet" ranges
inside the spans, so the spans and the device's activities lie on one
clock in the exported trace. The controller's time is the spans less
the fleet ranges. From it: the device's busy time (the union
of kernels, copies and sets), K1's device time and launches, the part
of the controller's spans with no device activity, the device
operations that took most time, and what the host was doing while the
device was idle: by the benchmark's spans, and inside its `decide` and
`digest` spans by the program's own `rb.*` ranges, which its tracer
(`repro_torch.tracing`) opens while it is on.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Dict, List, Tuple

SPANS = ("ingest", "decide", "digest")
FLEET = "fleet"
IDLE_SPANS = ("decide", "digest")
NONE = "(none)"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(iv, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def _length(iv) -> float:
    return float(sum(b - a for a, b in iv))


def _minus(a_iv, b_iv) -> List[Tuple[float, float]]:
    """The parts of sorted, disjoint intervals `a_iv` outside those of
    `b_iv`."""
    out, j = [], 0
    for a, b in a_iv:
        while j < len(b_iv) and b_iv[j][1] <= a:
            j += 1
        k = j
        while k < len(b_iv) and b_iv[k][0] < b:
            if b_iv[k][0] > a:
                out.append((a, b_iv[k][0]))
            a = max(a, b_iv[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def _overlap(a_iv, b_iv) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    tot = 0.0
    while i < len(a_iv) and j < len(b_iv):
        lo = max(a_iv[i][0], b_iv[j][0])
        hi = min(a_iv[i][1], b_iv[j][1])
        if hi > lo:
            tot += hi - lo
        if a_iv[i][1] < b_iv[j][1]:
            i += 1
        else:
            j += 1
    return tot


def read_profile(prof, kernel: str) -> Dict:
    """The window's readings from a finished profiler; times in seconds.
    Raises when the trace has no device activity at all."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("name") == "window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no 'window' range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], {n: [] for n in SPANS + (FLEET,)}
    by_name: Dict[str, float] = {}
    k1_us, k1_n = 0.0, 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            if a + d <= w0 or a >= w1:
                continue
            dev.append((a, a + d))
            name = e.get("name", "?")
            by_name[name] = by_name.get(name, 0.0) + d
            if kernel in name:
                k1_us += d
                k1_n += 1
        elif cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((a, a + d))
    busy = _union(_clip(dev, w0, w1))
    if not busy:
        raise RuntimeError("no device activity in the traced window")
    fleet = _union(_clip(spans.pop(FLEET), w0, w1))
    span_iv = {n: _minus(_union(_clip(v, w0, w1)), fleet)
               for n, v in spans.items()}
    ctrl = _union([iv for v in span_iv.values() for iv in v])
    ctrl_s = _length(ctrl)
    # the device's idle time in the window, by what the host was in:
    # a span (decide / ingest / digest), the instances' submit, or
    # outside them (the simulator and the harness's event loop)
    idle = _gaps(busy, w0, w1)
    idle_by = {n: _overlap(idle, iv) for n, iv in span_iv.items()}
    idle_by[FLEET] = _overlap(idle, fleet)
    idle_by["simulator"] = (_length(idle) - _overlap(idle, ctrl)
                            - idle_by[FLEET])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": _length(busy) * 1e-6,
        "k1_device_s": k1_us * 1e-6,
        "k1_launches": k1_n,
        "controller_s": ctrl_s * 1e-6,
        "controller_idle_s": (ctrl_s - _overlap(ctrl, busy)) * 1e-6,
        "device_ops": [[n, v * 1e-6] for n, v in top],
        "idle_gaps": [[n, v * 1e-6] for n, v in sorted(
            idle_by.items(), key=lambda kv: -kv[1])],
        "idle_by_program_span": idle_by_program_span(events),
    }


def innermost(ranges: List[Tuple[float, float, str]]):
    """Disjoint (start, end, name) pieces of nested ranges, each piece
    named after the innermost range open over it; a range that crosses
    its parent's end is cut there."""
    out, stack, t = [], [], None
    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            if end > t:
                out.append((t, end, top))
                t = end
        if stack and a > t:
            out.append((t, a, stack[-1][1]))
        t = a
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    while stack:
        end, top = stack.pop()
        if end > t:
            out.append((t, end, top))
            t = end
    return out


def idle_by_program_span(events: List[Dict]) -> List[List]:
    """The device's idle time (s) inside the benchmark's `decide` and
    `digest` spans less the `fleet` ranges, as `read_profile` takes
    them, by the innermost `rb.*` range open over it; `(none)` for the
    rest. Sums to those spans' entries of `idle_gaps`."""
    win = [e for e in events if e.get("name") == "window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans, prog = [], [], []
    fleet = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in _DEVICE_CATS:
            dev.append((a, a + d))
        elif cat == "user_annotation":
            if name in IDLE_SPANS:
                spans.append((a, a + d))
            elif name == FLEET:
                fleet.append((a, a + d))
            elif name.startswith("rb."):
                prog.append((a, a + d, name))
    idle = _gaps(_union(_clip(dev, w0, w1)), w0, w1)
    region = _minus(_union(_clip(spans, w0, w1)),
                    _union(_clip(fleet, w0, w1)))
    target = _minus(idle, _minus(idle, region))       # idle inside them
    pieces: Dict[str, List] = {}
    for a, b, name in innermost(prog):
        pieces.setdefault(name, []).append((a, b))
    out = {n: _overlap(target, iv) for n, iv in pieces.items()}
    out[NONE] = _length(target) - sum(out.values())
    return [[n, v * 1e-6] for n, v in sorted(out.items(),
                                             key=lambda kv: -kv[1])]


def _gaps(busy, lo, hi) -> List[Tuple[float, float]]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def power_limit_w() -> float:
    """The card's power limit in watts (`nvidia-smi`); nan where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return float("nan")
