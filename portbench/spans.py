"""One traced run of a cell with the program's own tracer on, and the
per-layer numbers its spans give.

    python3 portbench/spans.py --workload <cell> --seed <n> \
        --seconds <s> [--tracer 0|1]

from the root of a checkout. It is `run.py --trace 1` (the same
`run_cell`, profiler and check), with `repro_torch.tracing` turned on
for the measured window (`--tracer 1`, the default) or left off
(`--tracer 0`: the traced run as the benchmark makes it, for the
tracer's cost). After the benchmark's own result line it prints one
more JSON line: the readers of the metrics that read the tracer's
summary (`SPAN_METRICS`), K1's stamps per call beside the profiler's
device time, the device's idle time inside the benchmark's `decide` and
`digest` spans put down to the innermost `rb.*` range open at that
moment (`idle_by_program_span`), and the summary itself.

`run.py` does not turn the tracer on; this script wraps, on the
harness's objects and not in its files, `Drive.window` (the tracer on
for the window) and `read_profile` (a copy of the exported trace).
Where the program has no tracer, the span numbers are left out.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.bench.trace import (  # noqa: E402
    _DEVICE_CATS, _clip, _gaps, _length, _minus, _overlap, _union)

SPAN_METRICS = ("hotpath_stage_ms_per_call", "hotpath_sync_ms_per_call",
                "hotpath_launch_ms_per_call", "mirror_rows_per_call",
                "k1_wait_ms_per_call", "decide_outside_ms_per_batch",
                "place_us_per_req", "k1_trees_share_pct")
IDLE_SPANS = ("decide", "digest")
NONE = "(none)"


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
            elif name == "fleet":
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


def span_numbers(view: Dict) -> Dict:
    """The metrics that read the tracer's summary, by name; a reader that
    finds nothing to read is left out."""
    out = {}
    for name in SPAN_METRICS:
        v = importlib.import_module(f"portbench.metrics.{name}").read(view)
        if v is not None:
            out[name] = float(v)
    return out


@contextlib.contextmanager
def tracer_on_window(tracer: bool):
    """Wrap `Drive.window` (the tracer on for the window when `tracer`),
    `read_profile` (the device's idle time by program span, from a copy
    of the exported trace) and `run.run_cell` (its result kept); yields
    the dict they fill, and restores all three."""
    from portbench import run as pr
    from portbench.bench import cell as cl
    from portbench.bench import trace as tr
    try:
        from repro_torch import tracing
    except ImportError:
        tracing = None
    got: Dict = {}
    window, read_profile, run_cell = (cl.Drive.window, tr.read_profile,
                                      pr.run_cell)

    def traced_window(self, seconds, on_start=None):
        def start():
            if on_start is not None:
                on_start()
            if tracer and tracing is not None:
                tracing.enable()
        try:
            return window(self, seconds, on_start=start)
        finally:
            if tracing is not None:
                tracing.disable()
                got["spans"] = tracing.summary() if tracer else None
            got["hier"] = self.hier

    def kept_read_profile(prof, kernel):
        keep = {}

        class Keep:
            def export_chrome_trace(self, path):
                prof.export_chrome_trace(path)
                fd, keep["path"] = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                shutil.copyfile(path, keep["path"])
        out = read_profile(Keep(), kernel)
        try:
            with open(keep["path"]) as f:
                got["idle_by_program_span"] = idle_by_program_span(
                    json.load(f)["traceEvents"])
        finally:
            os.unlink(keep["path"])
        return out

    def kept_run_cell(*a, **kw):
        got["result"] = run_cell(*a, **kw)
        return got["result"]

    cl.Drive.window = traced_window
    tr.read_profile = kept_read_profile
    pr.run_cell = kept_run_cell
    try:
        yield got
    finally:
        cl.Drive.window, tr.read_profile, pr.run_cell = (
            window, read_profile, run_cell)


def span_line(got: Dict) -> Dict:
    """The numbers the tracer's window gives, from what
    `tracer_on_window` kept."""
    res = got["result"]
    spans = got.get("spans")
    view = dict(spans=spans, hot=res["info"]["hot"], hier=got["hier"],
                batches=res["info"]["batches"])
    line = {"metrics": span_numbers(view),
            "idle_by_program_span": got.get("idle_by_program_span"),
            "idle_gaps": res.get("breakdown", {}).get("idle_gaps")}
    if spans and "k1.call" in spans:
        n = spans["k1.call"]["count"]
        line["k1_stamps_ms_per_call"] = 1e3 * spans["k1.call"]["total_s"] / n
        line["k1_split_ms_per_call"] = {
            k: 1e3 * spans[k]["total_s"] / n
            for k in ("k1.stage1", "k1.trees", "k1.scan") if k in spans}
    if spans:
        line["spans"] = {k: {"count": s["count"], "total_s": s["total_s"],
                             "self_s": s["self_s"]}
                         for k, s in spans.items()}
    return line


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    from portbench import run as pr
    with tracer_on_window(bool(args.tracer)) as got:
        pr.main(["--workload", args.workload, "--seed", str(args.seed),
                 "--seconds", str(args.seconds), "--trace", "1"])
    line = {"workload": args.workload, "seed": args.seed,
            "tracer": args.tracer, **span_line(got)}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
