"""Spans at the port's layer boundaries, kept in memory.

Off by default. A span site reads the module global `ON` and branches;
with the tracer off it reads no clock, allocates nothing and opens no
profiler range:

    sp = tracing.begin("rb.sync", True) if tracing.ON else None
    ...
    if sp is not None:
        tracing.end(sp, kind=1, rows=12)

`enable()` clears the store and turns the tracer on, `disable()` turns it
off (a span begun while on still ends). Each span is a record: its name,
start and end on `time.perf_counter_ns`, the index of its parent (the
innermost span open when it began, -1 for none) and a few ids. A span
begun with `profile=True` also opens a `torch.profiler.record_function`
range of its name, so that it lies on the profiler's timeline beside
the device's work; the engine and the hot path do so for the spans of a
batch or a heartbeat, not for those of a request. `add` stores a
duration measured elsewhere (K1's device clock), with no parent.

The spans and where they are recorded:

  rb.ingest      one arrival, from the object the fleet calls (`rid`)
  rb.place       the balancer's placement in the hierarchy (`rid`, `cell`)
  rb.fire        one `ServingEngine._fire` (`cell`, `batch`, `rows`;
                 the batch's `rids`)
  rb.window      the adaptive window over the telemetry
  rb.stage       the hot path's staging pass and affinity plane (`K`, `R`)
  rb.plane       inside `rb.stage`, where the affinity term is on: the
                 fleet's prefix sketches copied into the pinned plane and
                 the plane and the rows' signatures uploaded (`rows`, the
                 sketch rows copied; `bytes`, the bytes uploaded)
  rb.sync        the telemetry mirror's sync (`kind`: 0 carry, 1 delta,
                 2 full reseed, 3 roster reseed; `rows` shipped)
  rb.launch      K1's wrapper call up to the answer's event
  rb.fetch       `LazyDecision.fetch`, with `rb.k1_wait` around the event
  rb.dispatch    the engine's loop handing a batch to its instances, with
                 one `rb.submit` (`rid`, `slot`) per request
  rb.cell_refresh  a cell's telemetry mirror catching up with the fleet's
                 (`cell`; `rows`, the telemetry rows it copied)
  rb.digest      one balancer heartbeat (`seq`)
  k1.stage1, k1.trees, k1.scan, k1.scan_a, k1.call
                 K1's own stamps (`batch`), device durations read at
                 fetch: once a call the per-instance preamble over the
                 grid (`k1.trees`: the TPOT trees and, with the affinity
                 term on, the rows' affinity factors; `aff_rows`, the
                 rows whose factors it wrote) and the call; per window
                 the rest of stage 1, the scan (`steps`, the steps its
                 loop ran; `ctas`, the CTAs that ran it) and its steps'
                 pass A (cost, latency with its affinity factor read,
                 admission)

A span left open by an exception is dropped from `summary`. The tracer
imports nothing from the package, so every layer can import it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

ON = False
_records: List["Span"] = []
_open: List["Span"] = []


class Span:
    __slots__ = ("name", "t0", "t1", "parent", "ids", "index", "_range")

    def __init__(self, name: str, t0: int, t1: Optional[int], parent: int,
                 ids: Dict, index: int):
        self.name, self.t0, self.t1 = name, t0, t1
        self.parent, self.ids, self.index = parent, ids, index
        self._range = None


def enable() -> None:
    """Clear the store and start recording."""
    global ON
    _records.clear()
    _open.clear()
    ON = True


def disable() -> None:
    global ON
    ON = False


def begin(name: str, profile: bool = False, **ids) -> Span:
    """Open a span under the innermost open one; with `profile`, also a
    profiler range of the same name."""
    sp = Span(name, 0, None, _open[-1].index if _open else -1, ids,
              len(_records))
    _records.append(sp)
    _open.append(sp)
    if profile:
        sp._range = torch.profiler.record_function(name)
        sp._range.__enter__()
    sp.t0 = time.perf_counter_ns()
    return sp


def end(sp: Span, **ids) -> None:
    """Close `sp` (and any span left open inside it), adding `ids`."""
    sp.t1 = time.perf_counter_ns()
    if sp._range is not None:
        sp._range.__exit__(None, None, None)
        sp._range = None
    if ids:
        sp.ids.update(ids)
    if sp in _open:            # not where `enable` cleared the store since
        while _open.pop() is not sp:
            pass


def add(name: str, dur_ns: int, **ids) -> None:
    """Store a finished duration measured on another clock."""
    _records.append(Span(name, 0, int(dur_ns), -1, ids, len(_records)))


def open_id(name: str, key: str, default: int = -1) -> int:
    """The id `key` of the innermost open span called `name`."""
    for sp in reversed(_open):
        if sp.name == name:
            return sp.ids.get(key, default)
    return default


def records() -> List[Span]:
    return list(_records)


def summary() -> Dict[str, Dict]:
    """Per span name: `count`, `total_s`, `self_s` (the durations less
    those of their children) and `sums`, the sums of its integer ids."""
    child = [0] * len(_records)
    for sp in _records:
        if sp.t1 is not None and sp.parent >= 0:
            child[sp.parent] += sp.t1 - sp.t0
    acc: Dict[str, List] = {}
    for sp in _records:
        if sp.t1 is None:
            continue
        a = acc.setdefault(sp.name, [0, 0, 0, {}])
        dur = sp.t1 - sp.t0
        a[0] += 1
        a[1] += dur
        a[2] += dur - child[sp.index]
        for k, v in sp.ids.items():
            if isinstance(v, int):
                a[3][k] = a[3].get(k, 0) + v
    return {name: {"count": n, "total_s": tot * 1e-9, "self_s": own * 1e-9,
                   "sums": sums}
            for name, (n, tot, own, sums) in acc.items()}
