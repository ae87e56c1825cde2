"""Replica dispatchers for the decoupled baseline policies:
round-robin, shortest-queue, random (§5).

Port of `repro.core.dispatchers` (lines 1-59), a copy.

`pick_slots(slots, tel)` is the dispatch interface: `slots` is the
candidate set as roster-slot indices (ascending — the router's
candidate filter over the alive mask), `tel` the scheduler-side
columnar `TelemetryArrays` view. State-dependent dispatchers read
telemetry as vectorized column gathers."""
from __future__ import annotations

import numpy as np

from ..serving.cluster import TelemetryArrays


class Dispatcher:
    name = "dispatcher"

    def pick_slots(self, slots: np.ndarray, tel: TelemetryArrays) -> int:
        """Index into `slots` of the chosen replica."""
        raise NotImplementedError


class RoundRobin(Dispatcher):
    name = "rr"

    def __init__(self):
        self._n = 0

    def pick_slots(self, slots, tel):
        i = self._n % len(slots)
        self._n += 1
        return i


class ShortestQueue(Dispatcher):
    name = "sq"

    def pick_slots(self, slots, tel):
        # queue depth dominates, pending decode tokens break ties —
        # one vectorized argmin over the telemetry columns
        return int(np.argmin(tel.queue[slots] * 1000.0
                             + tel.pending[slots]))


class RandomDispatch(Dispatcher):
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def pick_slots(self, slots, tel):
        return int(self.rng.integers(0, len(slots)))


DISPATCHERS = {"rr": RoundRobin, "sq": ShortestQueue,
               "random": RandomDispatch}
