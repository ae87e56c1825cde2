"""Elastic membership and staleness for the hierarchical control plane.

Port of `repro.distributed.elastic` (lines 1-61), pure Python: a registry
of peers with heartbeat timestamps. Peers that miss heartbeats are
quarantined (they stop receiving traffic) and re-admitted when they
return. The hierarchical scheduler
(`repro_torch.serving.hierarchy.GlobalBalancer`) registers each cell as
a member, and a digest arrival is its heartbeat. `staleness_penalty` is
the soft arm: digest age inflates a cell's apparent load, so a cell
whose control plane lags sheds traffic before the hard timeout darkens
it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class MemberState:
    iid: str
    tier: str
    last_heartbeat: float
    quarantined: bool = False


class ElasticMembership:
    def __init__(self, heartbeat_timeout: float = 5.0,
                 staleness_decay: float = 2.0):
        self.timeout = heartbeat_timeout
        self.decay = staleness_decay
        self.members: Dict[str, MemberState] = {}

    def register(self, iid: str, tier: str, now: float):
        self.members[iid] = MemberState(iid, tier, now)

    def heartbeat(self, iid: str, now: float):
        m = self.members.get(iid)
        if m:
            m.last_heartbeat = now
            m.quarantined = False

    def active(self, now: float) -> List[str]:
        out = []
        for m in self.members.values():
            if now - m.last_heartbeat > self.timeout:
                m.quarantined = True
            if not m.quarantined:
                out.append(m.iid)
        return out

    def staleness_penalty(self, iid: str, now: float) -> float:
        """Multiplier (>= 1) on dead-reckoned pending work: a straggling
        member looks more loaded as its telemetry ages, shedding traffic
        before the quarantine timeout."""
        m = self.members.get(iid)
        if m is None:
            return float("inf")
        age = max(now - m.last_heartbeat, 0.0)
        return 1.0 + self.decay * age / max(self.timeout, 1e-9)
