"""One general generator of the benchmark's request streams.

A traffic mix is a data file (`portbench/traffic/<mix>.json`) of
tenants, each with its rate, arrival process, prompt slice, budget mix
and priority. `build_stream` turns a mix and a seed into arrays; for
one-shot tenants it is a frozen copy of the program's
`serving.scenarios.build_requests` with the arrival processes of
`serving.workload`, so the same seed gives the same arrivals, prompts
and budgets as the program's generators.

A tenant may hold multi-turn sessions (`"session": {"turns", "base_len",
"extend": [lo, hi]}`), drawn as the program's `SessionSpec` draws them
(`serving.scenarios._session_prompts`, frozen here): the tenant's
arrival slots are dealt round-robin to ceil(n / turns) conversations, so
turn u of a conversation arrives after turn u - 1, one stream length
over `turns` later (32 s in a 160 s stream). Turn 1 is the drawn
prompt's first `base_len` tokens; each later turn appends `extend` fresh
tokens (uniform in [lo, hi], each uniform in [1, VOCAB)), capped at the
world's 128; every turn keeps the drawn prompt's quality and lengths.
The first stream length over `turns` holds only first turns: a mix whose
window should see a steady share of follow-ups sets its `warm_s` past
it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .world import TOPICS, VOCAB

ARRIVALS = ("poisson", "gamma", "square", "flash")
_TENANT_KEYS = {"name", "lam", "arrival", "arrival_kw", "topics",
                "len_band", "budget_frac", "budget_range", "priority",
                "session"}
_SESSION_KEYS = {"turns", "base_len", "extend"}
SESSION_CAP = 128          # a turn's tokens: the world's prompt window


def poisson_arrivals(lam, n, seed=0, start=0.0):
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / lam, n))


def gamma_bursty_arrivals(lam, n, cv=3.0, seed=0):
    rng = np.random.default_rng(seed)
    shape = 1.0 / cv ** 2
    return np.cumsum(rng.gamma(shape, 1.0 / (lam * shape), n))


def square_wave_arrivals(lam, n, period=60.0, high_frac=1.5, seed=0):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    lo, hi = (2.0 - high_frac) * lam, high_frac * lam
    for _ in range(n):
        rate = hi if (t % period) < period / 2 else lo
        t += rng.exponential(1.0 / max(rate, 1e-9))
        out.append(t)
    return np.asarray(out)


def flash_crowd_arrivals(lam, n, burst_start=20.0, burst_dur=10.0,
                         burst_mult=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        in_burst = burst_start <= t < burst_start + burst_dur
        t += rng.exponential(1.0 / max(lam * (burst_mult if in_burst
                                               else 1.0), 1e-9))
        out.append(t)
    return np.asarray(out)


def make_arrivals(kind, lam, n, seed=0, **kw):
    fn = {"poisson": poisson_arrivals, "gamma": gamma_bursty_arrivals,
          "square": square_wave_arrivals,
          "flash": flash_crowd_arrivals}.get(kind)
    if fn is None:
        raise ValueError(f"arrival {kind!r} not in {ARRIVALS}")
    if kind == "poisson":
        return fn(lam, n, seed, **kw)
    return fn(lam, n, seed=seed, **kw)


def sample_budgets(n, frac, lo=2e-5, hi=4e-4, rng=None):
    """Log-uniform USD budgets with probability `frac`, nan otherwise."""
    has = rng.uniform(size=n) < frac
    vals = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return np.where(has, vals, np.nan)


def check_mix(mix: dict) -> None:
    """Refuse a mix file with keys the generator does not read."""
    for ten in mix["tenants"]:
        extra = set(ten) - _TENANT_KEYS
        if extra:
            raise ValueError(f"tenant {ten.get('name')!r}: unknown keys "
                             f"{sorted(extra)}")
        if ten.get("arrival", "poisson") not in ARRIVALS:
            raise ValueError(f"tenant {ten['name']!r}: arrival "
                             f"{ten['arrival']!r} not in {ARRIVALS}")
        sess = ten.get("session")
        if sess is None:
            continue
        if set(sess) != _SESSION_KEYS:
            raise ValueError(f"tenant {ten['name']!r}: session keys "
                             f"{sorted(sess)}, want {sorted(_SESSION_KEYS)}")
        lo, hi = sess["extend"]
        if not (sess["turns"] >= 1 and sess["base_len"] >= 1
                and 0 <= lo <= hi):
            raise ValueError(f"tenant {ten['name']!r}: session {sess}")


def _tenant_pool(topic, len_in, ten) -> np.ndarray:
    idx = np.arange(len(topic))
    if ten.get("topics") is not None:
        keep = {TOPICS.index(t) for t in ten["topics"]}
        idx = np.array([i for i in idx if topic[i] in keep], dtype=int)
    band = ten.get("len_band")
    if band is not None and len(idx):
        lens = np.asarray(len_in, float)[idx]
        lo, hi = np.quantile(lens, band)
        sub = idx[(lens >= lo) & (lens <= hi)]
        idx = sub if len(sub) else idx
    return idx if len(idx) else np.arange(len(topic))


@dataclasses.dataclass
class Stream:
    """An arrival-ordered request stream: arrival (n,) seconds, prompt
    (n,) row into the prompt set it was drawn from, budget (n,) USD (nan
    = none), tenant (n,) index, priority (n,), and `ends` the last
    arrival of each tenant. `tokens` holds each row's own tokens (int32) where it is a session
    turn and None where the row is the drawn prompt itself; it is None
    for a mix without sessions."""
    arrival: np.ndarray
    prompt: np.ndarray
    budget: np.ndarray
    tenant: np.ndarray
    priority: np.ndarray
    names: List[str]
    ends: np.ndarray
    tokens: Optional[List] = None

    @property
    def n(self) -> int:
        return len(self.arrival)


def _session_prompts(sess: Dict, n_t: int, rng, pool,
                     tokens: Sequence[np.ndarray]):
    """A session tenant's `n_t` arrival slots dealt round-robin to its
    conversations: (prompt row, tokens) of each slot."""
    n_conv = max(1, -(-n_t // max(sess["turns"], 1)))
    base = rng.choice(pool, n_conv, replace=True)
    lo, hi = sess["extend"]
    convo = [None] * n_conv          # each conversation's tokens so far
    picks, toks = np.empty(n_t, np.int64), []
    for i in range(n_t):
        c = i % n_conv
        if convo[c] is None:
            t = np.asarray(tokens[base[c]][:sess["base_len"]],
                           np.int32).copy()
        else:
            ext = int(rng.integers(lo, hi + 1))
            t = np.concatenate([convo[c], rng.integers(1, VOCAB, ext).astype(
                np.int32)])[:SESSION_CAP]
        convo[c] = t
        picks[i] = base[c]
        toks.append(t)
    return picks, toks


def build_stream(topic, len_in, mix: Dict, n: int, seed: int,
                 lam_scale: float = 1.0,
                 tokens: Optional[Sequence[np.ndarray]] = None) -> Stream:
    """`n` requests split over the mix's tenants in proportion to their
    rates, each tenant drawing arrivals, prompts (from its slice of the
    prompt set given by `topic` and `len_in`) and budgets from its own
    stream of the seed; merged in arrival order (ties keep tenant order).
    A session tenant also needs the prompt set's `tokens`."""
    check_mix(mix)
    tenants = mix["tenants"]
    lam_total = sum(t["lam"] for t in tenants)
    parts = []
    sessions = any(t.get("session") for t in tenants)
    for k, ten in enumerate(tenants):
        n_t = max(int(round(n * ten["lam"] / lam_total)), 1)
        rng = np.random.default_rng((seed, k, 0xA11CE))
        arr = make_arrivals(ten.get("arrival", "poisson"),
                            ten["lam"] * lam_scale, n_t,
                            seed=int(rng.integers(2 ** 31)),
                            **dict(ten.get("arrival_kw") or {}))
        pool = _tenant_pool(topic, len_in, ten)
        toks = [None] * n_t
        if ten.get("session"):
            if tokens is None:
                raise ValueError(f"tenant {ten['name']!r} holds sessions: "
                                 "build_stream needs the prompts' tokens")
            picks, toks = _session_prompts(ten["session"], n_t, rng, pool,
                                           tokens)
        else:
            picks = rng.choice(pool, n_t, replace=True)
        lo, hi = ten.get("budget_range", (2e-5, 4e-4))
        budgets = sample_budgets(n_t, ten.get("budget_frac", 0.0), lo, hi,
                                 rng=rng)
        parts.append((arr, picks, budgets, k, ten.get("priority", 0), toks))
    arrival = np.concatenate([p[0] for p in parts])
    order = np.argsort(arrival, kind="stable")
    toks = None
    if sessions:
        flat = [t for p in parts for t in p[5]]
        toks = [flat[i] for i in order]
    return Stream(
        arrival=arrival[order],
        prompt=np.concatenate([p[1] for p in parts])[order].astype(np.int64),
        budget=np.concatenate([p[2] for p in parts])[order],
        tenant=np.concatenate([np.full(len(p[0]), p[3]) for p in parts]
                              )[order],
        priority=np.concatenate([np.full(len(p[0]), p[4]) for p in parts]
                                )[order],
        names=[t["name"] for t in tenants],
        ends=np.array([p[0][-1] for p in parts]), tokens=toks)


def stream_for_mix(topic, len_in, mix: Dict, seed: int,
                   tokens: Optional[Sequence[np.ndarray]] = None) -> Stream:
    """The stream a mix file asks for: its total rate times its
    `stream_s` seconds of requests."""
    lam = sum(t["lam"] for t in mix["tenants"]) * mix.get("lam_scale", 1.0)
    n = int(round(lam * mix["stream_s"]))
    return build_stream(topic, len_in, mix, n, seed,
                        lam_scale=mix.get("lam_scale", 1.0), tokens=tokens)
