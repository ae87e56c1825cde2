"""The per-batch RouteBalance decision as one device call, fed by the
zero-allocation SoA ingest layer (§4.2/§6.3).

Port of `repro.core.hotpath` (lines 72-356, 459-731), the megakernel
branch only: one decided batch — or K scheduler windows coalesced by
`decide_cols_multi` — is one call of
`repro_torch.kernels.decision_megakernel` (the CUDA kernel on the card,
its plain version on the CPU). The host machinery around it is the
reference's:

  * **SoA ingest** — embeddings are memoized per prompt in
    `RequestColumns`; a batch is a row slice staged with `np.take`;
  * **preallocated staging** — per-pow2(R)-bucket host buffers, double
    buffered so writing batch N+1 never aliases batch N's in-flight
    copy; on CUDA they are pinned and copied with `non_blocking=True`;
  * **incremental device telemetry** — the (d, b, free, ctx) mirror
    lives on the device; each batch ships only the rows written since
    the last sync (`tel.dirty_rows`) and writes them into the mirror in
    place, with a full reseed on roster events or when most rows are
    dirty. The refreshed mirror equals a fresh host read of `tel` bit
    for bit, so the decision is the staged backends' decision;
  * **deferred fetch** — `decide_cols` returns a `LazyDecision` whose
    host copy is waited for (a CUDA event, not a device-wide sync) only
    at the scheduler's dispatch point.

Batch size R, window count K and roster size I are bucketed to powers
of two; pad rows are invalid rows that still pick but update nothing,
pad windows hold only pad rows, and pad columns stay dead.
`shape_variants()` counts the distinct (K bucket, R bucket) shapes the
kernel has been called at, the port's stand-in for the reference's
`compile_count`.

With `repro_torch.tracing` on, a call records the spans `rb.stage`
(with `rb.plane` inside it where the affinity term is on), `rb.sync`,
`rb.launch` and, at the fetch, `rb.fetch` around `rb.k1_wait`;
on the card K1 also stamps its own stages (`k1.*`, the wrapper's
`timers`) into a buffer kept per K bucket, copied back with the answer.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..estimators.gbm import pack_ensemble
# a module import: `kernels.decision_megakernel` imports `core`, which
# imports this module
from ..kernels import decision_megakernel as k1
from ..serving.affinity import SIG_WIDTH, SKETCH_SLOTS
from .decision import bucket_pow2


def _new_stats() -> Dict:
    return {"calls": 0, "multi_dispatch": 0, "host_s": 0.0, "stage_s": 0.0,
            "dispatch_s": 0.0, "full_reseed": 0, "roster_reseed": 0,
            "delta_sync": 0, "delta_rows": 0, "carry": 0}


class _K1Stamps:
    """One traced K1 call's `%globaltimer` stamps, copied back into a
    pinned buffer of 1 + 4K behind the call's event: the kernel's entry,
    then per window the end of the per-instance preamble (the grid's last
    slice of TPOT trees and, with the affinity term on, affinity factors;
    the same in every window), the start of the window's scan, the end of
    its greedy loop and the summed time of the loop's pass A (each step's
    cost, latency with its affinity factor read, and admission). Stored
    once as device durations, whichever of the call's windows is fetched
    first: `k1.trees` once a call, from the entry to the end of the trees
    and factors, with `aff_rows`, the rows whose factors the grid wrote
    (K R with the term on, 0 off); per window `k1.stage1`, from there to
    the scan's start (the rest of stage 1, the KNN lookup and label
    mixes, which ran beside the preamble on the grid), `k1.scan`, the
    scan's preamble and greedy loop as rank 0 of the scanning CTAs saw
    it, with `steps`, the steps its loop ran (the call's R bucket), and
    `ctas`, the CTAs that ran it (the cluster's C on the cluster carry, 1
    on the others: `kernels.decision_megakernel.carry_on`), and
    `k1.scan_a`, pass A's part of that loop; `k1.call` from the entry to
    the last window's end."""

    __slots__ = ("host", "K", "aff_rows", "steps", "ctas", "done")

    def __init__(self, host: torch.Tensor, K: int, aff_rows: int,
                 steps: int, ctas: int):
        self.host, self.K, self.aff_rows = host, K, aff_rows
        self.steps, self.ctas, self.done = steps, ctas, False

    def store(self):
        if self.done:
            return
        self.done = True
        t = self.host.tolist()
        batch = tracing.open_id("rb.fire", "batch")
        tracing.add("k1.trees", t[1] - t[0], batch=batch,
                    aff_rows=self.aff_rows)
        for w in range(self.K):
            s1, s2, s3, scan_a = t[1 + 4 * w:5 + 4 * w]
            tracing.add("k1.stage1", s2 - s1, batch=batch)
            tracing.add("k1.scan", s3 - s2, batch=batch, steps=self.steps,
                        ctas=self.ctas)
            tracing.add("k1.scan_a", scan_a, batch=batch)
        tracing.add("k1.call", max(t[3::4]) - t[0], batch=batch)


class LazyDecision:
    """An in-flight decision: the kernel's outputs are being copied into
    pinned host buffers behind a CUDA event. `fetch()` waits on that
    event, slices off the pad rows and returns numpy — idempotently."""

    __slots__ = ("_choice", "_l", "_R", "_event", "_stamps", "_out")

    def __init__(self, choice: torch.Tensor, l_chosen: torch.Tensor, R: int,
                 event, stamps: Optional[_K1Stamps] = None):
        self._choice = choice      # host tensors (pinned on CUDA)
        self._l = l_chosen
        self._R = R
        self._event = event
        self._stamps = stamps
        self._out: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._out is None:
            sp = tracing.begin("rb.fetch", True) if tracing.ON else None
            if self._event is not None:
                if sp is not None:
                    wait = tracing.begin("rb.k1_wait", True)
                    self._event.synchronize()
                    tracing.end(wait)
                else:
                    self._event.synchronize()
            self._out = (self._choice[:self._R].numpy().astype(np.int64),
                         self._l[:self._R].numpy().astype(np.float64))
            if sp is not None:
                tracing.end(sp)
                if self._stamps is not None:
                    self._stamps.store()
        return self._out


class FusedHotPath:
    """The decision kernel's host side for one attached policy: built at
    the policy's first decision after `on_attach` over the sim's roster,
    and dropped at the next attach. One call = one scheduler batch (or K
    coalesced windows) = one kernel call."""

    def __init__(self, bundle, instances, cfg):
        dev = bundle.device
        self.device = dev
        self._cuda = dev.type == "cuda"
        self._encoder = bundle.encoder      # ingest-time embedding only
        knn = bundle.knn
        self._E = bundle.encoder.dim
        self._k = knn.k
        self._eps = knn.eps
        self._x, self._xsq, self._qual, self._leng = knn.tensors()

        tier_names: List[str] = []
        for inst in instances:
            if inst.tier.name not in tier_names:
                tier_names.append(inst.tier.name)
        heads = [bundle.heads[t] for t in tier_names]
        # the roster is bucketed to a power of two like R: pad columns
        # are permanently dead (never admitted, never scored)
        I = len(instances)
        self._n_real = I
        self._Itot = bucket_pow2(I)
        self._Ipad = self._Itot - I
        tier_of_i = self._pad_i(np.array(
            [tier_names.index(i.tier.name) for i in instances], np.int32))

        def put(a):
            return torch.as_tensor(a, device=dev)
        self._tier_of_i = put(tier_of_i)
        self._m_of_i = put(self._pad_i(
            np.array([i.model_idx for i in instances], np.int32)))
        self._maxb = put(self._pad_i(
            np.array([i.tier.max_batch for i in instances], np.float32),
            fill=1.0))
        self._price_in = put(self._pad_i(
            np.array([i.tier.price_in for i in instances], np.float32)))
        self._price_out = put(self._pad_i(
            np.array([i.tier.price_out for i in instances], np.float32)))
        self._nominal = put(np.array([h.nominal_tpot for h in heads],
                                     np.float32)[tier_of_i])

        self._mode = cfg.latency_mode
        self._lpt = bool(cfg.lpt)
        self._budget_filter = bool(cfg.budget_filter)
        self._weights = tuple(float(w) for w in cfg.weights)
        # prefix affinity: staged only when its weight is nonzero; the
        # (Itot, 64) int32 sig plane is re-staged every call (it rides
        # its own version counter, not the telemetry delta machinery)
        self._w_aff = float(cfg.affinity_weight)
        if self._w_aff > 0.0:
            self._pstage = [self._host((self._Itot, SKETCH_SLOTS),
                                       torch.int32) for _ in range(2)]
            self._pflip = 0
        self._dummy_psig = torch.zeros((1, 1, 1), dtype=torch.int32,
                                       device=dev)
        self._dummy_plane = torch.zeros((1, 1), dtype=torch.int32,
                                        device=dev)
        self._use_gbm = (cfg.latency_mode != "static_prior"
                         and cfg.learned_tpot)
        if self._use_gbm:
            if any(h.model is None for h in heads):
                raise ValueError(
                    "every TPOT head must be fitted (or learned_tpot="
                    "False): unfitted " + str(
                        [t for t, h in zip(tier_names, heads)
                         if h.model is None]))
            st = pack_ensemble([h.model for h in heads])
            self._gbm = (put(st["feature"].astype(np.int32)),
                         put(st["threshold"].astype(np.float32)),
                         put(st["leaf"].astype(np.float32)),
                         put(st["base"]))
            self._depth, self._lr = int(st["depth"]), float(st["lr"])
        else:
            self._gbm = tuple(t.to(dev) for t in k1.dummy_gbm())
            self._depth, self._lr = 1, 0.1
        # delta lanes: one fixed capacity >= the mostly-dirty threshold
        # where _sync_state reseeds instead
        self._Kcap = bucket_pow2(max(8, (self._n_real + 1) // 2))
        self._stage: Dict[Tuple[int, int], list] = {}  # (Kb, Rb) -> pair
        self._sflip: Dict[Tuple[int, int], int] = {}
        self._dstage = [self._delta_set(), self._delta_set()]
        self._dflip = 0
        self._variants = set()
        # K bucket -> (device, pinned host) buffers of K1's stamps, made
        # at the first traced call of the bucket on the card
        self._k1_timers: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # carried device state: the (d, b, free, ctx) mirror and the
        # alive mask, seeded at the first call
        self._state: Optional[Tuple[torch.Tensor, ...]] = None
        self._alive_dev = None
        self._seen_tel = None
        self._seen_version = -1
        self._seen_roster = -1
        self.stats = _new_stats()

    def _host(self, shape, dtype) -> torch.Tensor:
        """A host staging tensor: pinned when the device is CUDA, so the
        upload can be asynchronous."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)

    def _up(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _pad_i(self, x: np.ndarray, fill=0) -> np.ndarray:
        """Pad an (I,) per-instance vector out to the pow2 roster bucket."""
        if self._Ipad == 0:
            return x
        return np.concatenate([x, np.full(self._Ipad, fill, x.dtype)])

    def _delta_set(self) -> Dict[str, torch.Tensor]:
        return {"idx": self._host(self._Kcap, torch.int64),
                **{k: self._host(self._Kcap, torch.float32)
                   for k in ("d", "b", "free", "ctx")}}

    # -- host side ----------------------------------------------------------
    def shape_variants(self) -> int:
        """Distinct (K bucket, R bucket) shapes the kernel has been called
        at. Roster events (fail/recover, quarantine, autoscale) flip the
        alive mask and reseed the mirror but add no variant."""
        return len(self._variants)

    def _stage_buffers(self, Kb: int, Rb: int) -> Dict[str, torch.Tensor]:
        """The preallocated host staging set for Kb windows of the pow2
        batch bucket Rb; two sets alternate so call N+1 never overwrites
        call N's in-flight upload or its answer's copy."""
        key = (Kb, Rb)
        pair = self._stage.get(key)
        if pair is None:
            def mk():
                buf = {"emb": self._host((Kb, Rb, self._E), torch.float32),
                       "prow": np.zeros((Kb, Rb), np.int32),
                       "budgets": self._host((Kb, Rb), torch.float32),
                       "len_in": self._host((Kb, Rb), torch.float32),
                       "rv": self._host((Kb, Rb), torch.bool),
                       "choice": self._host((Kb, Rb), torch.int32),
                       "l": self._host((Kb, Rb), torch.float32)}
                if self._w_aff > 0.0:
                    buf["psig"] = self._host((Kb, Rb, SIG_WIDTH),
                                             torch.int32)
                return buf
            pair = self._stage[key] = [mk(), mk()]
            self._sflip[key] = 0
        self._sflip[key] ^= 1
        return pair[self._sflip[key]]

    def _stage_window(self, s, w: int, cols, rows) -> None:
        """Gather window w's rows from the SoA ingest columns into the
        staging set; a window with no rows is a pad window (every row
        invalid: it still picks, and updates nothing)."""
        R = len(rows)
        emb, bud = s["emb"].numpy()[w], s["budgets"].numpy()[w]
        lin, rv = s["len_in"].numpy()[w], s["rv"].numpy()[w]
        if R:
            if cols.emb is None:
                raise ValueError("RequestColumns.ensure_embeddings must run "
                                 "before decide")
            prow = s["prow"][w, :R]
            np.take(cols.prompt_row, rows, out=prow)
            np.take(cols.emb, prow, axis=0, out=emb[:R])
            bud[:R] = cols.budget[rows]
            lin[:R] = cols.len_in[rows]
        emb[R:] = 0.0
        bud[R:] = np.nan
        lin[R:] = 0.0
        rv[:R] = True
        rv[R:] = False
        if self._w_aff > 0.0:
            psig = s["psig"].numpy()[w]
            if R:
                np.take(cols.prefix_sig, prow, axis=0, out=psig[:R])
            psig[R:] = 0

    def _sync_state(self, tel):
        """Refresh the device telemetry mirror from `tel` and return
        (d, b, free, ctx, alive) on the device.

        A full reseed happens on the first batch, on roster events
        (`tel.roster_version` moved), when `tel` is a new object, or when
        most of the roster is dirty. Otherwise only the rows with
        ``tel.last_write > seen_version`` are shipped and written into the
        mirror in place. Either way the mirror equals a fresh host read of
        `tel` bit for bit."""
        st = self.stats
        rows = None
        if self._state is not None and tel is self._seen_tel:
            if tel.roster_version == self._seen_roster:
                rows = tel.dirty_rows(self._seen_version)
                if 2 * len(rows) > self._n_real:
                    rows = None              # mostly dirty: reseed outright
            else:
                st["roster_reseed"] += 1
        self._seen_version = tel.version
        if rows is None:
            self._seen_tel = tel
            self._seen_roster = tel.roster_version
            # torch.tensor copies: the mirror never aliases `tel`
            self._state = tuple(
                torch.tensor(self._pad_i(np.asarray(a, np.float32)),
                             device=self.device)
                for a in (tel.pending, tel.batch, tel.free, tel.ctx))
            self._alive_dev = torch.tensor(
                self._pad_i(np.asarray(tel.alive), fill=False),
                device=self.device)
            st["full_reseed"] += 1
            return self._state + (self._alive_dev,)
        K = len(rows)
        if K == 0:
            st["carry"] += 1
            return self._state + (self._alive_dev,)
        st["delta_sync"] += 1
        st["delta_rows"] += K
        self._dflip ^= 1
        buf = self._dstage[self._dflip]
        buf["idx"][:K] = torch.from_numpy(rows)
        for name, col in (("d", tel.pending), ("b", tel.batch),
                          ("free", tel.free), ("ctx", tel.ctx)):
            buf[name][:K] = torch.from_numpy(col[rows].astype(np.float32))
        # only the K live lanes are written: the reference's drop-mode
        # scatter of out-of-range lanes has no torch equivalent
        idx = self._up(buf["idx"][:K])
        for mirror, name in zip(self._state, ("d", "b", "free", "ctx")):
            mirror.index_copy_(0, idx, self._up(buf[name][:K]))
        return self._state + (self._alive_dev,)

    def decide_cols(self, cols, rows: np.ndarray, tel) -> LazyDecision:
        """One scheduler batch as a row slice into the SoA ingest columns:
        `decide_cols_multi` with one window."""
        return self.decide_cols_multi([(cols, rows)], tel)[0]

    def decide_cols_multi(self, batches, tel) -> List[LazyDecision]:
        """K scheduler windows sharing ONE kernel call. `batches` is a list
        of (cols, rows) window slices; returns one `LazyDecision` per
        window, in order. The windows are staged into the pinned
        double-buffered host set, the device telemetry mirror is synced,
        the kernel is called once, and the copy of its answers back to
        the host is queued behind an event.

        All windows decide from the same telemetry snapshot — exactly
        what K back-to-back `decide_cols` calls produce when telemetry
        has not moved between them (each call reseeds the mirror from
        `tel`; dead-reckoned state never carries across batches) — so
        coalescing is assignment-exact while paying one kernel call, one
        mirror sync and one staging pass for the K windows. Window count
        and row count both bucket to powers of two (pad windows hold only
        invalid rows), keeping shape variants at O(log K · log R)."""
        K = len(batches)
        self.stats["calls"] += K
        if K > 1:
            self.stats["multi_dispatch"] += 1
        sp = tracing.begin("rb.stage", True) if tracing.ON else None
        t0 = time.perf_counter()
        Kb = bucket_pow2(K, lo=1)
        s = self._stage_buffers(
            Kb, bucket_pow2(max(len(rows) for _, rows in batches)))
        for w, (cols, rows) in enumerate(batches):
            self._stage_window(s, w, cols, rows)
        for w in range(K, Kb):
            self._stage_window(s, w, None, ())
        return self._dispatch(s, tel, t0, [len(rows) for _, rows in batches],
                              sp)

    def _dispatch(self, s, tel, t0: float, sizes,
                  sp: Optional[tracing.Span] = None) -> List[LazyDecision]:
        """The tail of a decision call on the staged set `s` (Kb
        windows of Rb rows): stage the affinity plane, sync the device
        mirror, call the kernel once, and queue the copy of its answer
        back behind an event. One `LazyDecision` per real window, of
        `sizes[w]` rows. `sp` is the call's open `rb.stage` span, ended
        here with the traced spans after it (None: tracing off)."""
        st = self.stats
        if self._w_aff > 0.0:
            psp = tracing.begin("rb.plane", True) if sp is not None else None
            self._pflip ^= 1
            plane = self._pstage[self._pflip]
            plane.numpy()[:self._n_real] = tel.prefix_sig
            psig_d, plane_d = self._up(s["psig"]), self._up(plane)
            if psp is not None:
                tracing.end(psp, rows=self._n_real,
                            bytes=plane.nbytes + s["psig"].nbytes)
        else:
            psig_d, plane_d = self._dummy_psig, self._dummy_plane
        t1 = time.perf_counter()
        Kb = s["rv"].shape[0]
        if sp is None:
            d, b, free, ctx, alive = self._sync_state(tel)
            timers = None
        else:
            tracing.end(sp, K=Kb, R=s["rv"].shape[1])
            d, b, free, ctx, alive = self._traced_sync(tel)
            sp = tracing.begin("rb.launch", True)
            timers = self._timers(Kb)
        t2 = time.perf_counter()
        choice, _, l_chosen, *_ = k1.decision_megakernel(
            self._up(s["emb"]), self._up(s["rv"]), self._up(s["budgets"]),
            self._up(s["len_in"]), psig_d, d, b, free, ctx, alive,
            self._x, self._xsq, self._qual, self._leng,
            self._m_of_i, self._tier_of_i, self._maxb, self._price_in,
            self._price_out, self._nominal, plane_d, *self._gbm,
            k=self._k, eps=self._eps, weights=self._weights,
            latency_mode=self._mode, lpt=self._lpt,
            budget_filter=self._budget_filter, w_aff=self._w_aff,
            use_gbm=self._use_gbm, depth=self._depth, lr=self._lr,
            timers=None if timers is None else timers[0])
        self._variants.add(tuple(s["rv"].shape))
        event = stamps = None
        if self._cuda:
            s["choice"].copy_(choice, non_blocking=True)
            s["l"].copy_(l_chosen, non_blocking=True)
            if timers is not None:
                timers[1].copy_(timers[0], non_blocking=True)
                Rb = s["rv"].shape[1]
                _, ctas = k1.carry_on(self.device, Kb, Rb, self._x.shape[1],
                                      self._qual.shape[1], self._Itot)
                stamps = _K1Stamps(timers[1], Kb,
                                   Kb * Rb if self._w_aff > 0.0 else 0, Rb,
                                   ctas)
            event = torch.cuda.Event()
            event.record()
            choice, l_chosen = s["choice"], s["l"]
        t3 = time.perf_counter()
        if sp is not None:
            tracing.end(sp)
        st["stage_s"] += t1 - t0
        st["host_s"] += t2 - t0
        st["dispatch_s"] += t3 - t2
        return [LazyDecision(choice[w], l_chosen[w], R, event, stamps)
                for w, R in enumerate(sizes)]

    def _traced_sync(self, tel):
        """`_sync_state` inside an `rb.sync` span, its kind and the rows
        it shipped read off the stats' counters."""
        st = self.stats
        before = (st["roster_reseed"], st["full_reseed"], st["delta_sync"],
                  st["delta_rows"])
        sp = tracing.begin("rb.sync", True)
        out = self._sync_state(tel)
        if st["roster_reseed"] > before[0]:
            kind, rows = 3, self._n_real
        elif st["full_reseed"] > before[1]:
            kind, rows = 2, self._n_real
        elif st["delta_sync"] > before[2]:
            kind, rows = 1, st["delta_rows"] - before[3]
        else:
            kind, rows = 0, 0
        tracing.end(sp, kind=kind, rows=rows)
        return out

    def _timers(self, Kb: int):
        """(device, pinned host) buffers for K1's stamps of a Kb-window
        call on the card; None on the CPU, where the plain version has no
        stamps."""
        if not self._cuda:
            return None
        bufs = self._k1_timers.get(Kb)
        if bufs is None:
            bufs = self._k1_timers[Kb] = (
                torch.zeros(1 + 4 * Kb, dtype=torch.int64,
                            device=self.device),
                self._host(1 + 4 * Kb, torch.int64))
        return bufs

    def decide(self, batch, tel) -> Tuple[np.ndarray, np.ndarray]:
        """AoS entry (direct callers, tests): derive the column slice
        from the request list, then fetch eagerly. Returns (choice (R,)
        int64 indexing the FULL instance roster, l_chosen (R,))."""
        from ..serving.request import RequestColumns
        cols, rows = RequestColumns.for_batch(batch, self._encoder)
        return self.decide_cols(cols, rows, tel).fetch()
