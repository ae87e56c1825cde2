"""The plain reference of one RouteBalance decision, and of the
hierarchy's placement.

Written from the decision's definition in plain PyTorch and NumPy:
the sentence encoder over the benchmark's weights, the KNN quality and
length estimate over an index built from its own embeddings, one
gradient-boosted TPOT head per tier fitted on the benchmark's training
pairs, Eq. 2 admission, the Eq. 1 score on its 2^-13 grid and the
LPT-ordered greedy scan with dead reckoning, with the prefix-affinity
discount (`yard.affinity`) where the configuration's
`scheduler.rbconfig.affinity_weight` is above 0. It takes nothing the
program made: the embeddings, the index, the trees and the telemetry
mirror are worked out again here from the inputs the benchmark handed
to both sides.

`tf32=True` is the control: every matrix product (the encoder's and the
KNN distances') takes its operands rounded to TF32's 10-bit mantissa,
as tensor cores do with TF32 on, and accumulates in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import affinity as aff_mod

SCORE_QUANTUM = 2.0 ** -13


# -- arithmetic ------------------------------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest
    even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


# -- the sentence encoder -----------------------------------------------------------

class Encoder:
    """Hashed token embeddings -> layers of masked attention and a GELU
    MLP with RMS normalization -> masked mean pool -> projection -> L2
    normalization."""

    def __init__(self, params: Dict, n_heads: int, device="cpu"):
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.embed, self.pos, self.out = (put(params[k])
                                          for k in ("embed", "pos", "out"))
        self.layers = [{k: put(v) for k, v in lp.items()}
                       for lp in params["layers"]]
        self.n_heads = n_heads
        self.device = device

    @torch.no_grad()
    def encode(self, tokens: np.ndarray, lens: np.ndarray, tf32=False,
               chunk: int = 1024) -> np.ndarray:
        """tokens (B, L) int, lens (B,) -> (B, D) float32."""
        out = []
        for i in range(0, len(tokens), chunk):
            out.append(self._forward(tokens[i:i + chunk],
                                     lens[i:i + chunk], tf32))
        return np.concatenate(out) if out else np.zeros(
            (0, self.out.shape[1]), np.float32)

    def _forward(self, tokens, lens, tf32):
        dev = self.device
        L = tokens.shape[1]
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        mask = torch.as_tensor(np.arange(L)[None, :]
                               < np.asarray(lens)[:, None], device=dev)
        V = self.embed.shape[0]
        h = self.embed[tok % V] + self.pos[None, :L]
        B, _, D = h.shape
        nh = self.n_heads
        hd = D // nh
        for lp in self.layers:
            q = mm(h, lp["wq"], tf32).reshape(B, L, nh, hd).transpose(1, 2)
            k = mm(h, lp["wk"], tf32).reshape(B, L, nh, hd).transpose(1, 2)
            v = mm(h, lp["wv"], tf32).reshape(B, L, nh, hd).transpose(1, 2)
            s = mm(q, k.transpose(-1, -2), tf32) * hd ** -0.5
            s = torch.where(mask[:, None, None, :], s, -1e30)
            o = mm(torch.softmax(s, dim=-1), v, tf32)
            h = h + mm(o.transpose(1, 2).reshape(B, L, D), lp["wo"], tf32)
            u = mm(h, lp["w1"], tf32)
            h = h + mm(torch.nn.functional.gelu(u, approximate="tanh"),
                       lp["w2"], tf32)
            h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6)
        mf = mask[..., None].float()
        pooled = (h * mf).sum(1) / mf.sum(1).clamp_min(1.0)
        e = mm(pooled, self.out, tf32)
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        return e.cpu().numpy()


# -- the KNN estimate -----------------------------------------------------------------

def knn_estimate(q: np.ndarray, x: torch.Tensor, quality: np.ndarray,
                 lengths: np.ndarray, k: int, eps: float, tf32=False):
    """Distance-weighted mix of the k nearest rows' labels:
    (quality (B, M), length (B, M)) float32."""
    qt = torch.as_tensor(np.asarray(q, np.float32), device=x.device)
    d2 = ((x * x).sum(1)[None, :] - 2.0 * mm(qt, x.T, tf32)
          + (qt * qt).sum(1, keepdim=True))
    d2k, idx = torch.sort(d2, dim=1, stable=True)
    d2k, idx = d2k[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
    w = 1.0 / (np.sqrt(np.maximum(d2k, 0.0)) + np.float32(eps))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    qm = (quality[idx] * w[..., None]).sum(1).astype(np.float32)
    lm = (lengths[idx] * w[..., None]).sum(1).astype(np.float32)
    return qm, lm


# -- gradient-boosted TPOT heads ------------------------------------------------------------

@dataclasses.dataclass
class Trees:
    feature: np.ndarray      # (T, 2^depth - 1) int
    threshold: np.ndarray    # (T, 2^depth - 1) float32
    leaf: np.ndarray         # (T, 2^depth) float32
    base: float
    lr: float
    depth: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        out = np.full(len(X), self.base, np.float32)
        rows = np.arange(len(X))
        for j in range(len(self.feature)):
            idx = np.zeros(len(X), np.int64)
            for _ in range(self.depth):
                go = X[rows, self.feature[j][idx]] > self.threshold[j][idx]
                idx = 2 * idx + 1 + go
            out += np.float32(self.lr) * self.leaf[j][
                idx - (2 ** self.depth - 1)]
        return out


def fit_trees(X, y, n_trees: int, depth: int, learning_rate: float,
              n_bins: int, min_child: int, lam: float) -> Trees:
    """Histogram gradient boosting on squared error: each tree splits
    every node of a level on the best quantile bin of any feature."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n, f = X.shape
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    bins = np.percentile(X, qs, axis=0)
    Xb = np.stack([np.searchsorted(bins[:, j], X[:, j], side="right")
                   for j in range(f)], axis=1)
    base = float(y.mean())
    pred = np.full(n, base, np.float32)
    feats, thrs, leaves = [], [], []
    for _ in range(n_trees):
        g = y - pred
        feature = np.zeros(n_int, np.int64)
        threshold = np.full(n_int, np.inf, np.float32)
        node = np.zeros(n, np.int64)
        for d in range(depth):
            for nd in range(2 ** d - 1, 2 ** (d + 1) - 1):
                rows = node == nd
                cnt = int(rows.sum())
                if cnt < 2 * min_child:
                    continue
                gs, xb = g[rows], Xb[rows]
                total = gs.sum()
                best = (0.0, -1, -1)
                for j in range(f):
                    sums = np.bincount(xb[:, j], weights=gs,
                                       minlength=n_bins)
                    cnts = np.bincount(xb[:, j], minlength=n_bins)
                    csum, ccnt = np.cumsum(sums)[:-1], np.cumsum(cnts)[:-1]
                    ok = (ccnt >= min_child) & ((cnt - ccnt) >= min_child)
                    if not ok.any():
                        continue
                    gain = (csum ** 2 / (ccnt + lam)
                            + (total - csum) ** 2 / (cnt - ccnt + lam)
                            - total ** 2 / (cnt + lam))
                    gain = np.where(ok, gain, -np.inf)
                    b = int(np.argmax(gain))
                    if gain[b] > best[0]:
                        best = (float(gain[b]), j, b)
                if best[1] >= 0:
                    feature[nd] = best[1]
                    threshold[nd] = (bins[best[2], best[1]]
                                     if best[2] < bins.shape[0] else np.inf)
            go = X[np.arange(n), feature[node]] > threshold[node]
            node = 2 * node + 1 + go
        leaf_idx = node - n_int
        cnts = np.bincount(leaf_idx, minlength=n_leaf)
        sums = np.bincount(leaf_idx, weights=g, minlength=n_leaf)
        leaf = np.zeros(n_leaf, np.float32)
        nz = cnts > 0
        leaf[nz] = (sums[nz] / (cnts[nz] + lam)).astype(np.float32)
        pred += np.float32(learning_rate) * leaf[leaf_idx]
        feats.append(feature)
        thrs.append(threshold)
        leaves.append(leaf)
    return Trees(np.stack(feats), np.stack(thrs), np.stack(leaves), base,
                 learning_rate, depth)


# -- the reference itself ------------------------------------------------------------------

class Reference:
    """Everything the reference derives once: embeddings of the train
    split, the index, and one fitted head per tier.

    cfg: the configuration file; world: `yard.world.WorldArrays`;
    params: the encoder weights; pairs: the per-tier training pairs."""

    def __init__(self, cfg: Dict, world, params: Dict, pairs, device="cpu",
                 tf32: bool = False):
        est = cfg["estimators"]
        self.cfg = cfg
        self.tf32 = tf32
        self.k, self.eps = est["knn_k"], est["knn_eps"]
        self.max_len = est["encoder"]["max_len"]
        self.encoder = Encoder(params, est["encoder"]["n_heads"], device)
        self.world = world
        tr = world.train_idx
        self.x = torch.as_tensor(self.embed(tr), device=device)
        self.quality = world.quality[tr].astype(np.float32)
        self.lengths = world.lengths[tr].astype(np.float32)
        self.w_aff = float(cfg["scheduler"]["rbconfig"].get(
            "affinity_weight", 0.0))
        g = est["gbm"]
        self.trees = [fit_trees(X, y, g["n_trees"], g["depth"],
                                g["learning_rate"], g["n_bins"],
                                g["min_child"], g["lam"])
                      for X, y in pairs]

    def row_tokens(self, prompt_ids: np.ndarray,
                   tokens: Optional[Sequence] = None) -> List[np.ndarray]:
        """Each row's tokens: its own where `tokens` gives them (a
        session turn), else its world row's."""
        return [self.world.tokens[i] if tokens is None or tokens[r] is None
                else tokens[r] for r, i in enumerate(prompt_ids)]

    def embed(self, prompt_ids: np.ndarray, tf32: Optional[bool] = None,
              tokens: Optional[Sequence] = None) -> np.ndarray:
        """Embeddings of prompts (rows of the world, or the rows' own
        `tokens` where given) as float32."""
        from .world import pad_tokens
        rows = self.row_tokens(prompt_ids, tokens)
        toks = pad_tokens(rows, self.max_len)
        lens = np.array([min(len(t), self.max_len) for t in rows])
        return self.encoder.encode(toks, lens,
                                   self.tf32 if tf32 is None else tf32)

    def estimates(self, prompt_ids: np.ndarray,
                  tokens: Optional[Sequence] = None):
        """(quality (R, M), length (R, M)) of the prompts."""
        return knn_estimate(self.embed(prompt_ids, tokens=tokens), self.x,
                            self.quality, self.lengths, self.k, self.eps,
                            self.tf32)

    def tpot(self, roster, b, d, ctx) -> np.ndarray:
        """(I,) predicted TPOT of every instance from its telemetry."""
        f32 = np.float32
        b_eff = np.maximum(b.astype(f32), f32(1.0))
        ctx_eff = np.maximum(ctx.astype(f32), f32(64.0))
        X = np.stack([b_eff, d.astype(f32), ctx_eff, b_eff * ctx_eff], 1)
        out = np.zeros(len(b), f32)
        for t in np.unique(roster.tier):
            rows = np.flatnonzero(roster.tier == t)
            out[rows] = self.trees[t].predict(X[rows])
        return np.maximum(out, f32(1e-4))


@dataclasses.dataclass
class Roster:
    """A controller's roster in its own row order: tier index, model
    index, max batch, and per-token prices of every instance."""
    tier: np.ndarray
    model: np.ndarray
    max_batch: np.ndarray
    price_in: np.ndarray
    price_out: np.ndarray


def roster_of(tiers: List[Dict], model_names: List[str]) -> Roster:
    tier, model, mb, pin, pout = [], [], [], [], []
    for j, t in enumerate(tiers):
        n = t["n_instances"]
        tier += [j] * n
        model += [model_names.index(t["model"])] * n
        mb += [t["max_batch"]] * n
        pin += [t["price_in"]] * n
        pout += [t["price_out"]] * n
    f32 = np.float32
    return Roster(np.array(tier), np.array(model), np.array(mb, f32),
                  np.array(pin, f32), np.array(pout, f32))


def partition(roster: Roster, n_cells: int) -> List[np.ndarray]:
    """Cell c's instances (ascending rows): within each tier, instances
    go to cells in turn, continuing the count across tiers."""
    cell_of = np.arange(len(roster.tier)) % n_cells
    order = np.argsort(roster.tier, kind="stable")
    cells = np.empty(len(order), np.int64)
    cells[order] = cell_of
    return [np.flatnonzero(cells == c) for c in range(n_cells)]


def sub_roster(roster: Roster, rows: np.ndarray) -> Roster:
    return Roster(*(a[rows] for a in dataclasses.astuple(roster)))


def masked_score(q, c, t, weights, allowed):
    wq, wl, wc = (np.float32(w) for w in weights)
    cmax = np.maximum(np.max(np.where(allowed, c, -np.inf)), 1e-12)
    tmax = np.maximum(np.max(np.where(allowed, t, -np.inf)), 1e-12)
    s = (wq * q + wc * (np.float32(1.0) - c / np.float32(cmax))
         + wl * (np.float32(1.0) - t / np.float32(tmax)))
    s = np.round(s * (1.0 / SCORE_QUANTUM)) * SCORE_QUANTUM
    return np.where(allowed, s, -np.inf)


@dataclasses.dataclass
class Batch:
    """One decided batch as the check sees it: the stream rows' prompts,
    budgets and prompt lengths, the telemetry snapshot the decision read,
    and the program's answer (instance row, predicted length). `tokens`
    holds each row's own tokens where it is a session turn (None for the
    rest, or for a batch without sessions); `prefix_sig` the (I, 64)
    prefix plane the decision read, where the affinity weight is above
    0."""
    prompts: np.ndarray
    budget: np.ndarray
    len_in: np.ndarray
    pending: np.ndarray
    batch: np.ndarray
    free: np.ndarray
    ctx: np.ndarray
    alive: np.ndarray
    choice: np.ndarray
    l_chosen: np.ndarray
    cell: int = 0
    tokens: Optional[List] = None
    prefix_sig: Optional[np.ndarray] = None


def check_batch(ref: Reference, roster: Roster, bt: Batch, weights,
                ctl: Optional[Reference] = None) -> Dict[str, np.ndarray]:
    """Follow the program's choices through the LPT scan and read, for
    every row: `gap`, how far the program's instance scores below the
    reference's best (inf where Eq. 2 does not admit it), and `l_err`,
    the relative error of the program's predicted length at its
    instance. With `ctl`, the same two readings for the instance that
    the control puts first at each row, on the same state. `aff_moved`
    marks the rows whose best instance the affinity term moves (all
    False where its weight is 0)."""
    f32 = np.float32
    qmix, lmix = ref.estimates(bt.prompts, bt.tokens)
    q_i, l_i = qmix[:, roster.model], lmix[:, roster.model]
    tpot = ref.tpot(roster, bt.batch, bt.pending, bt.ctx)
    alive = bt.alive.astype(bool)
    budget, len_in = bt.budget.astype(f32), bt.len_in.astype(f32)

    def admit(l_inst):
        c = ((len_in[:, None] * roster.price_in[None, :]
              + l_inst * roster.price_out[None, :]) * f32(1e-6))
        ok = np.where(np.isnan(budget)[:, None], True,
                      c <= budget[:, None]) & alive[None, :]
        cheapest = np.argmin(np.where(alive[None, :], c, np.inf), axis=1)
        none = ~ok.any(1)
        ok[none] = False
        ok[none, cheapest[none]] = True
        return ok, c
    allowed, c_hat = admit(l_i)
    order = np.argsort(-lmix.max(1), kind="stable")
    R = len(order)
    out = {"gap": np.zeros(R), "l_err": np.zeros(R),
           "aff_moved": np.zeros(R, bool)}
    aff = None
    if ref.w_aff > 0.0:
        hit = aff_mod.hit_fraction(
            aff_mod.signatures(ref.row_tokens(bt.prompts, bt.tokens)),
            len_in, bt.prefix_sig)
        aff = f32(ref.w_aff) * np.where(alive[None, :], hit, f32(0.0))
    if ctl is not None:
        cq, cl = ctl.estimates(bt.prompts, bt.tokens)
        cq_i, cl_i = cq[:, roster.model], cl[:, roster.model]
        c_tpot = ctl.tpot(roster, bt.batch, bt.pending, bt.ctx)
        c_allowed, c_c = admit(cl_i)
        out.update(ctl_gap=np.zeros(R), ctl_l_err=np.zeros(R))
    b0 = np.maximum(bt.batch.astype(f32), f32(1.0))
    states = [[bt.pending.astype(f32).copy(), b0.copy(),
               bt.free.astype(f32).copy()]]
    if ctl is not None:
        states.append([s.copy() for s in states[0]])

    def latency(st, tp, l_row, a_row=None):
        d, b, free = st
        wait = np.where(free > 0, f32(0.0), d / np.maximum(b, f32(1.0)))
        t = tp * np.maximum(b / b0, f32(1.0)) * (wait + l_row)
        return t if a_row is None else t * (f32(1.0) - a_row)

    def step(st, i, l_val):
        d, b, free = st
        d[i] += l_val
        if free[i] > 0:
            free[i] -= 1
            b[i] = min(b[i] + 1, roster.max_batch[i])
    for r in order:
        p = int(bt.choice[r])
        a_r = None if aff is None else aff[r]
        s = masked_score(q_i[r], c_hat[r],
                         latency(states[0], tpot, l_i[r], a_r), weights,
                         allowed[r])
        out["gap"][r] = s.max() - s[p]
        if aff is not None:
            s0 = masked_score(q_i[r], c_hat[r],
                              latency(states[0], tpot, l_i[r]), weights,
                              allowed[r])
            out["aff_moved"][r] = np.argmax(s) != np.argmax(s0)
        out["l_err"][r] = abs(float(bt.l_chosen[r]) - float(l_i[r, p])) \
            / max(abs(float(l_i[r, p])), 1e-30)
        if ctl is not None:
            sc = masked_score(cq_i[r], c_c[r],
                              latency(states[1], c_tpot, cl_i[r], a_r),
                              weights, c_allowed[r])
            c = int(np.argmax(sc))
            out["ctl_gap"][r] = s.max() - s[c]
            out["ctl_l_err"][r] = abs(float(cl_i[r, c]) - float(l_i[r, c])) \
                / max(abs(float(l_i[r, c])), 1e-30)
            step(states[1], p, cl_i[r, p])
        step(states[0], p, l_i[r, p])
    return out


# -- the hierarchy's placement ---------------------------------------------------------------

def replay_placement(roster: Roster, cells: Sequence[np.ndarray],
                     events: List, hcfg: Dict, n_tiers: int) -> np.ndarray:
    """Replay the global balancer over the recorded heartbeats and
    arrivals in the order they happened, following the program's
    placements. `events` holds ("beat", t, planes) with the fleet's
    telemetry planes (alive, batch, pending, queue, free) at the beat,
    and ("pick", t, cell) with the program's cell. Returns, for every
    pick, the cell the reference places it in."""
    C = len(cells)
    stale = hcfg["digest_stale_s"]
    decay = hcfg["staleness_decay"]
    digests = {}
    last_beat = {c: 0.0 for c in range(C)}
    since = np.zeros(C, np.int64)
    total = np.zeros(C, np.int64)
    quantum, fleet_depth = 1.0, None
    picks = []
    for ev in events:
        if ev[0] == "beat":
            _, t, pl = ev
            placed = int(since.sum())
            for c, rows in enumerate(cells):
                a = pl["alive"][rows].astype(bool)
                tos = roster.tier[rows][a]

                def wsum(w):
                    return np.bincount(tos, weights=np.asarray(
                        w, np.float64)[rows][a], minlength=n_tiers
                    ).astype(np.float32)
                depth = wsum(pl["pending"] + pl["queue"])
                digests[c] = (t, int(a.sum()), float(depth.sum()),
                              float(wsum(pl["free"]).sum()))
                last_beat[c] = t
            since[:] = 0
            depth = sum(d[2] for d in digests.values())
            if fleet_depth is not None and placed > 0:
                q = max(1.0, (depth - fleet_depth) / placed)
                quantum = 0.5 * quantum + 0.5 * q
            fleet_depth = depth
            continue
        _, t, prog = ev
        best, best_key = None, None
        for c in range(C):
            d = digests.get(c)
            if d is None or t - d[0] > stale or d[1] == 0:
                continue
            pen = 1.0 + decay * max(t - last_beat[c], 0.0) / max(stale, 1e-9)
            load = pen * (d[2] + quantum * since[c] + 1.0) / (d[3] + 1.0)
            key = (load, total[c], c)
            if best_key is None or key < best_key:
                best, best_key = c, key
        picks.append(-1 if best is None else best)
        since[prog] += 1
        total[prog] += 1
    return np.array(picks, np.int64)
