"""Gradient-boosted regression trees — the XGBoost stand-in for the
per-(model, GPU)-tier TPOT heads (§4.2).

Port of `repro.estimators.gbm`: the numpy histogram fit, `pack` and
`pack_ensemble` are copies (training stays on the host), and the packed
inference is torch: `predict_packed` (every tree against every row) and
the one the decision runs, `predict_packed_gathered` (each row against
its own member's trees). Both accumulate through `_accumulate`, which
adds the trees one by one in float32, the numpy ensemble's rounding
order, so packed inference is bitwise the numpy `predict`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray      # (n_internal,) int32
    threshold: np.ndarray    # (n_internal,) float32
    leaf: np.ndarray         # (n_leaves,)  float32
    depth: int

    def leaves(self, X: np.ndarray) -> np.ndarray:
        """(n,) leaf index per row — the exact traversal result, used by
        the packed-parity tests."""
        idx = np.zeros(X.shape[0], np.int64)
        for _ in range(self.depth):
            f = self.feature[idx]
            t = self.threshold[idx]
            go_right = X[np.arange(X.shape[0]), f] > t
            idx = 2 * idx + 1 + go_right
        return idx - (2 ** self.depth - 1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.leaf[self.leaves(X)]


def _fit_tree(X, g, depth: int, n_bins: int, min_child: int,
              lam: float) -> _Tree:
    n, f = X.shape
    n_internal = 2 ** depth - 1
    n_leaves = 2 ** depth
    feature = np.zeros(n_internal, np.int32)
    threshold = np.full(n_internal, np.inf, np.float32)
    node = np.zeros(n, np.int64)           # current node per row

    # global quantile bins per feature
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    bins = np.percentile(X, qs, axis=0)    # (n_bins-1, f)
    Xb = np.empty((n, f), np.int16)
    for j in range(f):
        Xb[:, j] = np.searchsorted(bins[:, j], X[:, j], side="right")

    for d in range(depth):
        level = range(2 ** d - 1, 2 ** (d + 1) - 1)
        for nd in level:
            rows = node == nd
            cnt = int(rows.sum())
            if cnt < 2 * min_child:
                feature[nd] = 0
                threshold[nd] = np.inf   # all go left
                continue
            gs = g[rows]
            xb = Xb[rows]
            best = (0.0, -1, -1)
            total = gs.sum()
            for j in range(f):
                sums = np.bincount(xb[:, j], weights=gs, minlength=n_bins)
                cnts = np.bincount(xb[:, j], minlength=n_bins)
                csum = np.cumsum(sums)[:-1]
                ccnt = np.cumsum(cnts)[:-1]
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
                                 if best[2] < bins.shape[0]
                                 else np.inf)
        # route rows one level down
        f_nd = feature[node]
        t_nd = threshold[node]
        go_right = X[np.arange(n), f_nd] > t_nd
        node = 2 * node + 1 + go_right

    leaf_idx = node - n_internal
    leaf = np.zeros(n_leaves, np.float32)
    cnts = np.bincount(leaf_idx, minlength=n_leaves)
    sums = np.bincount(leaf_idx, weights=g, minlength=n_leaves)
    nzero = cnts > 0
    leaf[nzero] = (sums[nzero] / (cnts[nzero] + lam)).astype(np.float32)
    return _Tree(feature, threshold, leaf, depth)


class GradientBoostedRegressor:
    def __init__(self, n_trees: int = 80, depth: int = 4,
                 learning_rate: float = 0.15, n_bins: int = 64,
                 min_child: int = 8, lam: float = 1.0):
        self.n_trees = n_trees
        self.depth = depth
        self.lr = learning_rate
        self.n_bins = n_bins
        self.min_child = min_child
        self.lam = lam
        self.base = 0.0
        self.trees: List[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.base = float(y.mean())
        pred = np.full(y.shape, self.base, np.float32)
        self.trees = []
        for _ in range(self.n_trees):
            resid = y - pred
            tree = _fit_tree(X, resid, self.depth, self.n_bins,
                             self.min_child, self.lam)
            upd = tree.predict(X)
            pred += self.lr * upd
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        out = np.full(X.shape[0], self.base, np.float32)
        for t in self.trees:
            out += self.lr * t.predict(X)
        return out

    def leaf_indices(self, X: np.ndarray) -> np.ndarray:
        """(T, n) leaf index per (tree, row) — numpy reference for the
        packed traversal."""
        X = np.asarray(X, np.float32)
        return np.stack([t.leaves(X) for t in self.trees])

    # -- packed arrays for device inference -----------------------------------
    @staticmethod
    def from_packed(packed) -> "GradientBoostedRegressor":
        """Rebuild a fitted booster from `pack()` output (numpy arrays
        plus base/lr/depth) — how weights trained elsewhere are carried
        across."""
        feat = np.asarray(packed["feature"], np.int32)
        thr = np.asarray(packed["threshold"], np.float32)
        leaf = np.asarray(packed["leaf"], np.float32)
        depth = int(packed["depth"])
        m = GradientBoostedRegressor(n_trees=feat.shape[0], depth=depth,
                                     learning_rate=float(packed["lr"]))
        m.base = float(packed["base"])
        m.trees = [_Tree(feat[j].copy(), thr[j].copy(), leaf[j].copy(),
                         depth) for j in range(feat.shape[0])]
        return m

    def pack(self):
        feat = np.stack([t.feature for t in self.trees])
        thr = np.stack([t.threshold for t in self.trees])
        leaf = np.stack([t.leaf for t in self.trees])
        return {"feature": feat, "threshold": thr, "leaf": leaf,
                "base": self.base, "lr": self.lr, "depth": self.depth}


def pack_ensemble(models: List["GradientBoostedRegressor"]):
    """Stack several same-shape boosters into one packed dict with a
    leading member axis — e.g. the per-tier TPOT heads fused into one
    device-resident gather for the single-dispatch hot path."""
    packs = [m.pack() for m in models]
    assert len({p["depth"] for p in packs}) == 1, "depth mismatch"
    assert len({p["lr"] for p in packs}) == 1, "learning-rate mismatch"
    assert len({p["feature"].shape for p in packs}) == 1, "tree-count mismatch"
    return {"feature": np.stack([p["feature"] for p in packs]),
            "threshold": np.stack([p["threshold"] for p in packs]),
            "leaf": np.stack([p["leaf"] for p in packs]),
            "base": np.array([p["base"] for p in packs], np.float32),
            "lr": packs[0]["lr"], "depth": packs[0]["depth"]}


def _accumulate(base, lr, vals):
    """base + sum_j lr * vals[..., j, :] accumulated tree by tree in
    float32 — the rounding order of `GradientBoostedRegressor.predict`.
    base is a tensor broadcastable to the output."""
    out = torch.zeros(vals.shape[:-2] + vals.shape[-1:],
                      dtype=torch.float32, device=vals.device) + base
    for j in range(vals.shape[-2]):
        out = out + lr * vals[..., j, :]
    return out


def predict_packed(packed, X, return_leaves: bool = False):
    """Inference over one booster's packed trees (`pack()`), every tree
    against every row: X (n, f) -> (n,) float32, and with
    `return_leaves` the leaf index of each (tree, row) as (T, n) int32.
    One gather per depth level over all T trees at once; the trees are
    added through `_accumulate`. Runs where X lies (a tensor), else on
    the card (`resolve_device`)."""
    from ..core.device import resolve_device
    dev = X.device if isinstance(X, torch.Tensor) else resolve_device(None)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    feat = torch.as_tensor(packed["feature"], device=dev).long()  # (T, n_int)
    thr = torch.as_tensor(packed["threshold"], dtype=torch.float32,
                          device=dev)
    leaf = torch.as_tensor(packed["leaf"], dtype=torch.float32, device=dev)
    idx = torch.zeros((feat.shape[0], X.shape[0]), dtype=torch.int64,
                      device=dev)
    for _ in range(packed["depth"]):
        f = feat.gather(1, idx)                         # (T, n)
        t = thr.gather(1, idx)
        xv = X.T.gather(0, f)                           # X[row, f]
        idx = 2 * idx + 1 + (xv > t).long()
    leaf_idx = idx - (2 ** packed["depth"] - 1)
    vals = leaf.gather(1, leaf_idx)                     # (T, n)
    base = torch.as_tensor(packed["base"], dtype=torch.float32, device=dev)
    out = _accumulate(base, packed["lr"], vals)
    if return_leaves:
        return out, leaf_idx.to(torch.int32)
    return out


def predict_packed_gathered(stacked, member, X):
    """Per-row member selection over a `pack_ensemble` stack, in torch.

    stacked: the packed dict with tensor `feature`/`threshold`/`leaf`/
    `base` on the decision's device; member (n,) int — which booster
    scores each row; X (n, f) float32. Returns (n,). Each row walks its
    own member's trees, one gather per depth level."""
    feat = stacked["feature"][member].long()            # (n, T, n_int)
    thr = stacked["threshold"][member]
    leaf = stacked["leaf"][member]
    T = feat.shape[1]
    idx = torch.zeros((X.shape[0], T), dtype=torch.int64, device=X.device)
    for _ in range(stacked["depth"]):
        f = feat.gather(2, idx[:, :, None])[..., 0]
        t = thr.gather(2, idx[:, :, None])[..., 0]
        xv = X.gather(1, f)                             # (n, T)
        idx = 2 * idx + 1 + (xv > t).long()
    leaf_idx = idx - (2 ** stacked["depth"] - 1)
    vals = leaf.gather(2, leaf_idx[:, :, None])[..., 0]  # (n, T)
    base = stacked["base"][member]
    return _accumulate(base, stacked["lr"], vals.T)
