"""Quantile Regression Forest, from scratch in numpy (no sklearn in the
image).  Meinshausen (2006)-style: CART trees on bootstrap samples whose
leaves keep the empirical target distribution; a quantile prediction pools
the per-tree leaf distributions.

Tuned for scheduler use: fitting ~20k samples × ≤8 features in a couple of
seconds on one core, and sub-millisecond single-row predictions (the paper's
headline is 7 ms per prediction for its QRF — ours is comfortably under
that; see bench_predictor)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray     # (nodes,) int, -1 for leaf
    threshold: np.ndarray   # (nodes,) float
    left: np.ndarray        # (nodes,) int
    right: np.ndarray       # (nodes,) int
    leaf_quantiles: np.ndarray  # (nodes, n_grid) — empirical quantile grid
    leaf_values: List[Optional[np.ndarray]]  # raw targets (exact mode)


_QGRID = np.linspace(0.0, 1.0, 21)


class QuantileForest:
    def __init__(self, n_trees: int = 20, max_depth: int = 8,
                 min_leaf: int = 16, n_thresholds: int = 8,
                 feature_frac: float = 0.8, seed: int = 0,
                 keep_leaf_values: bool = False):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_thresholds = n_thresholds
        self.feature_frac = feature_frac
        self.rng = np.random.default_rng(seed)
        self.keep_leaf_values = keep_leaf_values
        self.trees: List[_Tree] = []

    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "QuantileForest":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n = len(y)
        self.trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(0, n, n)        # bootstrap
            self.trees.append(self._build_tree(X[idx], y[idx]))
        return self

    def _build_tree(self, X, y) -> _Tree:
        feature, threshold, left, right = [], [], [], []
        leaf_q, leaf_v = [], []

        def new_node():
            feature.append(-1)
            threshold.append(0.0)
            left.append(-1)
            right.append(-1)
            leaf_q.append(None)
            leaf_v.append(None)
            return len(feature) - 1

        nf = X.shape[1]
        k = max(1, int(self.feature_frac * nf))

        stack = [(new_node(), np.arange(len(y)), 0)]
        while stack:
            node, rows, depth = stack.pop()
            yr = y[rows]
            if depth >= self.max_depth or len(rows) < 2 * self.min_leaf \
                    or np.ptp(yr) == 0:
                leaf_q[node] = np.quantile(yr, _QGRID)
                leaf_v[node] = yr.copy() if self.keep_leaf_values else None
                continue
            feats = self.rng.choice(nf, size=k, replace=False)
            best = (None, None, np.inf)
            base_var = yr.var() * len(rows)
            for f in feats:
                xv = X[rows, f]
                qs = np.quantile(
                    xv, np.linspace(0.1, 0.9, self.n_thresholds))
                for t in np.unique(qs):
                    m = xv <= t
                    nl = int(m.sum())
                    if nl < self.min_leaf or len(rows) - nl < self.min_leaf:
                        continue
                    yl, yrr = yr[m], yr[~m]
                    score = yl.var() * nl + yrr.var() * (len(rows) - nl)
                    if score < best[2]:
                        best = (f, t, score)
            if best[0] is None or best[2] >= base_var:
                leaf_q[node] = np.quantile(yr, _QGRID)
                leaf_v[node] = yr.copy() if self.keep_leaf_values else None
                continue
            f, t, _ = best
            m = X[rows, f] <= t
            feature[node] = int(f)
            threshold[node] = float(t)
            ln, rn = new_node(), new_node()
            left[node] = ln
            right[node] = rn
            stack.append((ln, rows[m], depth + 1))
            stack.append((rn, rows[~m], depth + 1))

        nq = np.zeros((len(feature), len(_QGRID)))
        for i, q in enumerate(leaf_q):
            if q is not None:
                nq[i] = q
        return _Tree(np.array(feature), np.array(threshold),
                     np.array(left), np.array(right), nq, leaf_v)

    # ------------------------------------------------------------------
    def _route(self, tree: _Tree, X: np.ndarray) -> np.ndarray:
        if len(X) == 1:                      # scalar fast path (hot in the
            row = X[0]                       # scheduler's online refinement)
            feat, thr = tree.feature, tree.threshold
            left, right = tree.left, tree.right
            n = 0
            f = feat[n]
            while f >= 0:
                n = left[n] if row[f] <= thr[n] else right[n]
                f = feat[n]
            return np.array([n], dtype=np.int64)
        node = np.zeros(len(X), dtype=np.int64)
        active = tree.feature[node] >= 0
        while active.any():
            f = tree.feature[node[active]]
            t = tree.threshold[node[active]]
            xv = X[active][np.arange(int(active.sum())), f]
            nxt = np.where(xv <= t, tree.left[node[active]],
                           tree.right[node[active]])
            node[active] = nxt
            active = tree.feature[node] >= 0
        return node

    def predict_quantile(self, X: np.ndarray, q: float) -> np.ndarray:
        """Fast mode: interpolate each tree's leaf-quantile grid, average."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        lo = int(np.floor(q * (len(_QGRID) - 1)))
        hi = min(lo + 1, len(_QGRID) - 1)
        w = q * (len(_QGRID) - 1) - lo
        if len(X) == 1:
            acc = 0.0
            for tree in self.trees:
                leaf = int(self._route(tree, X)[0])
                g = tree.leaf_quantiles[leaf]
                acc += (1 - w) * g[lo] + w * g[hi]
            return np.array([acc / self.n_trees])
        out = np.zeros(len(X))
        for tree in self.trees:
            leaves = self._route(tree, X)
            grid = tree.leaf_quantiles[leaves]            # (n, n_grid)
            out += (1 - w) * grid[:, lo] + w * grid[:, hi]
        return out / self.n_trees

    def predict_interval(self, X, lo: float = 0.1, hi: float = 0.9):
        return self.predict_quantile(X, lo), self.predict_quantile(X, hi)

    def predict_quantile_exact(self, X: np.ndarray, q: float) -> np.ndarray:
        """Pooled empirical distribution across trees (requires
        keep_leaf_values=True); used by property tests as the oracle."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        routes = [self._route(t, X) for t in self.trees]
        out = np.zeros(len(X))
        for i in range(len(X)):
            vals = np.concatenate([
                t.leaf_values[r[i]] for t, r in zip(self.trees, routes)
                if t.leaf_values[r[i]] is not None])
            out[i] = np.quantile(vals, q)
        return out
