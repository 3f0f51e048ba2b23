"""Response-length prediction (paper §4.1).

``LengthPredictor`` (QRF) estimates a conservative UPPER BOUND on the output
length from cheap request features, then refines it online as tokens are
generated (the generated count becomes a feature, and the bound is clamped
to ≥ decoded+1).  Conservative early, tighter late — exactly the paper's
middle ground between clairvoyant and non-clairvoyant scheduling.

``BertProxyPredictor`` reproduces the baseline the paper argues against: a
transformer-encoder point estimator.  It is implemented as a real numpy
transformer forward pass (4 layers, d=256, seq 128) so its latency (fig 5a)
and its symmetric-error behaviour — i.e. it under-estimates the true length
~half the time (fig 5b) — are measured, not asserted.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.qrf import QuantileForest
from repro_torch.serving.request import Request

APP_IDS = {"chatbot": 0, "code": 1, "agent": 2, "math": 3, "lc": 4,
           "batch": 5, "other": 6}
KIND_IDS = {"latency": 0, "throughput": 1, "collective": 2, "none": 3}


def request_features(req: Request, generated: int = 0) -> np.ndarray:
    """Cheap, always-available features.  ``meta['hint']`` carries the noisy
    semantic signal a prompt encoder would extract (workload.py synthesises
    it from the ground truth + heavy noise, mirroring fig 2b's hardness)."""
    return np.array([
        np.log1p(req.prompt_len),
        float(APP_IDS.get(req.app, 6)),
        float(KIND_IDS.get(req.slo.kind, 3)),
        np.log1p(generated),
        float(req.meta.get("hint", 0.0)),
        float(req.stage),
    ])


class LengthPredictor:
    """QRF upper-bound predictor with online refinement."""

    def __init__(self, quantile: float = 0.9, seed: int = 0):
        self.q = quantile
        self.forest = QuantileForest(n_trees=20, max_depth=8, min_leaf=16,
                                     seed=seed)
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self.fitted = False
        self.fits = 0                    # completed (re)fits
        self._since_fit = 0              # samples observed since last fit
        self.pred_ms: List[float] = []   # measured latency (fig 5a)

    # ------------------------------------------------------------------
    def observe(self, req: Request):
        """Feed a completed request back (online training set).  Each request
        contributes a few (progress, remaining-ish) snapshots so refinement
        conditioning on the generated count has support."""
        L = req.true_output_len
        for g in {0, L // 4, L // 2, (3 * L) // 4}:
            self._X.append(request_features(req, g))
            self._y.append(float(L))
            self._since_fit += 1

    def maybe_fit(self, every: int = 2048) -> bool:
        """Refit once `every` samples accumulated since the last fit.
        Callers must NOT gate on ``len(_y) % N == 0``: observe() appends
        1-4 samples per request, so the modulus is routinely stepped over
        and the forest would never refit after warm start."""
        if self._since_fit >= every:
            self.fit()
            return True
        return False

    def fit(self):
        if len(self._y) >= 64:
            # sliding window keeps refits cheap and the profile fresh
            X = np.stack(self._X[-6000:])
            y = np.array(self._y[-6000:])
            self.forest.fit(X, y)
            self.fitted = True
            self.fits += 1
        self._since_fit = 0

    def warm_start(self, reqs: List[Request]):
        for r in reqs:
            self.observe(r)
        self.fit()

    # ------------------------------------------------------------------
    def predict_upper(self, req: Request, generated: int = 0) -> float:
        t0 = time.perf_counter()
        if not self.fitted:
            ub = 4.0 * max(req.prompt_len, 256)          # cold-start guess
        else:
            x = request_features(req, generated)[None]
            ub = float(self.forest.predict_quantile(x, self.q)[0])
        self.pred_ms.append((time.perf_counter() - t0) * 1e3)
        return max(ub, generated + 1.0)

    def predict_point(self, req: Request, generated: int = 0) -> float:
        if not self.fitted:
            return float(max(req.prompt_len, 128))
        x = request_features(req, generated)[None]
        return max(float(self.forest.predict_quantile(x, 0.5)[0]),
                   generated + 1.0)


# ---------------------------------------------------------------------------
# BERT-proxy baseline (point estimator with real transformer-forward cost)
# ---------------------------------------------------------------------------
class BertProxyPredictor:
    def __init__(self, layers: int = 4, d: int = 256, seq: int = 128,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.seq, self.d = seq, d
        self.W = [
            {k: rng.normal(0, 0.02, s).astype(np.float32) for k, s in
             dict(q=(d, d), k=(d, d), v=(d, d), o=(d, d),
                  f1=(d, 4 * d), f2=(4 * d, d)).items()}
            for _ in range(layers)]
        self.head_w = rng.normal(0, 0.02, (d,)).astype(np.float32)
        self.head_b = 0.0
        self._a = 1.0
        self._b = 0.0
        self.pred_ms: List[float] = []

    def _encode(self, req: Request) -> float:
        """Real forward pass over a pseudo-token embedding of the prompt."""
        rng = np.random.default_rng(req.prompt_len * 2654435761 % (2**31))
        x = rng.normal(0, 1, (self.seq, self.d)).astype(np.float32)
        for w in self.W:
            q, k, v = x @ w["q"], x @ w["k"], x @ w["v"]
            s = q @ k.T / np.sqrt(self.d)
            s = np.exp(s - s.max(-1, keepdims=True))
            s /= s.sum(-1, keepdims=True)
            x = x + (s @ v) @ w["o"]
            h = np.maximum(x @ w["f1"], 0)
            x = x + h @ w["f2"]
        return float(x.mean(0) @ self.head_w + self.head_b)

    def fit(self, reqs: List[Request]):
        """Calibrate a scalar map from encoder score + prompt stats to length
        (point regression -> symmetric errors, the failure mode in fig 5b)."""
        feats, ys = [], []
        for r in reqs[:256]:
            feats.append(self._encode(r) + 0.3 * np.log1p(r.prompt_len)
                         + r.meta.get("hint", 0.0))
            ys.append(np.log1p(r.true_output_len))
        f, y = np.array(feats), np.array(ys)
        a, b = np.polyfit(f, y, 1)
        self._a, self._b = float(a), float(b)
        self._f = f

    def predict_point(self, req: Request, generated: int = 0) -> float:
        t0 = time.perf_counter()
        f = self._encode(req) + 0.3 * np.log1p(req.prompt_len) \
            + req.meta.get("hint", 0.0)
        out = float(np.expm1(self._a * f + self._b))
        self.pred_ms.append((time.perf_counter() - t0) * 1e3)
        return max(out, 1.0)
