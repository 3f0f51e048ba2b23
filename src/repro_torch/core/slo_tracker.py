"""SLO Tracker (paper §3.2 ③): runtime metrics + token-speed profile.

Token processing speed is stable and predictable (paper fig. 8): TTFT/TBT
depend on context length and batch composition, not prompt content.  The
tracker maintains two views of the replica's speed, both refreshed online
from executed steps:

  ``SpeedProfile``  — scalar EWMAs of prefill throughput (tokens/s) and
                      decode step time.  Mixed chunked-prefill+decode steps
                      (the common case under continuous batching) are
                      APPORTIONED between the two EWMAs using the current
                      estimates (EM-style fixed point) — charging the full
                      step time to both profiles would inflate decode_step
                      by the prefill time and deflate prefill_tps by the
                      decode time, corrupting every margin/density estimate
                      downstream.
  ``StepCostModel`` — a batch-aware linear fit of the step time over
                      (prefill tokens, has-decode, decode seqs, total
                      context), refit online from a sliding window of step
                      observations.  This is the model the grouped-margin
                      scheduler prices batch composition with: the marginal
                      cost of adding a sequence to the batch is the model's
                      per-seq + per-context-token coefficients, and the
                      remaining-time estimate of a request depends on the
                      batch it rides in.

The scalar profile is the always-available fallback (cold replicas, the
cluster router's zero-step bootstrap); the fitted model takes over as soon
as it has support.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass
class SpeedProfile:
    prefill_tps: float = 50_000.0    # prompt tokens/s when given full budget
    decode_step: float = 0.03        # s per engine step (one token/seq)
    ewma: float = 0.05
    samples: int = 0

    def update(self, step_time: float, prefill_tokens: int,
               decode_seqs: int, verify_tokens: int = 0):
        """Fold one executed step into the EWMAs.

        Mixed steps are split between the profiles in proportion to the
        time each phase is currently *estimated* to take (an EM step: the
        apportioning uses the running estimates, the estimates are updated
        from the apportioned observation).  Pure prefill / pure decode
        steps reduce to the unapportioned update exactly.

        ``verify_tokens`` (speculative verification, DESIGN.md §11) are
        compute-bound extra positions like prefill tokens, so they join
        the prefill side of the apportioning — without this every verify
        step would be charged to ``decode_step`` and inflate it by the
        drafted window's compute.
        """
        self.samples += 1
        if step_time <= 0:
            return
        p_eff = prefill_tokens + verify_tokens
        est_p = p_eff / max(self.prefill_tps, 1.0) if p_eff > 0 else 0.0
        est_d = self.decode_step if decode_seqs > 0 else 0.0
        total = est_p + est_d
        if p_eff > 0:
            share = est_p / total if total > 0 else 1.0
            t_p = max(step_time * share, 1e-9)
            tps = p_eff / t_p
            self.prefill_tps += self.ewma * (tps - self.prefill_tps)
        if decode_seqs > 0:
            share = est_d / total if total > 0 else 1.0
            self.decode_step += self.ewma * (step_time * share
                                             - self.decode_step)


class StepCostModel:
    """Online ridge fit:  t_step ≈ w · [1, p, 1{d>0}, d, ctx, v]

    where p = prefill tokens this step, d = decode batch size, ctx = total
    context tokens read by the decode batch, and v = speculative verify
    tokens (extra drafted positions scored beyond one per lane, DESIGN.md
    §11).  The has-decode indicator captures the per-step weight-read cost
    that is paid once regardless of batch size (the dominant decode term on
    HBM-bound replicas); the d and ctx coefficients price marginal batch
    composition; the v coefficient prices the compute of widening the
    decode matmuls with a drafted window — without it every verify step's
    extra time would be attributed to d/ctx and corrupt the margin
    estimates of plain decode batches (the same mis-attribution failure
    the mixed-step apportioning fix addressed for the scalar profile).

    Observations land in a sliding window; the model refits every
    ``refit_every`` new samples (a 6×6 solve — microseconds).  ``predict``
    returns None until the fit has support, letting callers fall back to
    the scalar ``SpeedProfile``.
    """

    N_FEAT = 6

    def __init__(self, window: int = 2048, refit_every: int = 64,
                 ridge: float = 1e-4, min_samples: int = 48):
        self.window = window
        self.refit_every = refit_every
        self.ridge = ridge
        self.min_samples = min_samples
        self._obs: List[Tuple[float, ...]] = []
        self._y: List[float] = []
        self._since_fit = 0
        self._w: Optional[np.ndarray] = None
        self.fits = 0

    # scale factors keep the normal equations well conditioned: token
    # counts are O(1e3-1e5), step times O(1e-2).  The verify-token term
    # is appended LAST so spec-off observations (v = 0 everywhere) leave
    # the leading block of the normal equations — and thus the fitted
    # coefficients — exactly where the 5-feature model put them
    _SCALE = np.array([1.0, 1e-3, 1.0, 1e-1, 1e-4, 1e-2])

    @staticmethod
    def _feat(prefill_tokens: float, decode_seqs: float,
              ctx_total: float, verify_tokens: float = 0.0
              ) -> Tuple[float, ...]:
        return (1.0, float(prefill_tokens),
                1.0 if decode_seqs > 0 else 0.0,
                float(decode_seqs), float(ctx_total),
                float(verify_tokens))

    def observe(self, step_time: float, prefill_tokens: int,
                decode_seqs: int, ctx_total: float,
                verify_tokens: int = 0) -> None:
        if step_time <= 0:
            return
        self._obs.append(self._feat(prefill_tokens, decode_seqs, ctx_total,
                                    verify_tokens))
        self._y.append(float(step_time))
        if len(self._obs) > self.window:
            del self._obs[: len(self._obs) - self.window]
            del self._y[: len(self._y) - self.window]
        self._since_fit += 1
        if self._since_fit >= self.refit_every \
                and len(self._obs) >= self.min_samples:
            self.fit()

    def fit(self) -> None:
        self._since_fit = 0
        X = np.asarray(self._obs) * self._SCALE
        y = np.asarray(self._y)
        A = X.T @ X + self.ridge * np.eye(self.N_FEAT)
        w = np.linalg.solve(A, X.T @ y)
        self._w = w * self._SCALE
        self.fits += 1

    @property
    def fitted(self) -> bool:
        return self._w is not None

    def predict(self, prefill_tokens: float, decode_seqs: float,
                ctx_total: float, verify_tokens: float = 0.0
                ) -> Optional[float]:
        """Predicted step time, or None before the first fit.  Clamped to
        a small positive floor — ridge noise must never produce a zero or
        negative step time (margins divide by it)."""
        if self._w is None:
            return None
        t = float(np.dot(self._w,
                         self._feat(prefill_tokens, decode_seqs, ctx_total,
                                    verify_tokens)))
        return max(t, 1e-5)


class SLOTracker:
    def __init__(self):
        self.profile = SpeedProfile()
        self.cost_model = StepCostModel()
        self.history_tbt: List[float] = []

    # ------------------------------------------------------------------
    def on_step(self, step_time: float, prefill_tokens: int,
                decode_seqs: int, ctx_total: Optional[float] = None,
                verify_tokens: int = 0):
        self.profile.update(step_time, prefill_tokens, decode_seqs,
                            verify_tokens)
        if ctx_total is not None:
            self.cost_model.observe(step_time, prefill_tokens, decode_seqs,
                                    ctx_total, verify_tokens)

    # ------------------------------------------------------------------
    def est_prefill_time(self, tokens: int) -> float:
        """Prefill compute time.  Prefers the fitted per-token prefill
        coefficient: the EM-apportioned EWMA split is only identifiable
        when the step stream contains pure or compositionally varied
        steps, while the joint fit isolates the prefill slope from any
        mix of observations.  The slope alone (no per-step intercept) is
        deliberate: chunked prefill rides along steps whose fixed
        overhead the decode batch pays anyway, so the MARGINAL cost of a
        prompt is ~slope×tokens; only on a fully idle replica does this
        undershoot, by ~overhead×n_chunks ≪ any TTFT SLO."""
        w = self.cost_model._w
        if w is not None and w[1] > 1e-9:
            return tokens * float(w[1])
        return tokens / max(self.profile.prefill_tps, 1.0)

    def est_step_time(self, decode_seqs: int, ctx_total: float,
                      prefill_tokens: int = 0) -> float:
        """Batch-aware per-step time; falls back to the scalar decode EWMA
        (plus the prefill estimate) until the cost model has support."""
        t = self.cost_model.predict(prefill_tokens, decode_seqs, ctx_total)
        if t is not None:
            return t
        t = self.profile.decode_step if decode_seqs > 0 else 0.0
        if prefill_tokens > 0:
            t += self.est_prefill_time(prefill_tokens)
        return max(t, 1e-5)

    def est_decode_time(self, tokens: float,
                        decode_seqs: Optional[int] = None,
                        ctx_total: Optional[float] = None) -> float:
        """Time to emit ``tokens`` output tokens.  With batch composition
        given, each token costs one step of the projected batch; otherwise
        the scalar EWMA step time is used."""
        if decode_seqs is not None and ctx_total is not None:
            return tokens * self.est_step_time(max(decode_seqs, 1),
                                               ctx_total)
        return tokens * self.profile.decode_step

    def est_first_token_time(self, req: Request) -> float:
        """Time-to-first-token if scheduled now.  Keyed off
        ``prefill_remaining``, which counts only the UNCACHED suffix — a
        prefix-cache hit at admit shrinks TTFT urgency (and preemption
        cost) exactly as it shrinks the real prefill."""
        return self.est_prefill_time(req.prefill_remaining)

    def est_remaining_time(self, req: Request, est_total_out: float,
                           decode_seqs: Optional[int] = None,
                           ctx_total: Optional[float] = None) -> float:
        """Remaining service time if scheduled continuously from now.
        Prefill is the uncached suffix only (see est_first_token_time);
        with a batch composition given, decode is priced per-step under
        that batch instead of the scalar EWMA."""
        rem_out = max(est_total_out - req.decoded, 1.0)
        return self.est_prefill_time(req.prefill_remaining) \
            + self.est_decode_time(rem_out, decode_seqs, ctx_total)

    def est_ttlt(self, req: Request, now: float,
                 est_total_out: float) -> float:
        return (now - req.arrival) + self.est_remaining_time(
            req, est_total_out)

    # ------------------------------------------------------------------
    def tokens_behind(self, req: Request, now: float) -> float:
        """How many tokens behind the SLO delivery timeline a latency request
        is (>0 = lagging) — cumulative view, used for reporting."""
        if req.slo.kind != "latency":
            return 0.0
        due_elapsed = now - req.arrival - req.slo.ttft
        expected = due_elapsed / max(req.slo.tbt, 1e-6) + 1.0
        if req.first_token_t is None:
            return max(expected, 0.0) if due_elapsed > -0.25 else 0.0
        return expected - req.decoded

    def token_due_frac(self, req: Request, now: float) -> float:
        """Per-token pacing signal: fraction of the TBT interval elapsed
        since the LAST emitted token (>1 = this token is already late).
        Eq. 3 credits each token individually, so pacing keys off the gap
        since the last token, not a cumulative schedule."""
        if not req.token_times:
            return 2.0   # TTFT pending: treated as urgent elsewhere
        return (now - req.token_times[-1]) / max(req.slo.tbt, 1e-6)
