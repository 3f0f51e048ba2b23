"""Service-gain model (paper §3.1).

  service_gain = w_i·L_i + w_o·L_o                         (Eq. 1)
  f(SLO, metric) = min{1, (SLO / metric)^α}                (divisive decay)

Throughput-intensive & collective (Eq. 2):
  ESG = (w_i·L_i + w_o·L_o) · f(SLO_TTLT, TTLT)

Latency-sensitive (Eq. 3):
  ESG = w_i·L_i · f(SLO_TTFT, TTFT) + Σ_tokens w_o · f(SLO_TBT, TBT_token)

α → ∞ recovers binary SLO goodput; exceeding the SLO never adds gain.
Weights default to w_i:w_o = 1:2 (commercial token pricing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    w_in: float = 1.0
    w_out: float = 2.0
    alpha: float = 1.0

    # ------------------------------------------------------------------
    def degrade(self, slo: float, metric: Optional[float]) -> float:
        """f(SLO, metric): 1 when within SLO, divisively decayed beyond."""
        if metric is None or metric <= 0:
            return 1.0
        if metric <= slo:
            return 1.0
        if math.isinf(self.alpha):
            return 0.0
        return min(1.0, (slo / metric) ** self.alpha)

    def max_gain(self, req: Request) -> float:
        return self.w_in * req.prompt_len + self.w_out * req.true_output_len

    # ------------------------------------------------------------------
    def realized_gain(self, req: Request) -> float:
        """ESG of a completed (or partially completed) request."""
        if req.slo.kind == "none":
            # best-effort: full gain for whatever was served
            return self.w_in * req.prefilled + self.w_out * req.decoded
        if req.slo.kind == "latency":
            g = 0.0
            ttft = req.ttft()
            if ttft is not None:
                g += self.w_in * req.prompt_len * self.degrade(req.slo.ttft,
                                                               ttft)
            for tbt in req.tbts():
                g += self.w_out * self.degrade(req.slo.tbt, tbt)
            if req.token_times:
                g += self.w_out  # first emitted token (covered by TTFT)
            return g
        # throughput / collective: Eq. 2 on the (stage-aware) deadline
        if req.finish_t is None:
            return 0.0
        ttlt = req.finish_t - req.arrival
        slo_ttlt = req.slo.ttlt
        return (self.w_in * req.prompt_len
                + self.w_out * req.true_output_len) \
            * self.degrade(slo_ttlt, ttlt)

    # ------------------------------------------------------------------
    def slo_met(self, req: Request, tbt_pctl: float = 0.95) -> bool:
        """Binary goodput indicator (α→∞ semantics)."""
        if req.slo.kind == "none":
            return req.finish_t is not None
        if req.finish_t is None:
            return False
        if req.slo.kind == "latency":
            ttft = req.ttft()
            if ttft is None or ttft > req.slo.ttft:
                return False
            tbts = sorted(req.tbts())
            if not tbts:
                return True
            k = min(len(tbts) - 1, int(tbt_pctl * len(tbts)))
            return tbts[k] <= req.slo.tbt
        return (req.finish_t - req.arrival) <= req.slo.ttlt

    # ------------------------------------------------------------------
    def projected_gain(self, req: Request, est_output_len: float,
                       est_ttlt: float) -> float:
        """Gain if the request completes with the given estimates (used by
        the LSDF density, Eq. 4)."""
        base = self.w_in * req.prompt_len + self.w_out * est_output_len
        if req.slo.kind == "latency":
            # pacing view: gain decays with lateness against the token
            # delivery timeline implied by (TTFT, TBT)
            expect = req.slo.ttft + req.slo.tbt * max(est_output_len - 1, 0)
            return base * self.degrade(expect, est_ttlt)
        if req.slo.kind == "none":
            return 0.0  # served from the reserve, not by density
        slo_ttlt = req.deadline - req.arrival
        return base * self.degrade(slo_ttlt, est_ttlt)
