"""Goodput-driven autoscaler: grow/drain the fleet on SLO attainment.

Scaling signal is *fleet goodput* (fraction of recently finished requests
that met their SLO, sliding window) plus queue pressure as an early-warning
overload signal — attainment is a lagging indicator when nothing finishes.
Hysteresis: scale up below ``up_below``, drain only above ``down_above``
(> up_below) *and* with near-empty queues, with a cooldown between actions,
so the fleet never flaps.  Draining is graceful: a draining replica stops
receiving traffic, finishes its backlog, then retires.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

from repro_torch.core.service import ServiceModel
from repro_torch.obs import NULL
from repro_torch.serving.request import Request


@dataclasses.dataclass
class AutoscalerConfig:
    target: float = 0.9            # fleet SLO-attainment objective
    up_below: float = 0.85         # attainment below this -> add replica
    down_above: float = 0.97       # attainment above this -> consider drain
    up_queue_frac: float = 1.5     # mean queue/replica > frac*max_batch -> up
    down_queue_frac: float = 0.35  # drain only when queues this empty
    window: float = 30.0           # s of finishes in the attainment window
    cooldown: float = 15.0         # s between scaling actions
    min_replicas: int = 1
    max_replicas: int = 8
    min_samples: int = 16          # finishes needed before acting on goodput
    cold_start_s: float = 2.0      # new replica boots this long after spawn
    # role specialisation (DESIGN.md §12): flip a MIXED replica to the
    # starved role when one role's backlog exceeds role_ratio× the other
    # for role_streak consecutive observations (same cooldown as scaling)
    role_ratio: float = 2.0
    role_streak: int = 3
    role_floor: float = 0.5        # ignore imbalance below this absolute load


class Autoscaler:
    # metrics registry handle (repro.obs), rebound by ClusterEngine
    obs = NULL

    def __init__(self, config: Optional[AutoscalerConfig] = None,
                 service: Optional[ServiceModel] = None):
        self.cfg = config or AutoscalerConfig()
        self.service = service or ServiceModel()
        self._fin: Deque[Tuple[float, bool]] = deque()
        self._last_action_t = -1e18
        self.actions: list = []        # (t, "+1"/"-1", n_active_after)
        # role-flip streak state (decide_role)
        self._role_bias: Optional[str] = None
        self._role_streak = 0

    # ------------------------------------------------------------------
    def observe_finish(self, req: Request, t: float) -> None:
        self._fin.append((t, self.service.slo_met(req)))

    def attainment(self, t: float) -> Optional[float]:
        while self._fin and self._fin[0][0] < t - self.cfg.window:
            self._fin.popleft()
        if len(self._fin) < self.cfg.min_samples:
            return None
        return sum(1 for _, ok in self._fin if ok) / len(self._fin)

    # ------------------------------------------------------------------
    def decide(self, t: float, n_active: int, mean_queue: float,
               max_batch: int) -> int:
        """-> +1 (spawn), -1 (drain one), or 0.  ``mean_queue`` is live+
        queued requests per active replica."""
        c = self.cfg
        if t - self._last_action_t < c.cooldown:
            return 0
        att = self.attainment(t)
        if att is not None:
            self.obs.gauge("autoscaler_attainment",
                           "sliding-window fleet SLO attainment"
                           ).set(att, t=t)
        overloaded = mean_queue > c.up_queue_frac * max_batch
        if n_active < c.max_replicas and \
                (overloaded or (att is not None and att < c.up_below)):
            self._last_action_t = t
            self.actions.append((t, +1, n_active + 1))
            self.obs.counter("autoscaler_scale_total", "scaling actions",
                             direction="up").inc(t=t)
            return +1
        if n_active > c.min_replicas and att is not None \
                and att > c.down_above \
                and mean_queue < c.down_queue_frac * max_batch:
            self._last_action_t = t
            self.actions.append((t, -1, n_active - 1))
            self.obs.counter("autoscaler_scale_total", "scaling actions",
                             direction="down").inc(t=t)
            return -1
        return 0

    # ------------------------------------------------------------------
    def decide_role(self, t: float, prefill_load: float,
                    decode_load: float, n_mixed: int) -> Optional[str]:
        """Role specialisation for a disaggregated fleet (DESIGN.md §12):
        flip ONE mixed replica toward the starved role when that role's
        backlog has exceeded ``role_ratio``× the other's (both in
        step-equivalents per capable replica) for ``role_streak``
        consecutive observations.  Shares the scaling cooldown and resets
        its streak whenever the imbalance direction changes, so transient
        waves never flip roles.  Returns "prefill"/"decode" or None."""
        c = self.cfg
        want: Optional[str] = None
        if prefill_load > c.role_floor and \
                prefill_load > c.role_ratio * max(decode_load, 1e-9):
            want = "prefill"
        elif decode_load > c.role_floor and \
                decode_load > c.role_ratio * max(prefill_load, 1e-9):
            want = "decode"
        if want is None or want != self._role_bias:
            self._role_bias = want
            self._role_streak = 1 if want else 0
            return None
        self._role_streak += 1
        if (n_mixed < 1 or self._role_streak < c.role_streak
                or t - self._last_action_t < c.cooldown):
            return None
        self._last_action_t = t
        self._role_bias = None
        self._role_streak = 0
        self.actions.append((t, f"role->{want}", n_mixed - 1))
        self.obs.counter("autoscaler_role_flip_total",
                         "mixed replicas specialised", role=want).inc(t=t)
        return want
