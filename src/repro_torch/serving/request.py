"""Request model: SLO specs, lifecycle state, collective (DAG) linkage.

Three request patterns (paper §2.1):
  latency     — streaming consumption; SLOs on TTFT and TBT (Eq. 3 gain)
  throughput  — full response by a TTLT deadline (Eq. 2 gain)
  collective  — DAG of calls sharing an end-to-end TTLT deadline
  none        — best-effort (no SLO; served from the reserved quota)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class ReqState(enum.Enum):
    WAITING = 0
    PREFILL = 1
    RUNNING = 2      # decoding
    PREEMPTED = 3
    FINISHED = 4


@dataclasses.dataclass
class SLOSpec:
    kind: str                      # latency | throughput | collective | none
    ttft: float = 2.0              # s
    tbt: float = 0.1               # s/token
    ttlt: float = 20.0             # s (deadline, relative to arrival)

    def scaled(self, factor: float) -> "SLOSpec":
        return SLOSpec(self.kind, self.ttft * factor, self.tbt * factor,
                       self.ttlt * factor)


@dataclasses.dataclass
class Request:
    rid: int
    app: str                       # workload/app cluster (for DAG matching)
    arrival: float                 # s
    prompt_len: int
    true_output_len: int           # ground truth — hidden from schedulers
    slo: SLOSpec
    # collective linkage
    dag_id: Optional[int] = None
    stage: int = 0
    # prefix identity: requests in one session (multi-turn chat) or one
    # agentic chain share a token-stream prefix; meta['prompt_tokens']
    # carries the actual tokens the hash chain (and the jax backend) use
    session_id: Optional[int] = None
    # multi-tenant SLO class ("" = untenanted; free | pro | enterprise by
    # default, see workload.TENANT_CLASSES).  Weighted-fairness shedding
    # reads meta['tenant_weight'] so schedulers stay config-free.
    tenant: str = ""
    # --- runtime state (engine-owned) ---
    state: ReqState = ReqState.WAITING
    cached_len: int = 0            # prompt tokens served from prefix cache
    prefilled: int = 0             # prompt tokens processed (admit sets it
                                   # to cached_len so prefill_remaining —
                                   # and every density/urgency/remaining-
                                   # time estimate — counts only the
                                   # uncached suffix)
    decoded: int = 0               # output tokens emitted
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    sched_in_t: Optional[float] = None
    # speculative decoding (DESIGN.md §11): EWMA of the per-verify-step
    # draft accept rate (None until the first verify step).  Feeds the
    # scheduler's depth policy — a request the drafter keeps missing on
    # stops receiving verification compute.
    spec_accept_ewma: Optional[float] = None
    # analyzer annotations
    pred_upper: Optional[float] = None   # QRF upper bound on output length
    pred_point: Optional[float] = None   # point estimate (SJF)
    stage_deadline: Optional[float] = None  # absolute, set by DAG budgeting
    meta: Dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.decoded >= self.true_output_len

    @property
    def prefill_remaining(self) -> int:
        return max(0, self.prompt_len - self.prefilled)

    @property
    def deadline(self) -> float:
        """Absolute TTLT deadline (stage deadline for collectives)."""
        if self.slo.kind == "collective" and self.stage_deadline is not None:
            return self.stage_deadline
        return self.arrival + self.slo.ttlt

    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival

    def ttlt(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival

    def tbts(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


@dataclasses.dataclass
class DagNode:
    """One stage of a collective request: n parallel LLM calls."""
    requests: List[int]            # rids
    done: int = 0


@dataclasses.dataclass
class CollectiveDag:
    dag_id: int
    app: str
    arrival: float
    ttlt: float                    # end-to-end deadline (relative)
    # planned structure: list of stage sizes; stages spawn as prior completes
    stage_sizes: List[int] = dataclasses.field(default_factory=list)
    stages: List[DagNode] = dataclasses.field(default_factory=list)
    cur_stage: int = 0
    finished: bool = False
    finish_t: Optional[float] = None
    tenant: str = ""               # inherited by every member request

    @property
    def deadline(self) -> float:
        return self.arrival + self.ttlt
