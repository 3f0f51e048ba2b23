"""Baseline schedulers the paper evaluates against (§6.1), under the same
engine contract as Tempo:

  vllm        — FCFS admission, whole-prompt prefill (no chunking): a new
                request's prefill monopolises the step budget -> HOL blocking.
  sarathi     — FCFS + chunked prefill (decode-priority, stall-free).
  autellix    — PLAS: program-level least-attained-service (collective
                requests share attained service across their DAG).
  sjf         — shortest-predicted-job-first using the Tempo Request
                Analyzer's point estimate ("Tempo (SJF)" in the paper).
  edf         — earliest-deadline-first (classic RT baseline).
  oracle      — TempoScheduler(precise=True) lives in scheduler.py.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from repro_torch.core.predictor import LengthPredictor
from repro_torch.core.scheduler import Decision, EngineView, SchedulerBase
from repro_torch.serving.request import ReqState, Request


def _finish_prefill_then_decode(view: EngineView, order: List[Request],
                                chunked: bool) -> Decision:
    """Shared helper: fill decode slots in the given order; spend the prefill
    budget in the same order (whole-prompt if not chunked)."""
    decodable = [r for r in order if r.prefill_remaining == 0 and not r.done]
    prefillable = [r for r in order if r.prefill_remaining > 0]
    decode_ids = [r.rid for r in decodable[:view.max_batch]]
    prefill: Dict[int, int] = {}
    budget = view.prefill_budget
    for r in prefillable:
        if budget <= 0:
            break
        chunk = min(budget, r.prefill_remaining) if chunked \
            else r.prefill_remaining
        if not chunked and chunk > budget:
            # vLLM-style: a huge prompt still runs, stalling the step
            prefill[r.rid] = chunk
            budget = 0
            break
        prefill[r.rid] = chunk
        budget -= chunk
    return Decision(decode_ids=decode_ids, prefill=prefill)


class VllmFCFS(SchedulerBase):
    name = "vllm"

    def schedule(self, view: EngineView) -> Decision:
        order = sorted((r for r in view.requests.values()
                        if r.state != ReqState.FINISHED),
                       key=lambda r: r.arrival)
        return _finish_prefill_then_decode(view, order, chunked=False)


class SarathiServe(SchedulerBase):
    name = "sarathi"

    def schedule(self, view: EngineView) -> Decision:
        order = sorted((r for r in view.requests.values()
                        if r.state != ReqState.FINISHED),
                       key=lambda r: r.arrival)
        return _finish_prefill_then_decode(view, order, chunked=True)


class AutellixPLAS(SchedulerBase):
    """Program-level least attained service: priority = total service already
    received by the request's program (DAG), ascending."""
    name = "autellix"

    def __init__(self, quanta: int = 20):
        self.quanta = quanta
        self._attained: Dict[int, float] = defaultdict(float)
        self._order_cache: List[int] = []

    def _program(self, r: Request):
        return ("dag", r.dag_id) if r.dag_id is not None else ("r", r.rid)

    def schedule(self, view: EngineView) -> Decision:
        live = [r for r in view.requests.values()
                if r.state != ReqState.FINISHED]
        # attained service per program (prompt + decoded tokens)
        att: Dict = defaultdict(float)
        for r in view.requests.values():
            att[self._program(r)] += r.prefilled + 2.0 * r.decoded
        order = sorted(live, key=lambda r: (att[self._program(r)], r.arrival))
        return _finish_prefill_then_decode(view, order, chunked=True)


class SJF(SchedulerBase):
    """Shortest predicted job first (Tempo's analyzer, point estimate)."""
    name = "sjf"
    needs_predictions = True

    def __init__(self, predictor: LengthPredictor = None):
        self.predictor = predictor or LengthPredictor()

    def on_arrival(self, req: Request, view: EngineView):
        req.pred_point = self.predictor.predict_point(req)

    def on_finish(self, req: Request, view: EngineView):
        self.predictor.observe(req)
        if len(self.predictor._y) % 2048 == 0:
            self.predictor.fit()

    def schedule(self, view: EngineView) -> Decision:
        live = [r for r in view.requests.values()
                if r.state != ReqState.FINISHED]
        order = sorted(live, key=lambda r: (
            (r.pred_point or 256.0) - r.decoded, r.arrival))
        return _finish_prefill_then_decode(view, order, chunked=True)


class EDF(SchedulerBase):
    name = "edf"

    def schedule(self, view: EngineView) -> Decision:
        live = [r for r in view.requests.values()
                if r.state != ReqState.FINISHED]
        order = sorted(live, key=lambda r: r.deadline)
        return _finish_prefill_then_decode(view, order, chunked=True)


def make_scheduler(name: str, **kw) -> SchedulerBase:
    from repro_torch.core.gmg import GroupedMarginScheduler
    from repro_torch.core.scheduler import TempoScheduler
    if name == "tempo":
        return TempoScheduler(**kw)
    if name == "tempo-precise":
        return TempoScheduler(precise=True, **kw)
    if name == "tempo-sjf":
        return SJF(**kw)
    if name == "gmg":
        return GroupedMarginScheduler(**kw)
    if name == "gmg-precise":
        return GroupedMarginScheduler(precise=True, **kw)
    return {"vllm": VllmFCFS, "sarathi": SarathiServe,
            "autellix": AutellixPLAS, "sjf": SJF, "edf": EDF}[name](**kw)
