"""The system under test, driven in real time.

Builds the port's serving stack for a configuration and a traffic file:
``PagedTorchBackend`` (the weights drawn on the device from the seed),
the scheduler named by the configuration (``core/baselines.make_scheduler``)
with its length predictor warm-started, and ``ServeEngine``.  Then it
serves the traffic against the wall clock:

- every request is handed to the engine once it is due, with its due
  time, in seconds from the traffic's origin; in a closed loop a client's
  next request is due the moment its last one finished;
- before each ``step_once`` the engine's clock is set to the wall seconds
  since the origin, never backwards; when the engine has no live work the
  harness sleeps until the next request is due, instead of letting the
  engine jump its clock;
- after each step every newly decoded token is stamped with the host's
  clock: that is when it reached the host.
"""

from __future__ import annotations

import heapq
import importlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import cost, traffic as traffic_mod
from portbench.slo import Record

APPS = {"latency": "chatbot", "throughput": "code", "none": "batch"}


def _request(spec):
    from repro_torch.serving.request import Request, SLOSpec

    r = Request(rid=spec.index + 1 if spec.index >= 0 else spec.index,
                app=APPS[spec.kind], arrival=spec.due or 0.0,
                prompt_len=spec.prompt_len, true_output_len=spec.output_len,
                slo=SLOSpec(spec.kind, ttft=spec.ttft or 2.0,
                            tbt=spec.tbt or 0.1, ttlt=spec.ttlt))
    r.meta["hint"] = spec.hint
    if spec.prompt is not None:
        r.meta["prompt_tokens"] = spec.prompt
    return r


def pool_pages(cfg: Dict, device: torch.device) -> int:
    """Pages of the KV pool: the configuration's ``engine.pages``, or what
    ``engine.memory_fraction`` of the card holds after the weights, the
    lm_head's float32 copy and ``engine.activation_reserve_gib`` (a vLLM
    deployment reserves 0.9 of the card this way).  One page is kept back
    for the backend's scrap page."""
    eng = cfg["engine"]
    if "pages" in eng:
        return int(eng["pages"])
    k = cost.dims(cfg)
    weights = (cost.matmul_params(cfg) + k["V"] * k["d"]) * k["e"]
    head_f32 = k["d"] * (-(-k["V"] // 256) * 256) * 4
    free = (eng["memory_fraction"]
            * torch.cuda.get_device_properties(device).total_memory
            - weights - head_f32 - eng["activation_reserve_gib"] * 2**30)
    page = eng["page"] * 2 * k["KV"] * k["Dh"] * k["e"] * k["L"]
    return int(free // page) - 1


class Served:
    """One configuration's serving stack, built from the seed."""

    def __init__(self, cfg: Dict, t: Dict, seed: int, device: str):
        from repro_torch.serving.torch_backend import PagedTorchBackend

        self.cfg, self.t, self.seed = cfg, t, seed
        self.device = torch.device(device)
        eng = cfg["engine"]
        arch = importlib.import_module(f"portbench.arch.{cfg['arch']}")
        self.backend = PagedTorchBackend(
            config=arch.port_config(cfg), device=device,
            max_len=t["max_len"], num_blocks=pool_pages(cfg, self.device),
            page=eng["page"], seed=seed, temperature=0.0, fused=True)
        self.fresh()

    def fresh(self) -> None:
        """A new scheduler (its predictor warm-started) and engine over the
        backend, which forgets every request it served."""
        from repro_torch.core.baselines import make_scheduler
        from repro_torch.core.service import ServiceModel
        from repro_torch.serving.engine import EngineConfig, ServeEngine

        eng = self.cfg["engine"]
        self.backend.reset_run_state()
        self.sched = make_scheduler(eng["scheduler"], service=ServiceModel())
        pred = getattr(self.sched, "predictor", None)
        if pred is not None and eng["warm_start"]:
            pred.warm_start([_request(s) for s in traffic_mod.warmup(
                self.t, eng["warm_start"])])
        self.engine = ServeEngine(self.backend, self.sched, EngineConfig(
            max_batch=eng["max_batch"], prefill_budget=eng["prefill_budget"],
            decode_steps=eng["decode_steps"],
            spec_depth_max=eng["spec_depth_max"],
            prefix_cache=eng["prefix_cache"]))

    def warm(self) -> None:
        """Run every shape the cell's traffic uses once before the window:
        a decode call at each lane count up to ``max_batch`` in steps of
        the backend's call rows, and one prefill call; then forget them."""
        from repro_torch.serving.request import Request, SLOSpec
        from repro_torch.serving.torch_backend import ROWS

        be = self.backend
        npages = be.num_blocks
        for _ in range(2):
            for lanes in range(ROWS, self.cfg["engine"]["max_batch"] + 1,
                               ROWS):
                reqs = []
                for j in range(lanes):
                    r = Request(rid=-(j + 1), app="warm", arrival=0.0,
                                prompt_len=2, true_output_len=2,
                                slo=SLOSpec("none", ttlt=1e9))
                    r.meta["prompt_tokens"] = np.array([1, 2], np.int32)
                    reqs.append(r)
                be.begin_step()
                be.decode_batch(reqs, [[j % npages] for j in range(lanes)])
                be.step_time(0, [2] * lanes)
            r = Request(rid=-(lanes + 1), app="warm", arrival=0.0,
                        prompt_len=ROWS,
                        true_output_len=2, slo=SLOSpec("none", ttlt=1e9))
            r.meta["prompt_tokens"] = np.arange(ROWS, dtype=np.int32)
            be.begin_step()
            be.prefill_chunk(r, 0, ROWS, list(range(
                -(-ROWS // be.block_tokens))))
            be.step_time(ROWS, [])
        be.reset_run_state()

    def serve(self, specs: List, end: float, tracer=None,
              on_origin=None, idle_after: Optional[float] = None
              ) -> List[Record]:
        """Serve ``specs`` (``traffic.generate``) from now, the origin,
        until ``end`` seconds after it, or on past ``end`` while the
        tracer asks for steps, or past ``idle_after`` once nothing is left
        to serve; returns a record per request with its token stamps.
        Every step is logged in ``self.steps``: (start, end, tokens,
        KV pages in use), in seconds from the origin."""
        eng = self.engine
        recs = {s.index + 1: Record(s) for s in specs}
        due: List = []           # heap of (due, index) not yet taken in
        closed = self.t["arrival"] == "closed"
        waiting = iter(specs[int(self.t["clients"]):] if closed else ())
        for s in specs:
            if s.due is not None:
                heapq.heappush(due, (s.due, s.index))
        live: Dict[int, object] = {}
        n_shed = 0
        self.steps = []
        origin = time.perf_counter()
        if on_origin is not None:
            on_origin(origin)
        while True:
            now = time.perf_counter() - origin
            if now >= end and (tracer is None or not tracer.wants_steps()):
                break
            if idle_after is not None and now >= idle_after and not due \
                    and not eng.has_live():
                break
            if not eng.has_live() and (not due or due[0][0] > now):
                wake = min(due[0][0], end) if due else end
                time.sleep(max(wake - now, 0.0))
                continue
            eng.now = max(eng.now, now)
            while due and due[0][0] <= eng.now:
                t_due, i = heapq.heappop(due)
                r = _request(specs[i])
                r.arrival = t_due
                eng.enqueue("r", r)
                recs[r.rid].admitted = now
                live[r.rid] = r
            if tracer is not None:
                tracer.step(eng.step_once, now)
            else:
                eng.step_once()
            stamp = time.perf_counter() - origin
            done, n_tok = [], 0
            for rid, r in live.items():
                rec = recs[rid]
                k = r.decoded - len(rec.stamps)
                if k > 0:
                    rec.stamps.extend([stamp] * k)
                    n_tok += k
                if r.decoded >= r.true_output_len:
                    done.append(rid)
            if len(eng.shed) > n_shed:
                for r in eng.shed[n_shed:]:
                    recs[r.rid].shed = True
                    done.append(r.rid)
                n_shed = len(eng.shed)
            for rid in done:
                if live.pop(rid, None) is not None and closed:
                    nxt = next(waiting, None)
                    if nxt is not None:
                        recs[nxt.index + 1].due = stamp
                        heapq.heappush(due, (stamp, nxt.index))
            self.steps.append((now, stamp, n_tok, eng.kv.used_blocks))
        return list(recs.values())

    def served_tokens(self, records: List[Record]) -> List:
        """(rid, prompt ids, served ids) of every finished request."""
        out = []
        for rec in records:
            if rec.finished and not rec.shed:
                rid = rec.spec.index + 1
                out.append((rid, rec.spec.prompt,
                            list(self.backend.output_tokens(rid) or [])))
        return out

    def close(self) -> None:
        """Free the program's state (weights, pool, engine)."""
        self.backend.close()
        del self.engine, self.sched, self.backend
