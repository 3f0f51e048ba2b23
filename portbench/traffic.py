"""The benchmark's traffic generator: a frozen copy of the draw rules of
``src/repro_torch/serving/workload.py`` (``WorkloadGen``: lognormal
lengths from a (mean, median) pair, Poisson or BurstGPT-style bursty
arrivals, the 3:1 latency:deadline mix with best-effort traffic, SLO
jitter per user, noisy length hints), driven by a traffic file of
parameters (``portbench/traffic/<name>.json``).

Every seed serves the same work: the requests and the arrivals are drawn
once, from ``DRAW_SEED``; ``--seed`` draws only the prompt token ids (and,
elsewhere, the weights).  The lengths are heavy-tailed, so a draw per seed
would change the load itself, and runs of two seeds would differ far more
than two runs of one seed.

Arrivals are open-loop (``poisson``, ``bursty``: due times fixed in
advance) or ``closed``: ``clients`` users, each sending its next request
the moment its last one finishes, so the server always holds about
``clients`` requests.  A closed loop's requests have no due time here;
the harness gives each the time its client took it up.

Nothing here imports the program: ``Spec`` records are turned into the
port's requests by ``serve.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

KINDS = ("latency", "throughput", "none")
ARRIVALS = ("poisson", "bursty", "closed")
DRAW_SEED = 0
# arrivals drawn past the window's end: a traced run serves on into them
# for its profiled steps
TAIL_S = 10.0


@dataclasses.dataclass
class Spec:
    """One request of the traffic: ``due`` seconds after the traffic's
    origin, the SLO kind (latency: streaming; throughput: a deadline;
    none: best effort) and its limits, the lengths, the length hint the
    scheduler's predictor reads, and the prompt token ids."""
    index: int
    due: Optional[float]
    kind: str
    prompt_len: int
    output_len: int
    ttft: float
    tbt: float
    ttlt: float
    hint: float
    prompt: Optional[np.ndarray] = None


def load(path: Path) -> Dict:
    """A traffic file, with ``extends`` resolved: the named file of the
    same folder gives every key this one does not."""
    data = json.loads(Path(path).read_text())
    base = data.get("extends")
    if base:
        merged = load(Path(path).parent / f"{base}.json")
        merged.pop("why", None)
        merged.update({k: v for k, v in data.items() if k != "extends"})
        return merged
    return data


def lognormal_from(mean: float, p50: float, rng: np.random.Generator,
                   n: int = 1) -> np.ndarray:
    """Lognormal matching the (mean, median) pair: mu = ln p50,
    sigma = sqrt(2 ln(mean/p50)) (``workload._lognormal_from``)."""
    mu = math.log(max(p50, 1.0))
    sigma = math.sqrt(max(2.0 * math.log(max(mean, 1.0) / max(p50, 1.0)),
                          0.05))
    return np.maximum(1, rng.lognormal(mu, sigma, n)).astype(int)


class _Draw:
    """The ``WorkloadGen`` draws that one request needs, in its order."""

    def __init__(self, t: Dict, rng: np.random.Generator):
        self.t = t
        self.rng = rng

    def lens(self):
        t, rng = self.t, self.rng
        li = int(lognormal_from(t["prompt"]["mean"], t["prompt"]["p50"],
                                rng)[0])
        lo = int(lognormal_from(t["output"]["mean"], t["output"]["p50"],
                                rng)[0])
        li = min(li, t["prompt"]["cap"])
        lo = min(lo, t["output"]["cap"])
        return max(li, 4), max(lo, 8)

    def slo(self, kind: str):
        s = float(np.exp(self.rng.normal(0, self.t["slo"]["jitter"])))
        slo = self.t["slo"]
        if kind == "latency":
            return slo["ttft_s"] * s, slo["tbt_s"] * s, 1e9
        if kind == "throughput":
            return 0.0, 0.0, slo["deadline_s"] * s
        return 0.0, 0.0, 1e9

    def hint(self, out_len: int) -> float:
        return float(np.log1p(out_len)
                     + self.rng.normal(0, self.t["hint_noise"]))

    def kind(self) -> str:
        mix = np.asarray(self.t["mix"], float)
        mix = mix / mix.sum()
        u = self.rng.random()
        if self.rng.random() < self.t["best_effort_frac"]:
            return "none"
        return "latency" if u < mix[0] else "throughput"

    def request(self, kind: str, index: int, due: float) -> Spec:
        li, lo = self.lens()
        ttft, tbt, ttlt = self.slo(kind)
        return Spec(index, due, kind, li, lo, ttft, tbt, ttlt, self.hint(lo))


def _arrival_times(t: Dict, rng: np.random.Generator,
                   horizon: float) -> List[float]:
    """``WorkloadGen._arrivals_poisson``: Poisson at ``rate``, or with
    ``arrival`` "bursty" a rate redrawn every 16 arrivals from a Gamma
    (shape 0.7, mean 1), floored at a quarter of ``rate``."""
    ts, now, rate = [], 0.0, t["rate"]
    bursty = t["arrival"] == "bursty"
    while now < horizon:
        if bursty and len(ts) % 16 == 0:
            rate = t["rate"] * float(rng.gamma(0.7, 1.0 / 0.7))
            rate = max(rate, 0.25 * t["rate"])
        now += float(rng.exponential(1.0 / rate))
        ts.append(now)
    return ts


def check(t: Dict) -> None:
    """Raise on a traffic file the generator cannot serve."""
    if t["arrival"] not in ARRIVALS:
        raise ValueError(f"arrival {t['arrival']!r}: {' | '.join(ARRIVALS)}")
    if len(t["mix"]) != 2 or min(t["mix"]) < 0 or sum(t["mix"]) <= 0:
        raise ValueError("mix: [latency, throughput] weights")
    if t["prompt"]["cap"] + t["output"]["cap"] > t["max_len"]:
        raise ValueError("prompt cap + output cap exceed max_len")
    if t["arrival"] == "closed":
        if t["clients"] < 1:
            raise ValueError("clients must be positive")
    elif t["rate"] <= 0:
        raise ValueError("rate must be positive")


def generate(t: Dict, seed: int, seconds: float, vocab: int):
    """The traffic of one run: (specs, window start, window end), in
    seconds from the traffic's origin.  The window starts after
    ``preroll_s`` and lasts ``seconds``.  Open loop: specs sorted by due
    time, arrivals drawn to ``TAIL_S`` past the window's end.  Closed
    loop: specs in the order the clients take them up, the first
    ``clients`` due at the origin and the rest without a due time; enough
    that no client runs out before then, one request a second each."""
    check(t)
    rng = np.random.default_rng(DRAW_SEED)
    start = float(t["preroll_s"])
    end = start + seconds
    if t["arrival"] == "closed":
        c = int(t["clients"])
        dues = [0.0] * c + [None] * int(c * math.ceil(end + TAIL_S))
    else:
        dues = _arrival_times(t, rng, end + TAIL_S)
    draw = _Draw(t, rng)
    specs = []
    for i, due in enumerate(dues):
        s = draw.request(draw.kind(), i, due)
        ids = np.random.default_rng([seed % 2**63, 2, i])
        s.prompt = ids.integers(0, vocab, size=s.prompt_len).astype(np.int32)
        specs.append(s)
    return specs, start, end


def warmup(t: Dict, n: int = 512) -> List[Spec]:
    """Finished-looking requests to warm-start the scheduler's length
    predictor, as ``WorkloadGen.warmup_requests``: kinds in turn, from a
    generator of their own (``DRAW_SEED`` + 777777), so the warm start is
    the same for every run seed."""
    draw = _Draw(t, np.random.default_rng(DRAW_SEED + 777_777))
    kinds = [k for k, w in zip(KINDS, t["mix"]) if w > 0]
    return [draw.request(kinds[i % len(kinds)], -i - 1, 0.0)
            for i in range(n)]
