"""Roofline of the port (the reference's ``repro.launch.roofline``): a
counter of one run's FLOPs and bytes, the roofline terms of a record, the
analytic model FLOPs, and a measured profile of one paged decode dispatch.

Hardware constants are the H100 SXM5's spec-sheet numbers, not
measurements: 989 TFLOP/s dense bf16 (``PEAK_FLOPS``) and 3.35 TB/s of
HBM3 (``HBM_BW``), the figures the kernels' bounds in ``chip_smoke.py``
use; NVLink 4 at 450 GB/s per direction inside a node of 8 GPUs
(``NVLINK_BW``) and one 400 Gb/s NIC per GPU across nodes, 50 GB/s
(``NET_BW``).  A collective over a group of more than ``NODE`` ranks goes
at the cross-node rate (``link_bw``).

No HLO walk.  The reference parses XLA's compiled HLO (``parse_hlo``,
``_walk``, ``analyze_compiled``) because ``cost_analysis`` visits scan
bodies once; the port runs eager PyTorch and has no compiled program, so
those have no counterpart.  ``CostCounter`` counts one run of a function
instead, op by op as a ``TorchDispatchMode``:

- ``hlo_flops_per_chip``: the FLOPs of the mm / bmm / addmm / baddbmm /
  convolution ops (``torch.utils.flop_counter``'s formulas), plus what the
  hand-written kernels report;
- ``hlo_bytes_per_chip``: every aten op's tensor operands and results,
  view ops excepted (they move nothing), the counterpart of the
  reference's pessimistic count;
- ``hlo_bytes_opt_per_chip``: the matmul, slice / index and kernel
  traffic only, the counterpart of its ``bytes_opt``.

The kernels launch through ``ctypes``, which no dispatch mode sees: each
wrapper reports its analytic FLOPs and bytes (``kernels.cost``), and the
ops of its plain version (on the CPU or ``meta``) are not counted again.
``hlo_opaque`` is true only when some kernel launched without reporting.
The record keys are the reference's, so ``launch.report`` reads the
port's records as they are.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NET_BW = 50e9
NODE = 8

_COLL_FACTORS = {
    "all-reduce": lambda b, n: 2.0 * b * (n - 1) / max(n, 1),
    "all-gather": lambda b, n: b * (n - 1) / max(n, 1),
    "reduce-scatter": lambda b, n: b * (n - 1),
    "all-to-all": lambda b, n: b * (n - 1) / max(n, 1),
    "collective-permute": lambda b, n: b,
}


def link_bw(group: int) -> float:
    """Bytes per second a collective over ``group`` ranks moves per rank:
    NVLink inside a node, the NIC across nodes."""
    return NVLINK_BW if group <= NODE else NET_BW


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes on the wire per rank of one collective of ``kind`` whose
    result is ``nbytes`` per rank (the reference's ring factors; a
    reduce-scatter's result is the shard)."""
    return _COLL_FACTORS[kind](nbytes, group)


_ATEN = torch.ops.aten
_MATMUL = {p for p in (_ATEN.mm, _ATEN.addmm, _ATEN.bmm, _ATEN.baddbmm,
                       _ATEN.convolution, _ATEN._convolution,
                       _ATEN.convolution_backward)}
# ops that read only the rows they take: 2 x the result
_SLICERS = {_ATEN.index, _ATEN.index_select, _ATEN.gather,
            _ATEN.embedding}
# ops that write only the rows they are given: 2 x the update
_UPDATERS = {_ATEN.index_put, _ATEN.index_put_, _ATEN.index_add,
             _ATEN.index_add_, _ATEN.index_copy, _ATEN.index_copy_,
             _ATEN.scatter, _ATEN.scatter_, _ATEN.scatter_add,
             _ATEN.scatter_add_}
_UPDATE_ARG = {"index_put": 2, "index_put_": 2}     # else the last tensor


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Count one run: ``with CostCounter() as c: fn(...)``; then
    ``c.record(chips)`` gives the reference's keys.  ``track_live`` also
    follows the bytes of the tensors the run allocates (``peak_live``, the
    most alive at once; on ``meta`` tensors nothing is allocated, but the
    count holds)."""

    def __init__(self, track_live: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_opt = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind = defaultdict(float)
        self.coll_count = defaultdict(int)
        self.max_group = 1                   # the largest collective group
        self.kernels = defaultdict(int)      # reports per kernel
        self.device_reports = 0              # reports of launched kernels
        self.launched = 0                    # launches during the run
        self.track_live = track_live
        self.live = 0
        self.peak_live = 0
        self._suppress = 0
        self._launch0 = 0

    def __enter__(self):
        cost.ACTIVE.append(self)
        self._launch0 = cost.launch_total()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        cost.ACTIVE.remove(self)
        self.launched = cost.launch_total() - self._launch0
        return out

    @property
    def opaque(self) -> bool:
        """Some kernel launched without reporting its cost."""
        return self.launched > self.device_reports

    # -- what the kernels and the collective plan add ------------------
    def kernel(self, name, device, run, cost_fn):
        """Run a kernel wrapper's call (``run``) with op counting off, then
        add its analytic (flops, bytes) from ``cost_fn``."""
        self._suppress += 1
        try:
            out = run()
        finally:
            self._suppress -= 1
        flops, nbytes = cost_fn()
        self.flops += flops
        self.bytes += nbytes
        self.bytes_opt += nbytes
        self.kernels[name] += 1
        if device.type == "cuda":
            self.device_reports += 1
        self._track(_tensors(out))
        return out

    def collective(self, kind: str, nbytes: float, group: int,
                   count: int = 1) -> None:
        """Add ``count`` collectives of ``kind`` whose result is ``nbytes``
        per rank over ``group`` ranks."""
        if group <= 1 or count <= 0:
            return
        wire = count * wire_bytes(kind, nbytes, group)
        self.coll_bytes += wire
        self.coll_by_kind[kind] += wire
        self.coll_count[kind] += count
        self.max_group = max(self.max_group, group)
        self.bytes_opt += count * nbytes

    # -- the op counter -------------------------------------------------
    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, outs) -> None:
        if not self.track_live:
            return
        for t in outs:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_live = max(self.peak_live, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suppress or func.is_view:
            return out
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if packet in _MATMUL:
            self.flops += flop_registry[packet](*args, out_val=out,
                                                **kwargs)
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += moved
            self.bytes_opt += moved
        elif packet in _SLICERS:
            moved = 2 * sum(map(_nbytes, outs))
            self.bytes += moved
            self.bytes_opt += moved
        elif packet in _UPDATERS:
            ix = _UPDATE_ARG.get(packet.__name__)
            upd = args[ix] if ix is not None else ins[-1]
            moved = 2 * _nbytes(upd)
            self.bytes += moved
            self.bytes_opt += moved
        elif packet is _ATEN.copy_:
            self.bytes += 2 * _nbytes(args[1])
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if self.track_live:
            fresh = [t for t, r in zip(outs, func._schema.returns)
                     if r.alias_info is None]
            self._track(fresh)
        return out

    def record(self, chips: int = 1) -> dict:
        """The reference's ``analyze_compiled`` keys, per chip (counts of a
        run on one device are divided by ``chips``)."""
        return {
            "hlo_flops_per_chip": self.flops / chips,
            "hlo_bytes_per_chip": self.bytes / chips,
            "hlo_bytes_opt_per_chip": self.bytes_opt / chips,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": {k: round(v)
                             for k, v in self.coll_by_kind.items()},
            "coll_count": dict(self.coll_count),
            "kernel_reports": dict(self.kernels),
        }


# ---------------------------------------------------------------------------
# Roofline terms + analytic model FLOPs
# ---------------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per the assignment: 6·N·D (train) with N = active params;
    2·N·D forward-only (prefill), 2·N·B (decode, one token/seq)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def roofline_terms(rec: dict) -> dict:
    """Three terms in seconds + dominant bottleneck from a record, with the
    H100's constants; the keys and formulas of the reference's.  The
    collective term runs at ``link_bw`` of the record's largest
    collective group (``coll_group``, else ``chips``).

    The memory term is a [optimistic, pessimistic] pair: the pessimistic
    count charges every aten op's operands and result; the optimistic one
    counts matmul + collective + slice + kernel traffic only.  The
    headline ``mfu_bound`` uses the optimistic memory term;
    ``mfu_bound_pess`` keeps the pessimistic."""
    chips = rec.get("chips", 256)
    fl = rec.get("hlo_flops_per_chip", 0.0)
    by = rec.get("hlo_bytes_per_chip", 0.0)
    by_o = rec.get("hlo_bytes_opt_per_chip", by)
    co = rec.get("coll_bytes_per_chip", 0.0)
    t_c = fl / PEAK_FLOPS
    t_m = by / HBM_BW
    t_mo = by_o / HBM_BW
    t_i = co / link_bw(rec.get("coll_group", chips))
    dom = max((t_c, "compute"), (t_mo, "memory"), (t_i, "collective"))[1]
    mf = rec.get("model_flops", 0.0)
    total_hlo = fl * chips
    ideal = mf / chips / PEAK_FLOPS
    return {
        "t_compute_s": t_c, "t_memory_s": t_m, "t_memory_opt_s": t_mo,
        "t_collective_s": t_i,
        "dominant": dom,
        "useful_ratio": (mf / total_hlo) if total_hlo else 0.0,
        "roofline_s": max(t_c, t_mo, t_i),
        "mfu_bound": ideal / max(t_c, t_mo, t_i, 1e-30),
        "mfu_bound_pess": ideal / max(t_c, t_m, t_i, 1e-30),
    }


# ---------------------------------------------------------------------------
# Serving-path profiling: roofline ONE PagedTorchBackend decode dispatch
# ---------------------------------------------------------------------------
def _best_s(fn, repeats: int, device: torch.device) -> float:
    """Best of ``repeats`` timed calls of ``fn`` after one warm-up: CUDA
    events on the card, ``perf_counter`` on the CPU."""
    fn()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def roofline_decode_step(arch: str = "tinyllama-1.1b", batch: int = 4,
                         num_blocks: int = 32, page: int = 16,
                         max_len: int = 64, repeats: int = 3,
                         registry=None, steps: int = 1, device="cuda",
                         reduced: bool = True) -> dict:
    """Profile one paged decode dispatch of ``PagedTorchBackend``: counted
    FLOPs and bytes (``CostCounter``), the analytic 2·N·B decode FLOPs, a
    best-of-``repeats`` measured time, and the roofline terms.  Every
    number lands in ``registry`` as a ``roofline_decode_*`` gauge when one
    is passed.

    The backend computes decode calls on a fixed ``ROWS`` lanes (its
    batch-invariance contract), so the record's ``batch`` is the number of
    lanes computed and ``model_flops`` is taken at that count; ``live``
    holds the ``batch`` lanes asked for.  Each live lane has one resident
    page of context (position page-1, a page of its own); the padding lanes
    write the scrap page at position 0, as the backend's do.

    On the card the timed dispatches are replays of the decode forward's
    CUDA graph (``Model.decode_paged``); the counted one runs eager.
    With ``steps`` > 1 it also profiles the window of ``steps`` tokens
    (``_decode_steps``: forward, on-device sampling and feedback, a Python
    loop of forwards, the sampling and feedback eager) and reports
    ``multi_measured_s``, its per-token time and
    ``multi_speedup_per_token`` against the single dispatch.

    ``device`` "cuda" (the default) needs the card and raises RuntimeError
    without one; "cpu" runs the plain versions of the kernels.  ``reduced``
    picks the reduced test config (False: the published width)."""
    import numpy as np

    from repro_torch.configs.shapes import Shape
    from repro_torch.obs import NULL
    from repro_torch.serving.torch_backend import (PagedTorchBackend,
                                                   _rows)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("roofline_decode_step was asked for the card and "
                           "CUDA is not available; pass device='cpu'")
    obs = registry if registry is not None else NULL
    be = PagedTorchBackend(arch, num_blocks=max(num_blocks, batch), page=page,
                           max_len=max_len, seed=0, device=device,
                           reduced=reduced)
    B = _rows(batch)
    toks = np.zeros((B, 1), np.int32)
    pos = np.zeros(B, np.int32)
    pos[:batch] = page - 1
    tabs = np.full((B, be.n_max), be.scrap, np.int32)
    tabs[:batch, 0] = np.arange(batch)
    args = [be._dev(a) for a in (toks, pos, tabs)]

    def dispatch():
        return be.model.decode_paged(be.params, be.pages, *args,
                                     fused=be.fused)

    dispatch()                       # warm: the f32 head copy, the kernels
    with CostCounter() as counter:
        dispatch()
    rec = counter.record(chips=1)
    rec["hlo_opaque"] = counter.opaque
    rec["chips"] = 1
    rec["model_flops"] = model_flops(
        be.cfg, Shape("decode_step", seq_len=page, global_batch=B,
                      kind="decode"))
    best = _best_s(dispatch, repeats, be.device)
    rec["measured_s"] = best
    rec.update(roofline_terms(rec))
    rec["mfu_measured"] = rec["model_flops"] / (best * PEAK_FLOPS)
    rec.update(arch=arch, batch=B, live=batch, page=page,
               device=str(be.device), fused=be.fused)

    if steps > 1:
        rem = np.zeros(B, np.int32)
        rem[:batch] = steps
        rids = np.arange(1, B + 1, dtype=np.int32)
        staged = args + [be._dev(rem), be._dev(rids)]

        def window():
            return be._decode_steps(staged, steps, be.fused, be.sampler)

        window()
        with CostCounter() as counter_n:
            window()
        best_n = _best_s(window, repeats, be.device)
        rec["multi_steps"] = steps
        rec["multi_hlo_flops_per_chip"] = counter_n.flops
        rec["multi_hlo_bytes_per_chip"] = counter_n.bytes
        rec["multi_measured_s"] = best_n
        rec["multi_measured_s_per_token"] = best_n / steps
        rec["multi_speedup_per_token"] = best * steps / best_n

    for key in ("hlo_flops_per_chip", "hlo_bytes_per_chip",
                "coll_bytes_per_chip", "model_flops", "t_compute_s",
                "t_memory_s", "t_collective_s", "roofline_s", "measured_s",
                "mfu_bound", "mfu_measured", "multi_measured_s",
                "multi_measured_s_per_token", "multi_speedup_per_token"):
        if key not in rec:
            continue
        obs.gauge(f"roofline_decode_{key}",
                  "paged decode-step roofline profile",
                  arch=arch, batch=str(B)).set(float(rec[key]))
    be.close()
    return rec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Roofline one PagedTorchBackend decode dispatch")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4,
                    help="live lanes (the call computes 64)")
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--num-blocks", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=1,
                    help="also profile the window of this many tokens "
                    "(before/after pair in the record)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced test config (default: full width)")
    ap.add_argument("--metrics-out", default=None,
                    help="directory for registry snapshots (DESIGN.md §9)")
    args = ap.parse_args(argv)

    registry = None
    if args.metrics_out:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry()
    rec = roofline_decode_step(
        arch=args.arch, batch=args.batch, num_blocks=args.num_blocks,
        page=args.page, max_len=args.max_len, repeats=args.repeats,
        registry=registry, steps=args.steps, device=args.device,
        reduced=args.reduced)
    print(f"== decode-step roofline: {args.arch} B={rec['batch']} "
          f"(live {rec['live']}) page={rec['page']} on {rec['device']}"
          + (" [opaque: a kernel launched without reporting its cost]"
             if rec["hlo_opaque"] else ""))
    keys = ["hlo_flops_per_chip", "hlo_bytes_per_chip", "model_flops",
            "t_compute_s", "t_memory_s", "roofline_s", "measured_s",
            "mfu_bound", "mfu_measured", "dominant"]
    if args.steps > 1:
        keys += ["multi_steps", "multi_measured_s",
                 "multi_measured_s_per_token", "multi_speedup_per_token"]
    for k in keys:
        v = rec[k]
        print(f"   {k:<26} {v:.4g}" if isinstance(v, float)
              else f"   {k:<26} {v}")
    if args.metrics_out:
        from repro_torch.obs import dump_all
        paths = dump_all(args.metrics_out, registry=registry,
                         extra={k: rec[k] for k in rec
                                if not isinstance(rec[k], (list, dict))})
        print("   wrote: " + ", ".join(sorted(paths)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
