"""The metrics that read the program's own spans (``program_spans``): a
tiny traced run on the CPU reports the program-span ones and leaves the
device-trace ones out; only the cell that lists them loads them, so the
other cells run the harness as it is; on synthetic profiler events
``Tracer._profile`` reads the same ``busy_s``, ``window_s`` and
``steps`` with the program's ``rt:`` ranges present and names idle by
the innermost span; ``decode_forwards`` places each device operation by
its launch call, and refuses a reading that fails its cross-checks."""

import json
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from portbench import program_spans, run as bench_run, tracer as tracer_mod
from portbench.bench import Bench

PKG = Path(__file__).resolve().parents[1]
DATA = PKG / "tests" / "data"
NEW = ("model.decode_enqueue_ms", "model.decode_busy_ms",
       "model.decode_launches", "backend.decode_lane_util")
DEVICE = {"model.decode_busy_ms", "model.decode_launches"}


@pytest.fixture
def restored(monkeypatch):
    """What ``install()`` patches, put back after the test: the patch is
    global to the process, and the other tests of this worker run the
    harness as it is."""
    monkeypatch.setattr(tracer_mod.Tracer, "__init__",
                        tracer_mod.Tracer.__init__)
    for name in ("_host_spans", "_device_events"):
        monkeypatch.setattr(tracer_mod, name, getattr(tracer_mod, name))
    monkeypatch.setattr(tracer_mod, "_program_spans", False, raising=False)


@pytest.fixture
def installed(restored):
    program_spans.install()


def test_traced_tiny_run_reads_the_program_spans(installed):
    from portbench import traffic
    from repro_torch.serving.torch_backend import _rows

    bench = Bench(PKG.parent)
    metrics = [(m, bench.reader(m["name"])) for m in bench.spec["per_layer"]
               if m["name"] in NEW]
    assert len(metrics) == len(NEW)
    cfg = json.loads((DATA / "tiny.json").read_text())
    t = traffic.load(DATA / "tiny_chat.json")
    run, values, _, _ = bench_run.serve_cell(
        cfg, t, {"name": "tiny.chat"}, metrics, 2**31 + 11, 4.0, True, "cpu")
    assert set(values) == set(NEW) - DEVICE
    v = {k: x["value"] for k, x in values.items()}
    assert v["model.decode_enqueue_ms"] > 0
    assert 0 < v["backend.decode_lane_util"] <= 100
    # lanes over rows agree with the harness's own record of each decode
    # forward's live contexts, over every call of the run
    sp = run.tracer.spans
    dec = sp.select("backend.decode")
    lanes = [len(f[0]) for f in run.tracer.decode_fw]
    assert program_spans.attr_sum(run, dec, "lanes") == sum(lanes)
    assert program_spans.attr_sum(run, dec, "rows") \
        == sum(_rows(n) for n in lanes)
    # the profiled stretch mirrored the program's spans
    names = {e.name for e in run.tracer._prof.events()}
    assert {"rt:model.decode", "rt:layer.ffn", "pb:model.decode"} <= names
    assert sp.dropped == 0


def test_untraced_runs_report_what_they_did(restored):
    bench = Bench(PKG.parent)
    got = {c: sorted(m["name"] for m in bench.metrics(c, False))
           for c in ("nemo12b.chat", "yi34b.chat_closed", "yi34b.chat")}
    assert got == {
        "nemo12b.chat": ["output_tok_s", "setup_s", "tbt_p50_ms"],
        "yi34b.chat_closed": ["capacity_tok_s", "setup_s", "tbt_p50_ms",
                              "ttft_p50_ms"],
        "yi34b.chat": ["output_tok_s", "setup_s", "tbt_p50_ms"]}
    traced = {c: {m["name"] for m in bench.metrics(c, True)} for c in got}
    assert set(NEW) <= traced["yi34b.chat"]
    # the traced runs of the other cells load their readers and leave the
    # harness unpatched
    init = tracer_mod.Tracer.__init__
    for cell in ("nemo12b.chat", "yi34b.chat_closed"):
        assert not set(NEW) & traced[cell]
        for name in traced[cell]:
            bench.reader(name)
    assert tracer_mod.Tracer.__init__ is init
    assert tracer_mod._program_spans is False
    bench.reader("model.decode_enqueue_ms")
    assert tracer_mod._program_spans is True


def _ev(name, a, b, dev=False, id=0, link=0):
    return NS(name=name, time_range=NS(start=a, end=b), id=id,
              device_type=DeviceType.CUDA if dev else DeviceType.CPU,
              linked_correlation_id=link)


def _stretch(program: bool):
    """Three engine steps (the first the warm-up), each one decode
    forward: host ranges in µs, two kernels per step with an idle gap
    between them inside the forward, one kernel launched by a graph."""
    evs = []
    for s, t in enumerate((0, 1000, 2000)):
        evs += [_ev("pb:engine", t, t + 900),
                _ev("pb:model.decode", t + 100, t + 700),
                _ev("cudaLaunchKernel", t + 150, t + 160, id=10 * s + 1),
                _ev("cudaGraphLaunch", t + 600, t + 610, id=10 * s + 2),
                _ev("paged_kernel", t + 200, t + 300, dev=True, id=10 * s + 1),
                _ev("gemm_a", t + 650, t + 700, dev=True, id=10 * s + 2),
                _ev("gemm_b", t + 690, t + 750, dev=True, id=10 * s + 2)]
        if program:
            evs += [_ev("rt:model.decode", t + 110, t + 690),
                    _ev("rt:layer.ffn", t + 320, t + 640),
                    # the profiler's copies of the ranges on the device
                    _ev("rt:model.decode", t + 200, t + 750, dev=True),
                    _ev("rt:layer.ffn", t + 200, t + 300, dev=True)]
    return evs


def _profile(evs):
    tr = tracer_mod.Tracer.__new__(tracer_mod.Tracer)
    tr._prof, tr.cuda = NS(events=lambda: evs), True
    return tr._profile()


def test_profile_reads_the_same_with_the_program_ranges(installed):
    before, after = _profile(_stretch(False)), _profile(_stretch(True))
    for k in ("busy_s", "window_s", "steps", "paged_s"):
        assert before[k] == after[k], k
    assert after["steps"] == 2 and after["window_s"] == pytest.approx(
        1900e-6)
    assert dict(after["ops"]) == dict(before["ops"])
    # the gaps between the kernels inside the forwards are the program's
    # layer.ffn spans now, pb:model.decode's before
    assert after["idle"]["layer.ffn"] == pytest.approx(700e-6)
    assert before["idle"]["model.decode"] == pytest.approx(
        after["idle"]["model.decode"] + after["idle"]["layer.ffn"])
    assert "layer.ffn" not in before["idle"]


def test_decode_forwards_place_operations_by_their_launch_call():
    evs = _stretch(True)
    # an operation without its launch call falls back to the host op it
    # is linked to
    evs += [_ev("aten::mm", 2400, 2450, id=99),
            _ev("gemm_c", 2500, 2520, dev=True, id=77, link=99)]
    out = program_spans._decode_forwards(evs)
    # the warm-up step is left out; a graph's launch counts once
    assert out["launches"] == [2, 3]
    assert out["paged"] == [1, 1]
    assert out["fallbacks"] == 1
    assert out["busy_s"] == pytest.approx([200e-6, 220e-6])
    assert program_spans._decode_forwards(_stretch(False))["launches"] == []


def test_decode_forwards_refuse_a_reading_that_fails_its_checks():
    def run(layers, busy_s):
        tr = NS(_prof=NS(events=lambda: _stretch(True)), spans=object())
        return NS(tracer=tr, device="cuda", profile=dict(busy_s=busy_s),
                  cfg=dict(num_hidden_layers=layers))

    fw = program_spans.decode_forwards(run(1, 420e-6))
    assert fw["launches"] == [2, 2]
    with pytest.raises(RuntimeError, match="one per layer"):
        program_spans.decode_forwards(run(2, 420e-6))
    with pytest.raises(RuntimeError, match="profiled stretch"):
        program_spans.decode_forwards(run(1, 300e-6))
