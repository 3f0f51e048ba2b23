"""The port's wall-clock span recorder (``obs/spans.py``) in the paged
backend and model step, on the CPU: off by default, storing nothing and
entering no profiler range; token streams equal with it on and off; spans
nested as the backend and model call each other, with the rows, lanes and
tokens that were staged; an ``rt:`` range of the same name and nesting
for every span while a profiler runs; the off path never beginning or
ending a span; and a span closed when its body raises."""

import collections

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.obs.spans import NULL_SPANS, NullSpans, Spans  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import (ROWS,  # noqa: E402
                                               PagedTorchBackend)

LAYER = ("layer.slice", "layer.attn", "layer.ffn")
FORWARD = ("model.decode", "model.prefill")


class Fixed:
    """A drafter that proposes the same tokens for every lane, so the
    verify call runs whatever the weights."""

    def propose(self, hist, d):
        return [1, 2, 3][:d]


def _backend():
    return PagedTorchBackend(page=16, device="cpu", num_blocks=32,
                             max_len=128, seed=0)


def _req(rid, prompt, out):
    return Request(rid=rid, app="chatbot", arrival=0.0, prompt_len=prompt,
                   true_output_len=out, slo=SLOSpec("throughput", ttlt=1e6))


def _script(be):
    """A fixed sequence of backend calls: two prompts prefilled (one of
    them longer than a 64-row call), two decode steps, a verify step.
    Returns what was staged: (rows, lanes) per staging, and the real
    tokens of each prefill chunk."""
    staged, chunks = [], []
    stage = be._stage_decode

    def spy(reqs, tables, n):
        out = stage(reqs, tables, n)
        staged.append((out[0].shape[0], len(reqs)))
        return out

    be._stage_decode = spy
    a, b = _req(1, 70, 4), _req(2, 20, 4)
    tabs = {1: [0, 1, 2, 3, 4], 2: [5, 6]}
    be.begin_step()
    for r in (a, b):
        be.prefill_chunk(r, 0, r.prompt_len, tabs[r.rid])
        chunks.append(r.prompt_len)
    be.step_time(90, [])
    for _ in range(2):
        be.begin_step()
        be.decode_batch([a, b], [tabs[1], tabs[2]])
        a.decoded += 1
        b.decoded += 1
        be.step_time(0, [70, 20])
    be.drafter = Fixed()
    be.begin_step()
    be.decode_verify_batch([a, b], [tabs[1], tabs[2]], [2, 0])
    be.step_time(0, [71, 21], 2)
    del be._stage_decode
    return staged, chunks


def _engine_streams(spans):
    be = PagedTorchBackend(page=16, device="cpu", num_blocks=4, max_len=64,
                           seed=0)
    if spans is not None:
        be.attach_spans(spans)
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=2, prefill_budget=16))
    eng.load([_req(i + 1, 30, 10) for i in range(2)], [])
    fin = eng.run()
    assert len(fin) == 2
    return {r.rid: list(be.generated[r.rid]) for r in fin}


def _rt_events(prof):
    return [e for e in prof.events() if e.name.startswith("rt:")]


def test_off_by_default_stores_nothing_and_enters_no_range():
    be = _backend()
    assert be.spans is NULL_SPANS and be.model.spans is NULL_SPANS
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _script(be)
    assert not _rt_events(prof)
    assert NULL_SPANS.on is False and not hasattr(NULL_SPANS, "name")
    assert NULL_SPANS.span("a") is NULL_SPANS.span("b", rows=1)


def test_streams_equal_with_the_recorder_on_and_off():
    sp = Spans()
    assert _engine_streams(sp) == _engine_streams(None)
    assert len(sp.select("model.decode")) > 0 and sp.dropped == 0


def test_spans_nest_and_carry_the_staged_work():
    be = _backend()
    sp = Spans()
    be.attach_spans(sp)
    staged, chunks = _script(be)
    names = list(sp.name)
    parent = [sp.name[p] if p >= 0 else None for p in sp.parent]
    assert all(sp.t1[i] >= sp.t0[i] > 0 for i in range(len(sp)))
    for i, n in enumerate(names):
        if n in LAYER:
            assert parent[i] in FORWARD
        elif n in ("model.embed", "model.lm_head"):
            assert parent[i] == "model.decode" or (
                n == "model.embed" and parent[i] == "model.prefill")
        elif n == "model.prefill":
            assert parent[i] == "backend.prefill"
        elif n in ("model.decode", "sampler"):
            assert parent[i] in ("backend.decode", None)
        else:
            assert n.startswith("backend.") and parent[i] is None, n
    # the verify path records nothing: of the verify step, only its plain
    # call's forward and sampler, outside any backend.decode span
    assert [n for n, p in zip(names, parent)
            if p is None and n in ("model.decode", "sampler")] \
        == ["model.decode", "sampler"]
    # every layer's three spans inside each forward
    L = be.cfg.num_layers
    for f in sp.select("model.decode") + sp.select("model.prefill"):
        kids = collections.Counter(sp.name[i] for i in range(len(sp))
                                   if sp.parent[i] == f)
        assert all(kids[k] == L for k in LAYER), kids
    # staged rows and lanes: the plain decode calls, and the verify step's
    # plain call (its undrafted lane)
    stages = sp.select("backend.stage")
    assert [(sp.attrs[i]["rows"], sp.attrs[i]["lanes"])
            for i in stages[:len(staged)]] == staged
    assert staged == [(ROWS, 2), (ROWS, 2), (ROWS, 1)]
    assert (sp.attrs[stages[-1]]["rows"], sp.attrs[stages[-1]]["lanes"]) \
        == (ROWS, 1)
    dec = sp.select("backend.decode")
    assert [(sp.attrs[i]["rows"], sp.attrs[i]["lanes"]) for i in dec] \
        == [(ROWS, 2), (ROWS, 2)]
    assert [sp.attrs[i]["rows"] for i in sp.select("model.decode")] \
        == [ROWS] * 3
    # prefill: one 64-row call per sub-chunk, its real tokens
    pre = sp.select("model.prefill")
    want = [min(ROWS, n - lo) for n in chunks for lo in range(0, n, ROWS)]
    assert [sp.attrs[i]["tokens"] for i in pre] == want
    assert all(sp.attrs[i]["rows"] == ROWS for i in pre)
    (flush,) = sp.select("backend.prefill")
    assert sp.attrs[flush] == dict(rows=ROWS * len(want), tokens=sum(chunks))
    # the host's waits: two decode reads and four step syncs
    assert len(sp.select("backend.sync")) == 2 + 4


def test_profiler_mirrors_every_span():
    be = _backend()
    sp = Spans()
    be.attach_spans(sp)
    _script(be)                     # outside the profiler: no mirrors
    n0 = len(sp)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _script(be)
    mine = collections.Counter(
        (sp.name[i], sp.name[sp.parent[i]] if sp.parent[i] >= 0 else None)
        for i in range(n0, len(sp)))

    def outer(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("rt:"):
            p = p.cpu_parent
        return None if p is None else p.name[3:]

    theirs = collections.Counter((e.name[3:], outer(e))
                                 for e in _rt_events(prof))
    assert theirs == mine and len(mine) > 5


class CountingSpans(Spans):
    """A recorder that counts its ``span`` calls."""

    calls = 0

    def span(self, name, **attrs):
        self.calls += 1
        return super().span(name, **attrs)


class CountingNullSpans(NullSpans):
    """The off recorder, counting its ``span`` calls and refusing to begin
    or end a span."""

    calls = 0

    def span(self, name, **attrs):
        self.calls += 1
        return super().span(name, **attrs)

    def begin(self, *a, **k):
        raise AssertionError("begin on the off path")

    def end(self, i):
        raise AssertionError("end on the off path")


def test_off_path_tests_on_and_does_nothing_else():
    on, off = CountingSpans(), CountingNullSpans()
    streams = []
    for sp in (on, off):
        be = _backend()
        be.attach_spans(sp)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _script(be)
        streams.append({k: list(v) for k, v in be.generated.items()})
        if sp is off:
            assert not _rt_events(prof)
    # as many span sites reached on the off path as on the on path, one
    # span recorded per site on: no site does anything more when off
    assert off.calls == on.calls == len(on) > 0
    assert streams[0] == streams[1]


def test_bounded_storage_counts_drops():
    sp = Spans(capacity=3)
    outer = sp.begin("a", rows=1)
    idx = [sp.begin("b"), sp.begin("c"), sp.begin("d")]
    assert idx[-1] == -1 and sp.dropped == 1
    for i in reversed(idx):
        sp.end(i)
    sp.end(outer)
    assert sp.name == ["a", "b", "c"] and sp.parent == [-1, 0, 1]
    assert sp.select("c") == [2] and sp.attrs[0] == {"rows": 1}
    # a span left open inside another is closed with it, its end kept 0
    sp = Spans()
    a = sp.begin("a")
    sp.begin("b")
    sp.end(a)
    assert sp.select("b") == [] and sp.select("a") == [0]
    # a span is closed when its body raises
    sp = Spans()
    with pytest.raises(ValueError):
        with sp.span("a", rows=2):
            raise ValueError
    assert sp.select("a") == [0] and sp.attrs[0] == {"rows": 2}
    assert not sp._open
