"""The paged forwards' CUDA graphs (``models/paged_graphs.py``) on the
CPU: which calls may take a graph (CUDA inputs at tp=1, outside a capture
and a dispatch mode), the eager paths bitwise ``_decode_forward`` and the
int-argument prefill with the counters at zero on the CPU, under a TP
context and under a cost counter, prefill's device start and length
writing the pages the int path writes, and the graph table's keying by
kind and shape, invalidation by its owner and counts on a stub capture,
whose graph runs the captured forward again on its own buffers.  The
graphs themselves run on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import numpy as np  # noqa: E402

from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch.roofline import CostCounter  # noqa: E402
from repro_torch.models import paged_graphs as pg  # noqa: E402
from repro_torch.models.layers import _inv_freq  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.partition import NULL_CTX, AxisCtx  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.obs.spans import Spans  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402

PAGE, N_MAX, POOL = 8, 4, 12


class StubGraph:
    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def stub_capture(graphs, forward, inputs):
    """Runs the forward once, as a capture records it; the stub graph's
    replay runs it again on the same buffers into the same output (a
    prefill forward has none: it writes the pages)."""
    out = forward(*inputs)
    if out is None:
        return StubGraph(lambda: forward(*inputs)), None
    return StubGraph(lambda: out.copy_(forward(*inputs))), out


class CudaLike:
    """A tensor's stand-in that ``usable`` reads as a CUDA tensor."""

    def __init__(self, t):
        self.is_cuda, self.dtype = True, t.dtype


class Identity:
    """A TP group of one rank: every collective returns its input."""

    def all_reduce(self, x):
        return x

    def all_gather(self, x):
        return x


def _on_card(monkeypatch):
    """``usable`` with its device test passed, every other condition its
    own."""
    real = pg.usable
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(pg, "usable", lambda ctx, *ts: real(
        ctx, *(CudaLike(t) if isinstance(t, torch.Tensor) else t
               for t in ts)))


@pytest.fixture
def on_card(monkeypatch):
    _on_card(monkeypatch)


def _model(arch="tinyllama-1.1b", ctx=NULL_CTX, layers=2, pool=POOL,
           page=PAGE):
    cfg = dataclasses.replace(reduced_config(arch), num_layers=layers)
    m = build_model(cfg, ctx)
    m.graphs = pg.PagedGraphs(capture=stub_capture)
    params = m.init(torch.Generator().manual_seed(0))
    pages = m.init_paged_caches(pool, page, "cpu")
    return m, params, pages


def _counts(m, kind):
    """(captures, replays) of ``kind`` in the model's graph table."""
    return m.graphs.captures[kind], m.graphs.replays[kind]


def _inputs(B, step):
    g = np.random.default_rng(step)
    toks = torch.tensor(g.integers(0, 256, (B, 1)), dtype=torch.int32)
    pos = torch.tensor(g.integers(0, PAGE * N_MAX, B), dtype=torch.int32)
    tabs = torch.tensor(g.permutation(POOL - 1)[:N_MAX][None].repeat(B, 0),
                        dtype=torch.int32)
    return toks, pos, tabs


def _pages_copy(pages):
    return {"prefix": tuple({k: v.clone() for k, v in p.items()}
                            for p in pages["prefix"]),
            "units": {n: {k: v.clone() for k, v in p.items()}
                      for n, p in pages["units"].items()}}


def _equal_pools(a, b):
    for n, pool in a["units"].items():
        for k, t in pool.items():
            assert torch.equal(t, b["units"][n][k])


def test_usable_takes_cuda_int32_calls_at_tp1_outside_modes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    t = torch.zeros((4, 1), dtype=torch.int32)
    cuda = [CudaLike(t)] * 3
    assert pg.usable(NULL_CTX, *cuda)
    assert pg.usable(NULL_CTX, cuda[0], 64, cuda[0], 40)   # host ints aside
    assert not pg.usable(NULL_CTX, t, t[:, 0], t)          # on the CPU
    assert not pg.usable(AxisCtx(tp_attn_axis=Identity()), *cuda)
    assert not pg.usable(NULL_CTX, cuda[0],
                         CudaLike(t.long()), cuda[0])      # not int32
    with CostCounter():
        assert not pg.usable(NULL_CTX, *cuda)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert not pg.usable(NULL_CTX, *cuda)


@pytest.mark.parametrize("case", ["cpu", "tp_ctx", "cost_counter"])
def test_eager_paths_equal_the_forward_and_count_nothing(case, request):
    """Three calls of one shape, which would capture and replay if graphs
    engaged, give ``_decode_forward``'s logits and pools bitwise."""
    ctx = NULL_CTX
    if case != "cpu":
        request.getfixturevalue("on_card")
    if case == "tp_ctx":
        ctx = AxisCtx(tp_attn_axis=Identity(), tp_mlp_axis=Identity(),
                      tp_vocab_axis=Identity())
    m, params, pages = _model(ctx=ctx)
    ref = _pages_copy(pages)
    for step in range(3):
        toks, pos, tabs = _inputs(8, step)
        want, ref = m._decode_forward(params, ref, toks, pos, tabs,
                                      fused=True)
        if case == "cost_counter":
            with CostCounter():
                got, pages = m.decode_paged(params, pages, toks, pos, tabs,
                                            fused=True)
        else:
            got, pages = m.decode_paged(params, pages, toks, pos, tabs,
                                        fused=True)
        assert torch.equal(got, want)
    _equal_pools(pages, ref)
    assert _counts(m, "decode") == (0, 0)
    assert not m.graphs.graphs and not m.graphs.seen


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
def test_stub_graphs_capture_on_the_second_call_and_replay_bitwise(on_card,
                                                                   arch):
    m, params, pages = _model(arch)
    plain = build_model(m.cfg)
    sp = Spans()
    m.spans = sp
    ref = _pages_copy(pages)
    for step in range(4):
        toks, pos, tabs = _inputs(8, step)
        want, ref = plain._decode_forward(params, ref, toks, pos, tabs,
                                          fused=True)
        got, out = m.decode_paged(params, pages, toks, pos, tabs, fused=True)
        assert out is pages and torch.equal(got, want)
        # the caller's logits are a copy the next call does not overwrite
        g = m.graphs.graphs.get(("decode", 8, N_MAX, True))
        assert g is None or got.data_ptr() != g.out.data_ptr()
    _equal_pools(pages, ref)
    assert _counts(m, "decode") == (1, 3)
    dec = sp.select("model.decode")
    assert [sp.attrs[i]["graphed"] for i in dec] == [0, 1, 1, 1]
    # the eager call records spans inside its forward, the graphed calls
    # none (the recorder is detached while the stub captures and replays)
    inner = {sp.parent[i] for i in range(len(sp))
             if sp.name[i] == "model.lm_head"}
    assert dec[0] in inner and not inner & set(dec[1:])
    # the table's owner keeps the f32 head the graph reads
    owner = m.graphs.owner
    assert owner[0] is params and owner[1] is pages and owner[2] is m._head
    assert m._head[2] is m._head_f32(params["lm_head"])
    assert m._head[2].dtype == torch.float32


def test_stub_table_keys_by_shape_and_drops_on_new_params_pages_or_head(
        monkeypatch):
    def capture(graphs, forward, inputs):
        out = forward(*inputs)
        return StubGraph(lambda: torch.mul(inputs[0], 2, out=out)), out

    t = pg.PagedGraphs(capture=capture)
    head = torch.zeros(3)
    params, pages = {"lm_head": head}, {}
    # the model's lm_head record, as ``Model._paged_call`` puts in an owner
    heads = build_model(reduced_config("tinyllama-1.1b"))
    launches = pa.launches
    monkeypatch.setitem(launches, "fused_decode_attention", 0)

    def forward(x):             # an eager forward of five kernel launches
        launches["fused_decode_attention"] += 5
        return x * 2

    def step(key, x, params=params, pages=pages, head=head, table=t,
             forward=forward, inputs=None):
        """The call's mode, by the counts, and its output; the table's
        ``graphed`` said beforehand whether the call would take a graph."""
        owner = (params, pages, heads._head_state(head))
        graphed = table.graphed(key, owner)
        was = table.captures[key[0]], table.replays[key[0]]
        y = table.run(key, owner, forward, inputs or (x,))
        mode = ("capture" if table.captures[key[0]] > was[0] else
                "replay" if table.replays[key[0]] > was[1] else "eager")
        assert graphed == (mode != "eager")
        return mode, y

    a, b = ("decode", 8, 4, True), ("decode", 16, 4, True)
    x = torch.arange(4.0)
    assert [step(a, x)[0] for _ in range(3)] == \
        ["eager", "capture", "replay"]
    assert step(b, x)[0] == "eager" and step(a, x)[0] == "replay"
    # the replay reads the caller's input and hands out a copy
    before = launches["fused_decode_attention"]
    mode, y = step(a, x + 1)
    assert mode == "replay" and torch.equal(y, 2 * (x + 1))
    assert launches["fused_decode_attention"] == before + 5
    assert y.data_ptr() != t.graphs[a].out.data_ptr()
    # the capture's own launches were taken back: one forward, counted once
    before = launches["fused_decode_attention"]
    assert step(b, x)[0] == "capture"
    assert launches["fused_decode_attention"] == before + 5
    assert t.captures == {"decode": 2} and t.replays == {"decode": 5}
    assert set(t.graphs) == {a, b}
    # a prefill key of the same numbers is another graph, counted apart
    pre = ("prefill", 8, 4)
    assert [step(pre, x)[0] for _ in range(3)] == \
        ["eager", "capture", "replay"]
    assert t.captures == {"decode": 2, "prefill": 1}
    assert t.replays == {"decode": 5, "prefill": 2}
    assert step(a, x)[0] == "replay" and set(t.graphs) == {a, b, pre}
    # new params, new pages, another head or a head changed in place: every
    # graph of either kind and every key seen goes, and the call runs eager
    head2 = torch.zeros(3)
    for kw in ({"params": {"lm_head": head}}, {"pages": {}},
               {"head": head2}):
        new = dict(params=params, pages=pages, head=head)
        new.update(kw)
        assert step(a, x, **new)[0] == "eager"
        assert set(t.graphs) == set() and t.seen == {a}
        assert [step(a, x)[0] for _ in range(3)] == \
            ["eager", "capture", "replay"]
        assert [step(pre, x)[0] for _ in range(2)] == ["eager", "capture"]
    head.add_(1)
    assert step(pre, x)[0] == "eager" and not t.graphs
    assert t.owner[2][0] is head and t.owner[2][1] == head._version
    # a host int reaches the forward as a 0-d int64 tensor and fills its
    # 0-d buffer on a replay; a forward without output gives None
    box, got = {}, []

    def capture_none(graphs, forward, inputs):
        forward(*inputs)
        return StubGraph(lambda: box.update(n=int(inputs[1]))), None

    def no_output(x, n):
        got.append((n.dtype, n.shape, int(n)))

    t2 = pg.PagedGraphs(capture=capture_none)
    modes = [step(pre, x, table=t2, forward=no_output, inputs=(x, n))
             for n in (3, 5, 41)]
    assert modes == [("eager", None), ("capture", None), ("replay", None)]
    assert got == [(torch.int64, (), 3), (torch.int64, (), 5)]
    assert box["n"] == 41 and int(t2.graphs[pre].inputs[1]) == 41
    assert t2.captures == {"prefill": 1} and t2.replays == {"prefill": 2}


# -- prefill: a chunk's start and length on the device ---------------------
PF_PAGE, PF_NMAX, PF_POOL = 16, 16, 20   # 256 tokens a table; scrap page 19


def _chunk(step):
    """A 64-row chunk's tokens and a table of the pool's pages."""
    g = np.random.default_rng(100 + step)
    toks = torch.tensor(g.integers(0, 256, (1, 64)), dtype=torch.int32)
    tab = torch.tensor(g.permutation(PF_POOL - 1)[:PF_NMAX],
                       dtype=torch.int32)
    return toks, tab


def _written(a, b):
    """(page, slot) pairs where unit pools ``a`` and ``b`` differ."""
    out = set()
    for n, pool in a["units"].items():
        for k, t in pool.items():
            d = (t != b["units"][n][k]).flatten(3).any(-1).any(0)
            out |= {tuple(ix) for ix in d.nonzero().tolist()}
    return out


@pytest.mark.parametrize("start", [0, 64, 128])
def test_prefill_device_start_and_length_write_the_int_paths_pages(start):
    """``prefill_paged`` (its chunk start and length filled into 0-d
    tensors on the device) writes the pools the forward given host ints
    writes, bitwise: a full chunk at the slots it covers, and a chunk of 40
    real rows at those, its 24 padding rows at the scrap page's slot 0."""
    m, params, pages = _model(pool=PF_POOL, page=PF_PAGE)
    for n in (64, 40):
        toks, tab = _chunk(start + n)
        before = _pages_copy(pages)
        ref = m._prefill_forward(params, _pages_copy(pages), toks, start,
                                 tab, n)
        assert m.prefill_paged(params, pages, toks, start, tab, n) is pages
        _equal_pools(pages, ref)
        want = {(int(tab[p // PF_PAGE]), p % PF_PAGE)
                for p in range(start, start + n)}
        if n < 64:
            want.add((PF_POOL - 1, 0))
        assert _written(pages, before) == want


@pytest.mark.parametrize("case", ["cpu", "tp_ctx", "cost_counter"])
def test_eager_prefill_paths_write_the_int_paths_pages_and_count_nothing(
        case, request):
    """Three prefill calls of one shape, which would capture and replay
    if graphs engaged, write the int path's pools and take no graph."""
    ctx = NULL_CTX
    if case != "cpu":
        request.getfixturevalue("on_card")
    if case == "tp_ctx":
        ctx = AxisCtx(tp_attn_axis=Identity(), tp_mlp_axis=Identity(),
                      tp_vocab_axis=Identity())
    m, params, pages = _model(ctx=ctx, pool=PF_POOL, page=PF_PAGE)
    ref = _pages_copy(pages)
    for i, start in enumerate((0, 64, 128)):
        toks, tab = _chunk(0)
        ref = m._prefill_forward(params, ref, toks, start, tab, 64 - i)
        if case == "cost_counter":
            with CostCounter():
                m.prefill_paged(params, pages, toks, start, tab, 64 - i)
        else:
            m.prefill_paged(params, pages, toks, start, tab, 64 - i)
    _equal_pools(pages, ref)
    assert _counts(m, "prefill") == (0, 0)
    assert not m.graphs.graphs and not m.graphs.seen


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
def test_stub_prefill_graphs_capture_on_the_second_call_and_write_bitwise(
        on_card, arch):
    """A prompt's 64-row chunks: the first call eager, the second captured
    and replayed, the rest replayed, each writing the int path's pools
    bitwise; the prefill graph keyed apart from decode's, counted apart,
    and dropped with every other graph on new pages, a head changed in
    place or new params."""
    m, params, pages = _model(arch, pool=PF_POOL, page=PF_PAGE)
    plain = build_model(m.cfg)
    sp = Spans()
    m.spans = sp
    ref = _pages_copy(pages)
    key = ("prefill", 64, PF_NMAX)

    def chunks(pages, ref, steps, graphed):
        for step, (start, n) in enumerate(steps):
            toks, tab = _chunk(step)
            ref = plain._prefill_forward(params, ref, toks, start, tab, n)
            assert m.prefill_paged(params, pages, toks, start, tab,
                                   n) is pages
            _equal_pools(pages, ref)
        pre = sp.select("model.prefill")[-len(steps):]
        assert [sp.attrs[i]["graphed"] for i in pre] == graphed
        return pre, ref

    pre, ref = chunks(pages, ref, [(0, 64), (64, 64), (128, 64), (192, 8)],
                      [0, 1, 1, 1])
    assert _counts(m, "prefill") == (1, 3)
    assert _counts(m, "decode") == (0, 0)
    # the eager call records spans inside its forward, the capture none
    inner = {sp.parent[i] for i in range(len(sp))
             if sp.name[i] == "model.embed"}
    assert pre[0] in inner and pre[1] not in inner
    # the rope table the graph reads is never evicted from its cache
    assert _inv_freq.cache_parameters()["maxsize"] is None
    # a decode call of 64 lanes on the same table width is its own key
    toks, pos, _ = _inputs(64, 0)
    tabs = _chunk(0)[1][None].repeat(64, 1)
    for want in ([key], [key, ("decode", 64, PF_NMAX, True)]):
        _, pages = m.decode_paged(params, pages, toks, pos, tabs, fused=True)
        ref = _pages_copy(pages)
        assert list(m.graphs.graphs) == want
    assert _counts(m, "prefill") == (1, 3)
    # new pages, a head changed in place, new params: every graph goes and
    # the next call runs eager, then the shape captures again
    pages = _pages_copy(pages)
    pre, ref = chunks(pages, ref, [(0, 64), (64, 30)], [0, 1])
    params["lm_head"].add_(0)
    pre, ref = chunks(pages, ref, [(0, 64)], [0])
    assert list(m.graphs.graphs) == []
    params = dict(params)
    pre, ref = chunks(pages, ref, [(64, 64), (0, 64), (128, 64)], [0, 1, 1])
    assert _counts(m, "prefill") == (3, 6)


def _req(rid, prompt, out):
    return Request(rid=rid, app="chatbot", arrival=0.0, prompt_len=prompt,
                   true_output_len=out, slo=SLOSpec("throughput", ttlt=1e6))


def _served():
    be = PagedTorchBackend(page=16, device="cpu", num_blocks=8, max_len=64,
                           seed=0)
    be.model.graphs = pg.PagedGraphs(capture=stub_capture)
    reg = MetricsRegistry()
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=2, prefill_budget=16),
                      obs=reg)
    eng.load([_req(i + 1, 30, 10) for i in range(2)], [])
    fin = eng.run()
    assert len(fin) == 2
    return be, reg, {r.rid: list(be.generated[r.rid]) for r in fin}


def test_stub_graphs_serve_the_eager_streams_and_are_counted(monkeypatch):
    _, reg, eager = _served()
    assert reg.value_of("torch_decode_graph_replays_total") == 0
    assert reg.value_of("torch_prefill_graph_replays_total") == 0
    _on_card(monkeypatch)
    be, reg, graphed = _served()
    assert graphed == eager
    m = be.model
    captures, replays = _counts(m, "decode")
    assert captures == 1 and replays > 5
    assert reg.value_of("torch_decode_graph_captures_total") == 1
    assert reg.value_of("torch_decode_graph_replays_total") == replays
    # every prefill call of the run (one 64-row call a chunk) but the
    # first replays
    assert be.n_prefill_dispatches > 2
    assert _counts(m, "prefill") == (1, be.n_prefill_dispatches - 1)
    assert reg.value_of("torch_prefill_graph_captures_total") == 1
    assert reg.value_of("torch_prefill_graph_replays_total") == \
        be.n_prefill_dispatches - 1
    # new weights drop the graphs: the next call runs eager, then captures
    be.load_params(m.init(torch.Generator().manual_seed(1)))
    toks, pos, _ = (a.numpy() for a in _inputs(64, 0))
    tabs = np.full((64, be.n_max), be.scrap, np.int32)
    replays = m.graphs.replays["decode"]
    for _ in range(3):
        be.decode_logits(toks, pos, tabs)
    assert _counts(m, "decode") == (2, replays + 2)
