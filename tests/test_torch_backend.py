"""PagedTorchBackend on the CPU behind the ONE ServeEngine run loop: ports
of the JAX package's backend tests (swap round-trip, batch-composition
independence, oversized-request rejection, multi-step decode, prefix-cache
on/off), and one cross-framework check: the same workload through
PagedJaxBackend and PagedTorchBackend with the same weights gives the same
token streams at temperature 0."""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.core.service import ServiceModel  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.metrics import summarize  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.run import (BackendSpec,  # noqa: E402
                                     ExperimentSpec, run)
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402
from repro_torch.serving.workload import WorkloadGen, WorkloadSpec  # noqa: E402


def _backend(**kw):
    kw.setdefault("seed", 0)
    return PagedTorchBackend(page=16, device="cpu", **kw)


def _mk_reqs(n=2, prompt=30, out=10, kind="throughput"):
    return [Request(rid=i + 1, app="chatbot", arrival=0.0,
                    prompt_len=prompt, true_output_len=out,
                    slo=SLOSpec(kind, ttlt=1e6))
            for i in range(n)]


def _streams(be, fin):
    return {r.rid: list(be.generated[r.rid]) for r in fin}


def _run_tempo(num_blocks=4, decode_steps=1):
    """2 requests x (30 prompt + 10 out) on a 4-block x 16-token pool: both
    cross a page boundary with the pool exhausted, forcing an eviction;
    prefill_budget=16 forces chunked prefill."""
    be = _backend(num_blocks=num_blocks, max_len=64)
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=2, prefill_budget=16,
                                   decode_steps=decode_steps))
    eng.load(_mk_reqs(), [])
    fin = eng.run()
    assert len(fin) == 2
    return eng, be, fin


def test_engine_tempo_chunked_prefill_eviction_goodput():
    eng, be, fin = _run_tempo()
    assert all(r.decoded == r.true_output_len for r in fin)
    assert eng.swap_bytes > 0                      # >=1 eviction happened
    assert all(len(be.generated[r.rid]) == r.true_output_len for r in fin)
    assert summarize("tempo@torch", fin, ServiceModel(),
                     eng.now).goodput_frac > 0


def test_swap_roundtrip_preserves_texts():
    """Texts under a tiny pool (evictions + host round-trips) equal texts
    under a big pool (no evictions): swap restores KV exactly."""
    _, be_s, fin_s = _run_tempo(num_blocks=4)
    _, be_b, fin_b = _run_tempo(num_blocks=32)
    assert _streams(be_s, fin_s) == _streams(be_b, fin_b)


def test_engine_decode_steps_swap_across_window():
    """Evictions interleave with multi-step windows; streams equal the
    single-step run."""
    eng1, be1, fin1 = _run_tempo(decode_steps=1)
    assert eng1.swap_bytes > 0
    _, be4, fin4 = _run_tempo(decode_steps=4)
    assert _streams(be4, fin4) == _streams(be1, fin1)


def test_texts_independent_of_batch_composition():
    """Different schedulers batch requests differently; streams must not
    change (greedy: the port samples at temperature 0 only)."""
    texts = {}
    for name in ("vllm", "tempo"):
        be = _backend(num_blocks=16, max_len=64)
        sched = make_scheduler(name, use_predictor=False) \
            if name == "tempo" else make_scheduler(name)
        eng = ServeEngine(be, sched, EngineConfig(max_batch=2,
                                                  prefill_budget=16))
        eng.load(_mk_reqs(n=3, prompt=20, out=8), [])
        fin = eng.run()
        assert len(fin) == 3
        texts[name] = _streams(be, fin)
    assert texts["vllm"] == texts["tempo"]


def test_backend_rejects_oversized_request():
    be = _backend(num_blocks=8, max_len=32)
    eng = ServeEngine(be, make_scheduler("sarathi"),
                      EngineConfig(max_batch=2, prefill_budget=64))
    eng.load(_mk_reqs(n=1, prompt=30, out=10), [])
    with pytest.raises(ValueError, match="max_len"):
        eng.run()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="temperature"):
        _backend(temperature=0.8)
    with pytest.raises(NotImplementedError, match="tensor parallel"):
        _backend(tp=2)
    with pytest.raises(ValueError, match="jax"):
        run(ExperimentSpec(backend=BackendSpec(kind="jax")))
    with pytest.raises(ValueError, match="cluster"):
        run(ExperimentSpec(cluster=object()))


# ---------------------------------------------------------------------------
# multi-step decode
# ---------------------------------------------------------------------------
def test_multi_step_mid_scan_finish_matches_single_step():
    """Lanes with unequal remaining output retire inside the window: their
    tokens stop, their KV goes to the scrap page, and the surviving lane's
    stream equals the single-step reference."""
    def fresh():
        be = _backend(num_blocks=16, max_len=64)
        r1 = _mk_reqs(n=1, prompt=8, out=2)[0]
        r2 = _mk_reqs(n=2, prompt=8, out=6)[1]
        be.prefill_chunk(r1, 0, 8, [0])
        be.prefill_chunk(r2, 0, 8, [1])
        return be, r1, r2

    be, r1, r2 = fresh()
    toks, act = be.decode_batch_n([r1, r2], [[0], [1]], 4)
    assert toks.shape == (2, 4) and act.shape == (2, 4)
    assert act.tolist() == [[True, True, False, False],
                            [True, True, True, True]]
    assert len(be.generated[1]) == 2 and len(be.generated[2]) == 4

    be2, s1, s2 = fresh()
    for _ in range(2):
        be2.decode_batch([s1, s2], [[0], [1]])
        s1.decoded += 1
        s2.decoded += 1
    for _ in range(2):
        be2.decode_batch([s2], [[1]])
        s2.decoded += 1
    assert be.generated == be2.generated


def _run_engine(decode_steps, fused=True):
    be = _backend(num_blocks=16, max_len=64, fused=fused)
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=4, prefill_budget=32,
                                   decode_steps=decode_steps))
    eng.load(_mk_reqs(n=3, prompt=20, out=10), [])
    fin = eng.run()
    assert len(fin) == 3
    return eng, be, _streams(be, fin)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_engine_decode_steps_byte_identical_greedy(n):
    eng1, be1, ref = _run_engine(1)
    engn, be, got = _run_engine(n)
    assert got == ref, f"decode_steps={n} changed the streams"
    assert any(k[0] == "decode" and k[2] > 1 for k in be._shapes)
    assert be.n_decode_dispatches < be1.n_decode_dispatches
    assert be.n_decode_tokens == be1.n_decode_tokens
    assert engn.step == eng1.step     # micro-steps counted 1:1


def test_backend_fused_flag_streams_identical():
    _, _, fused = _run_engine(1, fused=True)
    _, _, unfused = _run_engine(1, fused=False)
    assert fused == unfused


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------
def _run_multiturn(prefix_cache):
    spec = WorkloadSpec(scenario="multiturn", rate=0.5, duration=8.0,
                        seed=0, turns=(2, 3), think_time=40.0,
                        system_prompt_len=8, shared_system_frac=1.0,
                        prompt_cap=8, output_cap=4, slo_scale=50.0)
    gen = WorkloadGen(spec)
    be = _backend(num_blocks=64, max_len=128)
    eng = ServeEngine(be, make_scheduler("sarathi"),
                      EngineConfig(max_batch=4, prefill_budget=32,
                                   prefix_cache=prefix_cache),
                      workload=gen)
    singles, dags = gen.generate()
    eng.load(singles, dags)
    return eng, be, eng.run()


def test_prefix_cache_token_streams_identical_on_vs_off():
    """Adopted donor pages and COW-forked tails decode the exact streams
    the cache-off run computes from scratch."""
    eon, bon, fon = _run_multiturn(True)
    eoff, boff, foff = _run_multiturn(False)
    assert {r.rid for r in fon} == {r.rid for r in foff}
    assert _streams(bon, fon) == _streams(boff, foff)
    assert eon.prefix_hits > 0
    assert eon.cow_forks > 0
    assert eon.prefill_computed < eoff.prefill_computed
    assert eoff.prefix_hits == 0
    eon.kv.check_invariants()


# ---------------------------------------------------------------------------
# cross-framework: PagedJaxBackend vs PagedTorchBackend, same weights
# ---------------------------------------------------------------------------
def _digest(be) -> str:
    streams = sorted((rid, tuple(t)) for rid, t in be.generated.items())
    return hashlib.sha256(repr(streams).encode()).hexdigest()[:16]


def _four_requests(Request, SLOSpec):
    """Staggered arrivals, mixed SLO kinds, prompts crossing page edges."""
    spec = [(0.00, 20, 8, "latency"), (0.02, 12, 5, "throughput"),
            (0.04, 30, 6, "throughput"), (0.06, 9, 7, "latency")]
    reqs = []
    for i, (t, prompt, out, kind) in enumerate(spec):
        slo = SLOSpec(kind, ttft=5.0, tbt=1.0, ttlt=60.0)
        reqs.append(Request(rid=i + 1, app="chatbot", arrival=t,
                            prompt_len=prompt, true_output_len=out, slo=slo))
    return reqs


@pytest.mark.parametrize("scheduler", ["vllm", "gmg"])
def test_stream_digest_matches_jax_backend(scheduler):
    from repro.core.baselines import make_scheduler as j_make_scheduler
    from repro.serving.engine import (EngineConfig as JEngineConfig,
                                      ServeEngine as JServeEngine)
    from repro.serving.jax_backend import PagedJaxBackend
    from repro.serving.request import Request as JRequest, SLOSpec as JSLO

    kw = dict(use_predictor=False) if scheduler == "gmg" else {}
    geo = dict(num_blocks=32, page=16, max_len=64, seed=0)
    bj = PagedJaxBackend(**geo)
    ej = JServeEngine(bj, j_make_scheduler(scheduler, **kw),
                      JEngineConfig(max_batch=4, prefill_budget=16))
    ej.load(_four_requests(JRequest, JSLO), [])
    fj = ej.run()
    bt = PagedTorchBackend(device="cpu", **geo)
    bt.params = params_from_numpy(jax.tree.map(np.asarray, bj.params), "cpu")
    et = ServeEngine(bt, make_scheduler(scheduler, **kw),
                     EngineConfig(max_batch=4, prefill_budget=16))
    et.load(_four_requests(Request, SLOSpec), [])
    ft = et.run()
    assert len(ft) == len(fj) == 4
    assert sum(len(t) for t in bt.generated.values()) == 8 + 5 + 6 + 7
    assert _digest(bt) == _digest(bj)
