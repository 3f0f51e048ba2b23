"""The check fails a broken timed path.  A tiny run on the CPU is driven
whole, with the program broken underneath at one place, and ``correct``
has to come out false: a decode step that leaves the KV pool (the
program's state) unchanged; half of each decode batch left out, its lanes
given another lane's logits; a token altered where the sampler produces
it.  The cell runs on one chip, so there is no exchange between chips to
leave out.  Without a fault the same run is correct."""

import json
from pathlib import Path

import pytest
import torch

from portbench import run as bench_run

DATA = Path(__file__).resolve().parent / "data"


def _serve(seed=2**31 + 3):
    from portbench import traffic

    cfg = json.loads((DATA / "tiny.json").read_text())
    t = traffic.load(DATA / "tiny_chat.json")
    run, _, _, finished = bench_run.serve_cell(
        cfg, t, {"name": "tiny.chat"}, [], seed, 5.0, False, "cpu")
    return bench_run.judge(run, finished, seed, "cpu")[:2]


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention

    orig = attention.fused_decode_attention

    def frozen(q, k_new, v_new, k_pages, v_pages, *a, **kw):
        kc, vc = k_pages.clone(), v_pages.clone()
        o, kp, vp = orig(q, k_new, v_new, k_pages, v_pages, *a, **kw)
        kp.copy_(kc)
        vp.copy_(vc)
        return o, kp, vp

    monkeypatch.setattr(attention, "fused_decode_attention", frozen)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model

    orig = Model.decode_paged

    def half(self, params, pages, tokens, positions, tables, **kw):
        logits, pages = orig(self, params, pages, tokens, positions, tables,
                             **kw)
        live = torch.nonzero(positions > 0)[:, 0]
        if live.numel() > 1:
            logits[live[live.numel() // 2:]] = logits[live[0]].clone()
        return logits, pages

    monkeypatch.setattr(Model, "decode_paged", half)


def _token_altered(monkeypatch):
    from repro_torch.serving.backend import Sampler

    orig = Sampler.sample_device

    def altered(self, logits, rids, poss):
        out = orig(self, logits, rids, poss)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(Sampler, "sample_device", altered)


def test_sound_run_is_correct():
    correct, checks = _serve()
    assert correct, checks


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    correct, checks = _serve()
    assert not correct, checks
    gap = checks["max_logit_gap"]
    assert gap["value"] > gap["limit"]
