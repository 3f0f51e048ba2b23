"""The traffic generator: the same seed gives the same inputs, every seed
the same work (only the prompt ids differ), a closed loop's clients, and
``extends`` reads its base file."""

import json
from collections import Counter

import numpy as np

from portbench import traffic

ROOT = traffic.Path(traffic.__file__).resolve().parent


def _chat():
    return traffic.load(ROOT / "traffic" / "chat.json")


def _key(s):
    return (s.kind, s.prompt_len, s.output_len, round(s.ttft, 9),
            round(s.ttlt, 9))


def test_same_seed_same_inputs():
    t = _chat()
    a, a0, a1 = traffic.generate(t, 2**31 + 11, 30.0, 131072)
    b, b0, b1 = traffic.generate(t, 2**31 + 11, 30.0, 131072)
    assert (a0, a1) == (b0, b1)
    assert [(s.index, s.due) for s in a] == [(s.index, s.due) for s in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_seeds_serve_the_same_work_in_another_order():
    # the same requests at the same due times for every seed; the seed
    # draws the prompt ids alone
    t = _chat()
    a, a0, a1 = traffic.generate(t, 3, 30.0, 131072)
    b, b0, b1 = traffic.generate(t, 2**31 + 5, 30.0, 131072)
    assert (a0, a1) == (b0, b1) == (t["preroll_s"], t["preroll_s"] + 30.0)
    assert [(_key(s), s.due) for s in a] == [(_key(s), s.due) for s in b]
    assert all(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a, b) if x.prompt_len > 8)
    # arrivals run on past the window's end, for a traced run's profile
    assert a[-1].due >= a1 + traffic.TAIL_S > a[-2].due


def test_closed_loop_clients():
    t = dict(_chat(), arrival="closed", clients=8)
    specs, start, end = traffic.generate(t, 5, 20.0, 1000)
    assert [s.due for s in specs[:8]] == [0.0] * 8
    assert all(s.due is None for s in specs[8:])
    assert len(specs) == 8 + 8 * int(end + traffic.TAIL_S)
    again, _, _ = traffic.generate(t, 5, 20.0, 1000)
    assert [_key(s) for s in specs] == [_key(s) for s in again]


def test_lengths_caps_and_mix():
    t = _chat()
    specs, _, _ = traffic.generate(t, 7, 50.0, 1000)
    assert all(4 <= s.prompt_len <= 1024 and 8 <= s.output_len <= 1024
               for s in specs)
    assert all(s.prompt.max() < 1000 and len(s.prompt) == s.prompt_len
               for s in specs)
    kinds = Counter(s.kind for s in specs)
    assert kinds["latency"] > 2 * kinds["throughput"] > 0
    assert all(s.due < t["preroll_s"] + 50.0 + traffic.TAIL_S + 5
               for s in specs)


def test_extends_and_warmup(tmp_path):
    (tmp_path / "base.json").write_text(json.dumps(
        dict(_chat(), why="base", rate=1.5)))
    (tmp_path / "child.json").write_text(json.dumps(
        {"extends": "base", "rate": 4.0, "arrival": "bursty"}))
    t = traffic.load(tmp_path / "child.json")
    assert t["rate"] == 4.0 and t["arrival"] == "bursty"
    assert t["prompt"] == _chat()["prompt"] and "why" not in t
    w = traffic.warmup(t, 12)
    assert [s.kind for s in w[:2]] == ["latency", "throughput"]
    assert [_key(s) for s in w] == [_key(s) for s in traffic.warmup(t, 12)]
