"""The control: the plain reference computed in float8 e4m3, the precision
below the configuration's bfloat16, put in the program's place, has to
come out not correct through the benchmark's own comparison where the
program comes out correct.  At the CPU tests' size; on the chip at each
cell's size with ``portbench/control.py``."""

import json
from pathlib import Path

from portbench import run as bench_run, traffic

DATA = Path(__file__).resolve().parent / "data"


def test_control_fails_where_the_program_passes():
    cfg = json.loads((DATA / "tiny.json").read_text())
    t = traffic.load(DATA / "tiny_chat.json")
    limit = cfg["check"]["max_logit_gap"]
    for seed in (11, 2**31 + 12, 13):
        run, _, _, finished = bench_run.serve_cell(
            cfg, t, {"name": "tiny.chat"}, [], seed, 5.0, False, "cpu")
        correct, checks, g = bench_run.judge(run, finished, seed, "cpu",
                                             control=True)
        assert not correct, checks
        assert checks["max_logit_gap"]["value"] == g["control"]
        assert g["program"] <= limit < g["control"], g
        ok, _, _ = bench_run.judge(run, finished, seed, "cpu")
        assert ok
