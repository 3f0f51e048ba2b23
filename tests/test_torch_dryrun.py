"""The port's dry run (``repro_torch.launch.dryrun``, a ``meta`` pass)
against the reference's (``repro.launch.dryrun.run_cell``, an XLA compile).

The reference runs in a subprocess with 512 host devices; its production
mesh is built there with Auto axes (under jax 0.9 ``jax.make_mesh``
defaults to Explicit axes, which the reference's sharding constraints
refuse: ``tests/test_integration.py::test_dryrun_single_cell_production_mesh``
fails for that reason alone).  The JAX package is not changed: its mesh
function is replaced inside the subprocess.

Per cell: status, chips, ``argument_size_in_bytes`` and ``model_flops``
equal; output and alias bytes within 1%; ``hlo_flops_per_chip`` between
``model_flops / chips`` and 1.05 x the reference's (which also counts work
it replicates); collective bytes > 0.  Over all 40 cells the
``skip(full-attn)`` set equals the reference's."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import (all_cells as j_all_cells,  # noqa: E402
                                  applicable as j_applicable,
                                  get_shape as j_get_shape)

from repro_torch.configs.shapes import all_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.report import table  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [("tinyllama-1.1b", "decode_32k", False),
         ("tinyllama-1.1b", "train_4k", False),
         ("deepseek-v2-lite-16b", "prefill_32k", False),
         ("jamba-v0.1-52b", "long_500k", False),
         ("tinyllama-1.1b", "decode_32k", True)]

_REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import AxisType
    import repro.launch.mesh as m

    def make_production_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    m.make_production_mesh = make_production_mesh
    from repro.launch.dryrun import run_cell
    recs = [run_cell(a, s, multi_pod=mp) for a, s, mp in
            json.loads(sys.argv[1])]
    print("RECS" + json.dumps(recs, default=str))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(CELLS)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = json.loads(r.stdout.split("RECS", 1)[1])
    return {(c[0], c[1], c[2]): rec for c, rec in zip(CELLS, recs)}


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_against_the_reference(arch, shape, multi_pod, reference):
    ref = reference[arch, shape, multi_pod]
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
    for key in ("status", "chips", "argument_size_in_bytes", "model_flops"):
        assert rec[key] == ref[key], key
    for key in ("output_size_in_bytes", "alias_size_in_bytes"):
        assert abs(rec[key] - ref[key]) <= 0.01 * ref[key], (
            key, rec[key], ref[key])
    chips = rec["chips"]
    assert rec["model_flops"] / chips <= rec["hlo_flops_per_chip"] \
        <= 1.05 * ref["hlo_flops_per_chip"], (
        rec["hlo_flops_per_chip"], ref["hlo_flops_per_chip"])
    assert rec["coll_bytes_per_chip"] > 0
    assert rec["temp_is_estimate"] and rec["temp_size_in_bytes"] > 0
    assert rec["per_device_bytes"] >= rec["argument_size_in_bytes"]
    print(f"{arch} {shape}{' mp' if multi_pod else ''}: flops/chip "
          f"{rec['hlo_flops_per_chip']:.4g} (reference "
          f"{ref['hlo_flops_per_chip']:.4g}), coll {rec['coll_by_kind']} "
          f"(reference {ref['coll_by_kind']}), temp "
          f"{rec['temp_size_in_bytes']} (reference "
          f"{ref['temp_size_in_bytes']})")


def test_skip_set_equals_the_reference():
    mine = {(a, s) for a, s, ok in all_cells() if not ok}
    theirs = {(a, s) for a, s, ok in j_all_cells() if not ok}
    assert len(list(all_cells())) == 40 and mine == theirs and mine
    for arch, shape in sorted(mine):
        assert not j_applicable(j_get_config(arch), j_get_shape(shape))
        assert dryrun.run_cell(arch, shape)["status"] == "skip(full-attn)"


def test_report_renders_port_records(tmp_path):
    """``launch.report`` (a verbatim copy) renders the port's records as
    they are, skips included."""
    recs = [dryrun.run_cell("tinyllama-1.1b", "decode_32k"),
            dryrun.run_cell("tinyllama-1.1b", "long_500k")]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    from repro_torch.launch.report import load_records
    out = table(load_records(str(tmp_path)), multi_pod=False)
    assert "skip(full-attn)" in out and "decode_32k" in out
    assert "ok" in out


def test_dryrun_cli_writes_its_record(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "minicpm3-4b", "--shape", "decode_32k",
                        "--decode-tp", "--out", str(out)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["decode_tp"]
    assert rec["coll_by_kind"].get("all-reduce", 0) > 0   # decode-TP psums
