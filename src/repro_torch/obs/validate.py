"""CI validator for a ``--metrics-out`` directory (DESIGN.md §9), the
port's ``scripts/validate_obs.py``.

  PYTHONPATH=src python -m repro_torch.obs.validate DIR [DIR ...]

Checks, per directory:
  * ``metrics.prom`` parses under the strict dependency-free parser
    (``repro_torch.obs.export.parse_prometheus``) and carries at least one
    sample;
  * when per-tenant lifecycle counters are present
    (``engine_tenant_*_total{tenant=...}``), each tenant's counts are
    mutually consistent: finished + shed <= admitted and
    quota_shed <= shed;
  * ``trace.jsonl`` rows match the event schema (name/rid/t/replica, known
    event names, monotone non-negative timestamps per request);
  * every admitted request's chain reaches a terminal event (finish/shed)
    — no half-open lifecycle chains;
  * ``report.html`` (when present) is non-empty and contains the chart
    panels.

Exit code 0 = all directories valid.
"""

from __future__ import annotations

import json
import os
import sys

from repro_torch.obs import TERMINAL, parse_prometheus

EVENT_NAMES = {"admit", "prefix_match", "prefill_chunk", "defer", "resume",
               "preempt", "swap_in", "first_token", "finish", "shed",
               "handoff_out", "transfer", "handoff_in"}


def _fail(msg: str, failures: list) -> None:
    print(f"  FAIL: {msg}")
    failures.append(msg)


def _check_tenants(samples, failures: list) -> None:
    """Cross-check the per-tenant lifecycle counters (DESIGN.md §13).
    Counters are lazily registered, so a missing series just means zero."""
    by_tenant: dict = {}
    for name, labels, value in samples:
        if name.startswith("engine_tenant_") and "tenant" in labels:
            which = name[len("engine_tenant_"):-len("_total")]
            t = by_tenant.setdefault(labels["tenant"], {})
            t[which] = t.get(which, 0.0) + value
    if not by_tenant:
        return
    for tenant, c in sorted(by_tenant.items()):
        adm = c.get("admitted", 0.0)
        fin = c.get("finished", 0.0)
        shed = c.get("shed", 0.0)
        qshed = c.get("quota_shed", 0.0)
        if fin + shed > adm + 1e-9:
            _fail(f"tenant {tenant}: finished({fin:.0f}) + shed({shed:.0f})"
                  f" > admitted({adm:.0f})", failures)
        if qshed > shed + 1e-9:
            _fail(f"tenant {tenant}: quota_shed({qshed:.0f}) > "
                  f"shed({shed:.0f})", failures)
    print(f"  tenants: {len(by_tenant)} classes "
          f"({', '.join(sorted(by_tenant))}) consistent OK")


def validate_dir(d: str) -> list:
    failures: list = []
    print(f"[validate_obs] {d}")

    prom = os.path.join(d, "metrics.prom")
    if not os.path.exists(prom):
        _fail("metrics.prom missing", failures)
    else:
        try:
            with open(prom) as f:
                parsed = parse_prometheus(f.read())
            n = len(parsed["samples"])
            if n == 0:
                _fail("metrics.prom has no samples", failures)
            else:
                print(f"  metrics.prom: {n} samples, "
                      f"{len(parsed['types'])} metrics OK")
                _check_tenants(parsed["samples"], failures)
        except ValueError as e:
            _fail(f"metrics.prom unparseable: {e}", failures)

    tr = os.path.join(d, "trace.jsonl")
    if not os.path.exists(tr):
        _fail("trace.jsonl missing", failures)
        return failures
    admitted, terminal, last_t = set(), set(), {}
    mig = {}          # rid -> [n_handoff_out, n_transfer, n_handoff_in]
    n_events = 0
    with open(tr) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                _fail(f"trace.jsonl:{i + 1} not JSON", failures)
                continue
            n_events += 1
            for key in ("name", "rid", "t", "replica"):
                if key not in ev:
                    _fail(f"trace.jsonl:{i + 1} missing '{key}'", failures)
            name, rid, t = ev.get("name"), ev.get("rid"), ev.get("t", 0.0)
            if name not in EVENT_NAMES:
                _fail(f"trace.jsonl:{i + 1} unknown event {name!r}",
                      failures)
            if not isinstance(t, (int, float)) or t < 0:
                _fail(f"trace.jsonl:{i + 1} bad timestamp {t!r}", failures)
            elif t + 1e-9 < last_t.get(rid, 0.0):
                _fail(f"r{rid}: time went backwards at {name} "
                      f"({t} < {last_t[rid]})", failures)
            last_t[rid] = max(last_t.get(rid, 0.0), float(t))
            if name == "admit":
                admitted.add(rid)
            if name in TERMINAL:
                terminal.add(rid)
            if name in ("handoff_out", "transfer", "handoff_in"):
                c = mig.setdefault(rid, [0, 0, 0])
                c[("handoff_out", "transfer",
                   "handoff_in").index(name)] += 1
    # migration chains are complete: every handoff_out has exactly one
    # transfer dispatch and one handoff_in landing (a request may migrate
    # more than once over its life, but never half-migrate)
    for rid, (n_out, n_tx, n_in) in sorted(mig.items()):
        if not (n_out == n_tx == n_in):
            _fail(f"r{rid}: broken migration chain "
                  f"(handoff_out={n_out}, transfer={n_tx}, "
                  f"handoff_in={n_in})", failures)
    if mig:
        print(f"  migrations: {sum(c[0] for c in mig.values())} chains "
              f"over {len(mig)} requests OK")
    open_chains = admitted - terminal
    if open_chains:
        _fail(f"{len(open_chains)} admitted requests never reached a "
              f"terminal event, e.g. {sorted(open_chains)[:5]}", failures)
    print(f"  trace.jsonl: {n_events} events, {len(admitted)} chains, "
          f"{len(terminal)} terminal"
          + ("" if failures else " OK"))

    rep = os.path.join(d, "report.html")
    if os.path.exists(rep):
        with open(rep) as f:
            text = f.read()
        if "<svg" not in text or "</body>" not in text:
            _fail("report.html missing chart panels", failures)
        else:
            print(f"  report.html: {len(text)} chars OK")
    return failures


def main(argv=None) -> int:
    dirs = (argv if argv is not None else sys.argv[1:]) or []
    if not dirs:
        print(__doc__)
        return 2
    all_failures = []
    for d in dirs:
        all_failures += validate_dir(d)
    if all_failures:
        print(f"[validate_obs] {len(all_failures)} failure(s)")
        return 1
    print("[validate_obs] all OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
