"""Static fleet telemetry report (DESIGN.md §9).

Renders one self-contained ``report.html`` (inline SVG, zero JS deps) from
a ``dump_all`` metrics directory (``metrics.json`` + ``summary.json``):

  * headline stats (goodput, gain fraction, deferrals, quanta, residuals);
  * goodput timeline — fleet SLO attainment when the autoscaler ran, else
    cumulative finished requests per replica;
  * per-tenant lifecycle (free/pro/enterprise): cumulative finished per
    class plus an admitted/finished/shed census table (tenant runs only);
  * margin-group census as a stacked area over quanta refreshes;
  * per-replica KV pressure;
  * TTFT / TPOT percentiles per SLO class (bucket-interpolated).

Charts follow the repo's chart conventions: fixed categorical hue order
(never cycled), one y-axis per chart, 2px lines, recessive grid, legends
for multi-series panels, a table view under every chart, and dark mode via
``prefers-color-scheme`` plus explicit ``data-theme`` scopes.

  PYTHONPATH=src python -m repro.launch.dashboard METRICS_DIR [--out F]
"""

from __future__ import annotations

import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

# categorical palette (fixed slot order) + neutral; see launch/dashboard
# CSS for the dark-mode steps of the same hues
_N_SLOTS = 5
_GROUP_ORDER = ("hopeless", "late", "critical", "ontrack", "slack", "ahead")
_GROUP_COLOR = {"hopeless": "var(--c1)", "late": "var(--c3)",
                "critical": "var(--c4)", "ontrack": "var(--c2)",
                "slack": "var(--c0)", "ahead": "var(--ink3)"}
_TENANT_ORDER = ("free", "pro", "enterprise")
_TENANT_COLOR = {"free": "var(--c0)", "pro": "var(--c2)",
                 "enterprise": "var(--c3)"}

_CSS = """
:root, [data-theme=light] {
  --surface:#fcfcfb; --ink:#0b0b0b; --ink2:#52514e; --ink3:#898781;
  --grid:#e1e0d9;
  --c0:#2a78d6; --c1:#eb6834; --c2:#1baf7a; --c3:#eda100; --c4:#e87ba4;
}
@media (prefers-color-scheme: dark) { :root {
  --surface:#1a1a19; --ink:#f2f1ee; --ink2:#b5b3ad; --ink3:#898781;
  --grid:#2c2c2a;
  --c0:#3987e5; --c1:#d95926; --c2:#199e70; --c3:#c98500; --c4:#d55181;
} }
[data-theme=dark] {
  --surface:#1a1a19; --ink:#f2f1ee; --ink2:#b5b3ad; --ink3:#898781;
  --grid:#2c2c2a;
  --c0:#3987e5; --c1:#d95926; --c2:#199e70; --c3:#c98500; --c4:#d55181;
}
body { background:var(--surface); color:var(--ink);
       font:14px/1.45 system-ui,sans-serif; margin:2rem auto;
       max-width:720px; padding:0 1rem; }
h1 { font-size:1.3rem; } h2 { font-size:1.05rem; margin-top:2rem; }
.hero { display:flex; flex-wrap:wrap; gap:1.5rem; margin:1rem 0; }
.hero div { min-width:7rem; }
.hero .v { font-size:1.5rem; font-weight:600; }
.hero .k { color:var(--ink2); font-size:.8rem; }
.legend { display:flex; flex-wrap:wrap; gap:1rem; margin:.3rem 0;
          color:var(--ink2); font-size:.8rem; }
.legend i { display:inline-block; width:10px; height:10px;
            border-radius:2px; margin-right:.35rem; }
svg { display:block; max-width:100%; }
svg text { fill:var(--ink2); font:11px system-ui,sans-serif; }
table { border-collapse:collapse; font-size:.8rem; margin:.5rem 0; }
td, th { border-bottom:1px solid var(--grid); padding:.2rem .6rem;
         text-align:right; color:var(--ink2); }
th { color:var(--ink); }
td:first-child, th:first-child { text-align:left; }
details summary { color:var(--ink3); font-size:.8rem; cursor:pointer; }
p.note { color:var(--ink3); font-size:.8rem; }
"""

_W, _H, _ML, _MB, _MT = 640, 200, 46, 22, 8


def _load_dir(metrics_dir: str) -> Tuple[Dict, Dict]:
    with open(os.path.join(metrics_dir, "metrics.json")) as f:
        snap = json.load(f)
    summary: Dict = {}
    spath = os.path.join(metrics_dir, "summary.json")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    return snap, summary


def _recs(snap: Dict, name: str) -> List[Dict]:
    return [r for r in snap.get("metrics", []) if r["name"] == name]


def _hist_pctl(buckets: Sequence[float], counts: Sequence[float],
               p: float) -> Optional[float]:
    """Bucket-CDF interpolated percentile (mirrors obs.metric.Histogram)."""
    total = sum(counts)
    if not total:
        return None
    target = total * p / 100.0
    cum = 0.0
    for i, c in enumerate(counts):
        prev, cum = cum, cum + c
        if cum >= target and c > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            return lo + (hi - lo) * (target - prev) / c
    return buckets[-1] if buckets else None


def _step_resample(series: List[List[float]],
                   grid: Sequence[float]) -> List[float]:
    """Step-hold (last value carried forward, 0 before first sample)."""
    out, j, cur = [], 0, 0.0
    for t in grid:
        while j < len(series) and series[j][0] <= t:
            cur = series[j][1]
            j += 1
        out.append(cur)
    return out


def _fmt(v: Optional[float], nd: int = 3) -> str:
    if v is None:
        return "–"
    return f"{v:.{nd}g}" if abs(v) < 1e4 else f"{v:.3e}"


# ---------------------------------------------------------------------------
# SVG builders
# ---------------------------------------------------------------------------
def _frame(y_max: float, t_max: float, y_fmt=lambda v: _fmt(v)) -> List[str]:
    el = [f'<svg viewBox="0 0 {_W} {_H}" role="img">']
    for i in range(5):
        y = _MT + (_H - _MT - _MB) * i / 4
        el.append(f'<line x1="{_ML}" y1="{y:.1f}" x2="{_W}" y2="{y:.1f}" '
                  'stroke="var(--grid)" stroke-width="1"/>')
        v = y_max * (1 - i / 4)
        el.append(f'<text x="{_ML - 6}" y="{y + 4:.1f}" '
                  f'text-anchor="end">{y_fmt(v)}</text>')
    el.append(f'<text x="{_ML}" y="{_H - 4}">0s</text>')
    el.append(f'<text x="{_W}" y="{_H - 4}" text-anchor="end">'
              f'{_fmt(t_max)}s</text>')
    return el


def _xy(t: float, v: float, t_max: float, y_max: float) -> Tuple[float, float]:
    x = _ML + (_W - _ML) * (t / max(t_max, 1e-9))
    y = _MT + (_H - _MT - _MB) * (1 - v / max(y_max, 1e-9))
    return x, y


def _line_chart(named: List[Tuple[str, str, List[List[float]]]],
                y_max: Optional[float] = None) -> str:
    """``named`` = [(label, css-color, [[t, v], ...]), ...]."""
    pts_all = [p for _, _, s in named for p in s]
    if not pts_all:
        return '<p class="note">no samples</p>'
    t_max = max(p[0] for p in pts_all) or 1.0
    y_max = y_max if y_max is not None else \
        (max(p[1] for p in pts_all) or 1.0)
    el = _frame(y_max, t_max)
    for label, color, s in named:
        coords = [_xy(t, v, t_max, y_max) for t, v in s]
        path = " ".join(f"{x:.1f},{y:.1f}" for x, y in coords)
        el.append(f'<polyline points="{path}" fill="none" stroke="{color}" '
                  'stroke-width="2"/>')
        step = max(len(coords) // 40, 1)    # hover targets, thinned
        for (x, y), (t, v) in list(zip(coords, s))[::step]:
            el.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="6" '
                      f'fill="transparent"><title>{html.escape(label)} '
                      f't={t:.2f}s: {_fmt(v)}</title></circle>')
    el.append("</svg>")
    return "".join(el)


def _stacked_area(order: Sequence[str], colors: Dict[str, str],
                  grid: Sequence[float],
                  values: Dict[str, List[float]]) -> str:
    tops = {g: values[g] for g in order if g in values}
    if not tops or not grid:
        return '<p class="note">no samples</p>'
    n = len(grid)
    totals = [sum(tops[g][i] for g in tops) for i in range(n)]
    y_max = max(totals) or 1.0
    t_max = max(grid) or 1.0
    el = _frame(y_max, t_max, y_fmt=lambda v: f"{v:.0f}")
    base = [0.0] * n
    for g in order:
        if g not in tops:
            continue
        upper = [base[i] + tops[g][i] for i in range(n)]
        up = [_xy(grid[i], upper[i], t_max, y_max) for i in range(n)]
        dn = [_xy(grid[i], base[i], t_max, y_max) for i in range(n - 1,
                                                                 -1, -1)]
        d = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in up + dn) + " Z"
        # 2px surface stroke = visual gap between stacked bands
        el.append(f'<path d="{d}" fill="{colors[g]}" fill-opacity="0.85" '
                  'stroke="var(--surface)" stroke-width="2">'
                  f'<title>{html.escape(g)}</title></path>')
        base = upper
    el.append("</svg>")
    return "".join(el)


def _legend(entries: List[Tuple[str, str]]) -> str:
    return ('<div class="legend">' + "".join(
        f'<span><i style="background:{c}"></i>{html.escape(l)}</span>'
        for l, c in entries) + "</div>")


def _table(headers: List[str], rows: List[List[str]],
           cap: int = 40) -> str:
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r)
        + "</tr>" for r in rows[:cap])
    note = (f'<p class="note">{len(rows) - cap} more rows omitted</p>'
            if len(rows) > cap else "")
    return ('<details><summary>table view</summary><table><tr>'
            + "".join(f"<th>{html.escape(h)}</th>" for h in headers)
            + f"</tr>{body}</table>{note}</details>")


# ---------------------------------------------------------------------------
def render_report(snap: Dict, summary: Optional[Dict] = None,
                  title: str = "Fleet telemetry") -> str:
    summary = summary or {}
    parts = [f"<h1>{html.escape(title)}</h1>"]

    hero = [("goodput", summary.get("goodput_frac"), "{:.3f}"),
            ("gain frac", summary.get("gain_frac"), "{:.3f}"),
            ("tok/s", summary.get("tok_s"), "{:.0f}"),
            ("deferrals", summary.get("deferrals"), "{:.0f}"),
            ("quanta", summary.get("quanta"), "{:.0f}"),
            ("resid p95 (s)", summary.get("resid_p95"), "{:.2g}")]
    cells = "".join(
        f'<div><div class="v">{fmt.format(float(v))}</div>'
        f'<div class="k">{html.escape(k)}</div></div>'
        for k, v, fmt in hero
        if isinstance(v, (int, float)) and not isinstance(v, bool))
    if cells:
        parts.append(f'<div class="hero">{cells}</div>')

    # -- goodput timeline ------------------------------------------------
    parts.append("<h2>Goodput timeline</h2>")
    att = [r for r in _recs(snap, "autoscaler_attainment") if r["series"]]
    if att:
        parts.append(_line_chart(
            [("attainment", "var(--c0)", att[0]["series"])], y_max=1.0))
        parts.append(_table(["t (s)", "attainment"],
                            [[f"{t:.2f}", f"{v:.3f}"]
                             for t, v in att[0]["series"]]))
    else:
        fin = [r for r in _recs(snap, "engine_finished_total")
               if r["series"]]
        named = []
        for i, r in enumerate(sorted(fin, key=lambda r: str(r["labels"]))):
            rid = r["labels"].get("replica", "0")
            slot = f"var(--c{i % _N_SLOTS})" if i < _N_SLOTS \
                else "var(--ink3)"
            named.append((f"r{rid} finished", slot, r["series"]))
        parts.append('<p class="note">cumulative finished requests '
                     '(attainment gauge absent: no autoscaler)</p>')
        parts.append(_line_chart(named))
        if len(named) > 1:
            parts.append(_legend([(l, c) for l, c, _ in named]))
        parts.append(_table(
            ["series", "t (s)", "finished"],
            [[l, f"{t:.2f}", f"{v:.0f}"]
             for l, _, s in named for t, v in s]))

    # -- per-tenant lifecycle -------------------------------------------
    tenant_counts: Dict[str, Dict[str, float]] = {}
    tenant_series: Dict[str, List[List[List[float]]]] = {}
    for which in ("admitted", "finished", "shed", "quota_shed"):
        for r in _recs(snap, f"engine_tenant_{which}_total"):
            tenant = r["labels"].get("tenant", "?")
            final = r["series"][-1][1] if r["series"] else 0.0
            c = tenant_counts.setdefault(tenant, {})
            c[which] = c.get(which, 0.0) + final
            if which == "finished" and r["series"]:
                tenant_series.setdefault(tenant, []).append(r["series"])
    if tenant_counts:
        parts.append("<h2>Per-tenant lifecycle</h2>")
        order = [t for t in _TENANT_ORDER if t in tenant_counts] \
            + sorted(set(tenant_counts) - set(_TENANT_ORDER))
        named = []
        for i, tenant in enumerate(order):
            if tenant not in tenant_series:
                continue
            grid = sorted({t for s in tenant_series[tenant] for t, _ in s})
            merged = [sum(col) for col in
                      zip(*(_step_resample(s, grid)
                            for s in tenant_series[tenant]))]
            color = _TENANT_COLOR.get(
                tenant, f"var(--c{i % _N_SLOTS})")
            named.append((f"{tenant} finished", color,
                          [[t, v] for t, v in zip(grid, merged)]))
        if named:
            parts.append(_line_chart(named))
            parts.append(_legend([(l, c) for l, c, _ in named]))
        parts.append(_table(
            ["tenant", "admitted", "finished", "shed", "quota shed",
             "finish frac"],
            [[t, f"{c.get('admitted', 0):.0f}", f"{c.get('finished', 0):.0f}",
              f"{c.get('shed', 0):.0f}", f"{c.get('quota_shed', 0):.0f}",
              _fmt(c.get("finished", 0.0) / c["admitted"], 3)
              if c.get("admitted") else "–"]
             for t, c in ((t, tenant_counts[t]) for t in order)]))

    # -- margin-group stacked area --------------------------------------
    parts.append("<h2>Margin-group census (per quanta refresh)</h2>")
    by_group: Dict[str, List[List[float]]] = {}
    for r in _recs(snap, "sched_group_size"):
        if r["series"]:
            by_group.setdefault(r["labels"].get("group", "?"),
                                []).append(r["series"])
    if by_group:
        grid = sorted({t for ss in by_group.values()
                       for s in ss for t, _ in s})
        values = {g: [sum(col) for col in
                      zip(*(_step_resample(s, grid) for s in ss))]
                  for g, ss in by_group.items()}
        order = [g for g in _GROUP_ORDER if g in values] \
            + sorted(set(values) - set(_GROUP_ORDER))
        colors = {g: _GROUP_COLOR.get(g, "var(--ink3)") for g in order}
        parts.append(_stacked_area(order, colors, grid, values))
        parts.append(_legend([(g, colors[g]) for g in order]))
        parts.append(_table(
            ["t (s)"] + order,
            [[f"{t:.2f}"] + [f"{values[g][i]:.0f}" for g in order]
             for i, t in enumerate(grid)]))
    else:
        parts.append('<p class="note">no sched_group_size samples '
                     '(scheduler is not gmg, or telemetry was off)</p>')

    # -- per-replica KV pressure ----------------------------------------
    parts.append("<h2>KV pressure per replica</h2>")
    kv = [r for r in _recs(snap, "engine_kv_used_frac") if r["series"]]
    named = []
    for i, r in enumerate(sorted(kv, key=lambda r: str(r["labels"]))):
        rid = r["labels"].get("replica", "0")
        slot = f"var(--c{i % _N_SLOTS})" if i < _N_SLOTS else "var(--ink3)"
        named.append((f"r{rid}", slot, r["series"]))
    parts.append(_line_chart(named, y_max=1.0))
    if len(named) > 1:
        parts.append(_legend([(l, c) for l, c, _ in named]))
    if named:
        parts.append(_table(
            ["replica", "t (s)", "kv used frac"],
            [[l, f"{t:.2f}", f"{v:.3f}"]
             for l, _, s in named for t, v in s]))

    # -- latency percentiles per SLO class ------------------------------
    parts.append("<h2>TTFT / TPOT percentiles per SLO class</h2>")
    rows = []
    for metric, unit in (("engine_ttft_seconds", "TTFT"),
                         ("engine_tpot_seconds", "TPOT")):
        merged: Dict[str, List] = {}
        for r in _recs(snap, metric):
            slo = r["labels"].get("slo", "?")
            if slo not in merged:
                merged[slo] = [list(r["buckets"]), list(r["counts"])]
            else:       # same bucket layout across replica views
                merged[slo][1] = [a + b for a, b in
                                  zip(merged[slo][1], r["counts"])]
        for slo in sorted(merged):
            b, c = merged[slo]
            if not sum(c):
                continue
            rows.append([f"{unit} {slo}", f"{sum(c):.0f}",
                         _fmt(_hist_pctl(b, c, 50)),
                         _fmt(_hist_pctl(b, c, 95))])
    if rows:
        parts.append("<table><tr><th>metric / class</th><th>n</th>"
                     "<th>p50 (s)</th><th>p95 (s)</th></tr>"
                     + "".join("<tr>" + "".join(
                         f"<td>{html.escape(c)}</td>" for c in r) + "</tr>"
                         for r in rows) + "</table>")
    else:
        parts.append('<p class="note">no latency histogram samples</p>')

    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>"
            f"<style>{_CSS}</style></head><body>"
            + "".join(parts) + "</body></html>")


def write_report(metrics_dir: str, out: Optional[str] = None,
                 title: Optional[str] = None) -> str:
    snap, summary = _load_dir(metrics_dir)
    out = out or os.path.join(metrics_dir, "report.html")
    name = title or f"Fleet telemetry — {summary.get('scheduler', '')}"
    with open(out, "w") as f:
        f.write(render_report(snap, summary, title=name))
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Render a static fleet telemetry report from a "
                    "--metrics-out directory")
    ap.add_argument("metrics_dir")
    ap.add_argument("--out", default=None,
                    help="output path (default METRICS_DIR/report.html)")
    args = ap.parse_args(argv)
    path = write_report(args.metrics_dir, out=args.out)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
