"""Exporters for the telemetry subsystem (DESIGN.md §9).

- :func:`to_prometheus` — Prometheus text exposition (v0.0.4) of a
  registry: ``# HELP`` / ``# TYPE`` headers, escaped label values,
  histogram ``_bucket``/``_sum``/``_count`` series with cumulative ``le``
  buckets.
- :func:`parse_prometheus` — the tiny dependency-free parser the CI
  smoke-obs lane and tests use to validate the exposition round-trips;
  deliberately strict about the subset this module emits.
- :func:`dump_all` — one-call flush of everything a run produced
  (Prometheus snapshot, JSON metrics snapshot with ring series, trace
  JSONL, Chrome trace) into a ``--metrics-out`` directory.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _san_name(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _san_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(items) -> str:
    if not items:
        return ""
    body = ",".join(f'{_san_name(k)}="{_san_label_value(v)}"'
                    for k, v in items)
    return "{" + body + "}"


def _fmt_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def to_prometheus(registry) -> str:
    """Render every instrument in ``registry`` to text exposition.
    Instruments sharing a name emit under one HELP/TYPE header."""
    lines: List[str] = []
    seen_header = set()
    for m in registry.instruments():
        name = _san_name(m.name)
        if name not in seen_header:
            seen_header.add(name)
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
        if m.kind == "counter":
            lines.append(f"{name}{_fmt_labels(m.labels)} "
                         f"{_fmt_num(m.total)}")
        elif m.kind == "gauge":
            lines.append(f"{name}{_fmt_labels(m.labels)} "
                         f"{_fmt_num(m.value)}")
        elif m.kind == "histogram":
            cum = 0
            for ub, c in zip(m.buckets, m.counts):
                cum += c
                items = m.labels + (("le", _fmt_num(ub)),)
                lines.append(f"{name}_bucket{_fmt_labels(items)} {cum}")
            cum += m.counts[-1]
            items = m.labels + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_fmt_labels(items)} {cum}")
            lines.append(f"{name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_num(m.sum)}")
            lines.append(f"{name}_count{_fmt_labels(m.labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>\S+)\s*$')
_LABEL = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict:
    """Parse the subset of text exposition :func:`to_prometheus` emits.

    Returns ``{"types": {name: kind}, "help": {name: str},
    "samples": [(name, labels_dict, value)]}``.  Raises ``ValueError``
    on any line that is neither a comment, blank, nor a valid sample —
    this strictness is the point (CI uses it as a format gate).
    """
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4:
                raise ValueError(f"line {ln}: malformed TYPE: {raw!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ValueError(f"line {ln}: malformed HELP: {raw!r}")
            helps[parts[2]] = parts[3] if len(parts) == 4 else ""
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample: {raw!r}")
        labels: Dict[str, str] = {}
        lbody = m.group("labels")
        if lbody is not None:
            consumed = 0
            for lm in _LABEL.finditer(lbody):
                labels[lm.group("k")] = (lm.group("v")
                                         .replace('\\"', '"')
                                         .replace("\\n", "\n")
                                         .replace("\\\\", "\\"))
                consumed += len(lm.group(0))
            residue = re.sub(_LABEL, "", lbody).replace(",", "").strip()
            if residue:
                raise ValueError(
                    f"line {ln}: malformed labels {lbody!r}")
        vraw = m.group("value")
        try:
            value = float(vraw.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"line {ln}: bad value {vraw!r}")
        base = m.group("name")
        for suff in ("_bucket", "_sum", "_count"):
            if base.endswith(suff) and base[:-len(suff)] in types:
                base = base[:-len(suff)]
                break
        if base not in types:
            raise ValueError(
                f"line {ln}: sample {m.group('name')!r} has no TYPE header")
        samples.append((m.group("name"), labels, value))
    return {"types": types, "help": helps, "samples": samples}


def dump_all(out_dir: str, registry=None, tracer=None,
             extra: Optional[Dict] = None) -> List[str]:
    """Flush registry + tracer into ``out_dir``; returns written paths.

    Files: ``metrics.prom`` (text exposition), ``metrics.json`` (full
    snapshot incl. ring series), ``trace.jsonl``, ``trace_chrome.json``,
    plus ``summary.json`` when ``extra`` is given.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []

    def _w(fname: str, text: str) -> None:
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(text)
        written.append(path)

    if registry is not None:
        _w("metrics.prom", to_prometheus(registry))
        _w("metrics.json", json.dumps(registry.snapshot(), indent=1))
    if tracer is not None:
        _w("trace.jsonl", tracer.to_jsonl())
        _w("trace_chrome.json", json.dumps(tracer.to_chrome()))
    if extra is not None:
        _w("summary.json", json.dumps(extra, indent=1, default=str))
    return written
