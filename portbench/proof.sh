# The measurements a cell's bounds are set from, on the card, in one call:
#
#   bash portbench/proof.sh <cell> <out dir> <seconds> "<traced seeds>" \
#       "<six set seeds>" "<control seeds, comma-separated>"
#
# A traced run, two sets of six runs on the same six seeds, the other
# traced runs, then portbench/control.py (the float8 control judged in the
# program's place, which has to come out not correct).  Every run's last
# line goes to <out dir>/runs.jsonl; the summary at the end gives each
# metric's median and spread (IQR over the median) per set.
cell=$1; out=$2; secs=$3; traced="$4"; sets="$5"; controls="$6"
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/gpu.txt"
one() {  # seed trace tag
  s=$(date +%s)
  python3 portbench/run.py --workload "$cell" --seed "$1" --seconds "$secs" \
    --trace "$2" > "$out/$3.$1.out" 2> "$out/$3.$1.err"
  rc=$?
  line=$(tail -n 1 "$out/$3.$1.out" | grep '^{' || echo null)
  echo "{\"tag\": \"$3\", \"seed\": $1, \"rc\": $rc, \"wall\": $(( $(date +%s) - s )), \"line\": $line}" >> "$out/runs.jsonl"
}
first=${traced%% *}; rest=${traced#* }
one "$first" 1 trace
for s in $sets; do one "$s" 0 setA; done
for s in $sets; do one "$s" 0 setB; done
for s in $rest; do one "$s" 1 trace; done
if [ -n "$controls" ]; then
  python3 portbench/control.py --workload "$cell" --seeds "$controls" \
    --seconds "$secs" --out "$out/control.jsonl" 2> "$out/control.err"
fi
python3 - "$out" <<'PY'
import json, os, statistics as st, sys
out = sys.argv[1]
rows = [json.loads(l) for l in open(out + "/runs.jsonl")]
for r in rows:
    L = r["line"] or {}
    print(r["tag"], r["seed"], "rc", r["rc"], "wall", r["wall"],
          "correct", L.get("correct"),
          {k: v["value"] for k, v in L.get("checks", {}).items()},
          {k: v["value"] for k, v in L.get("metrics", {}).items()})
for tag in ("setA", "setB"):
    vals = {}
    for r in rows:
        if r["tag"] == tag and r["line"]:
            for k, v in r["line"]["metrics"].items():
                vals.setdefault(k, []).append(v["value"])
            for k, v in r["line"]["window"].items():
                if v is not None:
                    vals.setdefault("window." + k, []).append(v)
    for k, v in vals.items():
        q = st.quantiles(v, n=4)
        print(tag, k, "median", st.median(v),
              "spread", (q[2] - q[0]) / st.median(v) if st.median(v) else 0)
if os.path.exists(out + "/control.jsonl"):
    for l in open(out + "/control.jsonl"):
        print(l.strip())
PY
