#!/bin/bash
# Time edited copies of a kernel source side by side on one GPU, each
# against the checkout's own, with chip_smoke.py --only (one card):
#
#   scripts/chip_variants.sh TAG FILE NAME:SED_EXPR [NAME:SED_EXPR ...]
#
# FILE is a source under src/repro_torch/csrc (e.g. ssd_scan.cu); each
# NAME gets a copy of src/ under build/variants/NAME with SED_EXPR applied
# to that file.  Runs the checkout, then each variant, then the checkout
# again; PHASES (default: ssd) picks chip_smoke.py's phases.  Logs go to
# OUT/TAG_NAME.log (OUT defaults to build/variants), a summary of each
# case to standard output.
set -u
cd "$(dirname "$0")/.."
TAG=$1 FILE=$2; shift 2
OUT=${OUT:-build/variants}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # NAME ROOT
  timeout 300 python3 chip_smoke.py --only "${PHASES:-ssd}" --src "$2" > "$OUT/${TAG}_$1.log" 2>&1
  echo "== $1 rc=$?"
  python3 - "$OUT/${TAG}_$1.log" <<'PY'
import json, sys
for line in open(sys.argv[1]):
    if line.startswith("case: "):
        r = json.loads(line[6:])
        print(f"  {r['ms'] * 1e3:9.3f} us  err {r['max_abs_err']:.3g}  ok {r['ok']}  "
              f"{r.get('route', '')} {r['kernel']} {r['case']}")
    elif line.startswith("profile prefill") or "Error" in line:
        print("  " + line.rstrip()[:200])
PY
}
run base .
for spec in "$@"; do
  name=${spec%%:*}
  d=build/variants/$name
  rm -rf "$d"; mkdir -p "$d"; cp -r src "$d/src"
  sed -i "${spec#*:}" "$d/src/repro_torch/csrc/$FILE"
  cmp -s "src/repro_torch/csrc/$FILE" "$d/src/repro_torch/csrc/$FILE" && echo "== $name: the edit changed nothing"
  run "$name" "$d"
done
run base2 .
