#!/usr/bin/env bash
# Full conformance sweep -> CONFORMANCE JSON + HTML report.
# The sqam family runs one point per process (XLA CPU JIT exhausts
# vm.max_map_count when many operating points compile in one process,
# docs/CONFORMANCE.md); everything else runs in one pass.
set -u
cd "$(dirname "$0")/.."
OUT="${1:-CONFORMANCE_r05.json}"
FRAMES="${2:-100}"
WORK=.conf_work
mkdir -p "$WORK"

# non-sqam families in one process
python tools/conformance.py --frames "$FRAMES" \
  --families material,band_limiting,low_pass,bitrate_switching,bandwidth_switching,plc,pc,ep_correctable,ep_non_correctable,ep_mode_switching,ep_combined,ep_combined_nc \
  --json "$WORK/rest.json" || true

# sqam: one point per process
N_POINTS=$(python - <<'EOF'
import sys; sys.path.insert(0, ".")
from tools.conformance import QUALITY_POINTS
print(len(QUALITY_POINTS))
EOF
)
for i in $(seq 0 $((N_POINTS - 1))); do
  LC3TPU_SQAM_IDX=$i python - "$WORK/sqam_$i.json" <<'EOF' || true
import json, sys, tempfile, os
from pathlib import Path
sys.path.insert(0, ".")
import jax
jax.config.update("jax_platforms", os.environ.get("LC3TPU_CONF_PLATFORM", "cpu"))
from audio_codec_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import tools.conformance as C
idx = int(os.environ["LC3TPU_SQAM_IDX"])
C.QUALITY_POINTS = [C.QUALITY_POINTS[idx]]
frames = int(os.environ.get("LC3TPU_CONF_FRAMES", "100"))
with tempfile.TemporaryDirectory() as td:
    env = C.Env(Path(td), frames)
    rows = C.fam_sqam(env)
Path(sys.argv[1]).write_text(json.dumps(rows))
print(rows[0]["point"], "PASS" if rows[0]["pass"] else "FAIL")
EOF
done

python - "$OUT" "$WORK" <<'EOF'
import json, sys
from pathlib import Path
out, work = sys.argv[1], Path(sys.argv[2])
results = {}
rest = work / "rest.json"
if rest.exists():
    results.update(json.loads(rest.read_text()))
sqam = []
for p in sorted(work.glob("sqam_*.json"),
                key=lambda p: int(p.stem.split("_")[1])):
    sqam.extend(json.loads(p.read_text()))
results = {"sqam": sqam, **results}
Path(out).write_text(json.dumps(results, indent=1))
n_all = sum(len(r) for r in results.values())
n_pass = sum(bool(x.get("pass")) for r in results.values() for x in r)
print(f"{out}: {n_pass}/{n_all} points pass across {len(results)} families")
EOF
python tools/report.py "$OUT" || true
