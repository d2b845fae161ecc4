#!/usr/bin/env bash
# Build the ETSI LC3plus reference codec (conformance oracle) into .oracle/.
#
# The ETSI sources (TS 103 634 V1.2.1, software V1.4.10) are copied from the
# read-only reference mount into the gitignored .oracle/ scratch area and
# compiled there. The resulting LC3plus executables are the *only* gold
# standard used by the test suite (see SURVEY.md §4); no reference code is
# ever imported into the framework itself.
set -euo pipefail
REPO="$(cd "$(dirname "$0")/.." && pwd)"
REF=${LC3_REF:-/root/reference/LC3plus_ETSI_src_v17171_20200723}
ORACLE="$REPO/.oracle"

if [[ ! -x "$ORACLE/src/floating_point/LC3plus" || ! -x "$ORACLE/src/fixed_point/LC3plus" ]]; then
  if [[ ! -d "$ORACLE/src" && ! -d "$REF/src" ]]; then
    # exit code 3 = oracle absent (tests/oracle.py skips on it)
    echo "no ETSI reference source at $REF (set LC3_REF) and no .oracle/ build" >&2
    exit 3
  fi
  mkdir -p "$ORACLE"
  [[ -d "$ORACLE/src" ]] || cp -r "$REF/src" "$ORACLE/src"
  [[ -d "$ORACLE/testvec" ]] || cp -r "$REF/testvec" "$ORACLE/testvec"
  make -C "$ORACLE/src/floating_point" -j"$(nproc)" OPTIM=2
  make -C "$ORACLE/src/fixed_point" -j"$(nproc)" OPTIM=2
fi
if [[ ! -x "$ORACLE/src/fixed_point/ccConvert" ]]; then
  # ccConvert as shipped requests PLC mode 0, which the fixed-point build
  # rejects (lc3.c:84-90 only accepts LC3_PLC_ADVANCED) -> it always exits
  # with "Invalid PLC method!". Patch the scratch copy to request mode 1.
  # Guarded: fail loudly if the anchor line drifts, skip if already patched.
  CC_SRC="$ORACLE/src/fixed_point/ccConvert.c"
  if ! grep -q 'arg->plcMeth      = 1;' "$CC_SRC"; then
    if ! grep -q 'arg->bitrate      = 0;' "$CC_SRC"; then
      echo "error: ccConvert.c patch anchor 'arg->bitrate      = 0;' not found" >&2
      exit 1
    fi
    sed -i 's/arg->bitrate      = 0;/arg->bitrate      = 0;\n    arg->plcMeth      = 1;/' "$CC_SRC"
  fi
  make -C "$ORACLE/src/fixed_point" ccConvert -j"$(nproc)" OPTIM=2
fi
echo "oracle ready: $ORACLE/src/{floating_point,fixed_point}/LC3plus"
