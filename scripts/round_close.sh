#!/usr/bin/env bash
# Round-close gate: the committed tree must be green.
#
# Run this BEFORE the final commit of a round.  It runs the FULL test
# suite (not a subset — rounds 3 and 4 both shipped red because a
# mid-round behavior change stranded an older test that a partial run
# never touched), then the driver entry dryrun.
#
# Usage: bash scripts/round_close.sh
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== full test suite (faked 8-device CPU mesh, 4 xdist workers) =="
timeout 3600 python -m pytest tests/ -q -n 4

echo "== driver entry (dryrun + single-chip compile check) =="
timeout 1200 python __graft_entry__.py

echo "ROUND CLOSE: green"
