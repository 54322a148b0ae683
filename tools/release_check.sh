#!/bin/sh
# Release gate: fast suite + slow suite + multichip dryrun in one command,
# all on the CPU (the suites force the CPU backend).  Run before any bench
# milestone (README cadence):
#   sh tools/release_check.sh 2>&1 | tee release_check.log
set -e
cd "$(dirname "$0")/.."

echo "== fast suite =="
python -m pytest tests/ -q

echo "== slow suite (production unrolls, multi-minute XLA:CPU compiles) =="
python -m pytest tests/ -q -m slow

echo "== multichip dryrun (8 virtual devices) =="
JAX_PLATFORMS=cpu python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)
print('dryrun_multichip(8) ok')
"

echo "== release check: ALL GREEN =="
