#!/bin/bash
# Phase 14 of chip_smoke.py (the mesh path at world size 1: the sharded
# train step, then the prefill and decode builders) alone, in two unpacked
# trees in turns A, B, B, A, on one card.  Prints each run's phase 14 lines.
#
#   git archive <parent> | tar -x -C build/parent
#   git archive $(git write-tree) | tar -x -C build/change
#   bash tools/phase14_ab.sh build/parent build/change
set -u
a=$1 b=$2
for d in "$a" "$b" "$b" "$a"; do
  echo "=== $d"
  (cd "$d" && PYTHONPATH=src python3 -c "
import time
import chip_smoke as cs
t = time.perf_counter()
cs.sharded_train_phase('$d')
cs.free_device()
cs.sharded_serve_phase('$d')
print('[$d] phase 14 wall', time.perf_counter() - t)
" 2>&1 | grep -E "phase 14|Error|Traceback" | cut -c1-900)
done
