#!/bin/bash
# Run chip_smoke.py of several checkouts one after another in one machine,
# so that two trees are compared on the same card, e.g. a change and its
# parent alternated:
#
#   mkdir -p build/ab/parent build/ab/change
#   git archive HEAD~1 | tar -x -C build/ab/parent
#   git archive HEAD | tar -x -C build/ab/change
#   chiprun --timeout 3500 -- bash chip_smoke_ab.sh build/ab/change build/ab/parent build/ab/change
#
# Each run's output goes to chiprun_out/ab<i>_<name of its directory>.log;
# each run is cut at 1150 s. Prints the card, the run codes and seconds,
# and the last two lines of each run.
out="$(pwd)/chiprun_out"
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
i=0
for tree in "$@"; do
  i=$((i + 1))
  name=$(basename "$tree")
  t0=$(date +%s)
  (cd "$tree" && timeout -k 10 1150 python3 chip_smoke.py > "$out/ab${i}_${name}.log" 2>&1)
  rc=$?
  echo "run $i $name rc=$rc seconds=$(( $(date +%s) - t0 ))"
  tail -n 2 "$out/ab${i}_${name}.log" | cut -c1-300
done
