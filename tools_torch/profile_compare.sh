#!/bin/sh
# Profile a time step of two checkouts of the port on one card, in turns.
#
#     sh tools_torch/profile_compare.sh OTHER_CHECKOUT [OUT_DIR] [STEPS]
#
# Runs this checkout's tools_torch/profile_step.py on the package of
# OTHER_CHECKOUT (e.g. the parent commit, unpacked with
# `git archive <commit> | tar -x -C build/parent`) and on this checkout's
# alternately -- other, this, this, other -- for the full and the
# inner state layout, then this checkout's sbdf2 loop, and writes each run's
# JSON lines to OUT_DIR (default build/profile).  Two versions are only
# comparable within one such call: the card, its power limit and the host's
# load change from call to call.
set -eu
other=$1
out=${2:-build/profile}
steps=${3:-100}
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
for layout in auto inner; do
    n=0
    for tree in "$other" "$here" "$here" "$other"; do
        n=$((n + 1))
        if [ "$tree" = "$here" ]; then tag=this; else tag=other; fi
        python3 "$here/tools_torch/profile_step.py" --root "$tree" \
            --steps "$steps" --layout "$layout" \
            > "$out/${layout}_${n}_${tag}.jsonl"
        head -n 2 "$out/${layout}_${n}_${tag}.jsonl" | tail -n 1
    done
done
python3 "$here/tools_torch/profile_step.py" --steps "$steps" --scheme sbdf2 \
    > "$out/sbdf2_this.jsonl"
head -n 2 "$out/sbdf2_this.jsonl" | tail -n 1
