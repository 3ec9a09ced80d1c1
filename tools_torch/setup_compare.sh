#!/bin/sh
# The block-Schur device setup's seconds of two checkouts on one card, in
# turns (other, this, this, other):
#
#     sh tools_torch/setup_compare.sh OTHER_CHECKOUT [LEVELS]
#
# (OTHER_CHECKOUT e.g. the parent commit, `git archive <commit> | tar -x -C
# build/parent`; LEVELS default "2 3").
set -eu
other=$1
levels=${2:-"2 3"}
here=$(cd "$(dirname "$0")/.." && pwd)
for tree in "$other" "$here" "$here" "$other"; do
    python3 "$here/tools_torch/setup_compare.py" --root "$tree" \
        --level $levels --repeat 1
done
