#!/usr/bin/env bash
# Canonical render commands (reference assets/auto_scripts/run.sh,
# with this renderer's default flags; foam uses the procedural stand-in
# slab).
set -e
cd "$(dirname "$0")/../.."
python ./render.py --scene cbox --name cbox.xml --iter_num 8000 --type bdpt
python ./render.py --scene trans --name foam.xml --iter_num 200000 \
    --type bdpt --normalize 0.99 -a
