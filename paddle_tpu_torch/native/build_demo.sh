#!/bin/sh
# Build the C++ train demo (the port's copy of paddle_tpu/native/
# build_demo.sh; reference: paddle/fluid/train/demo build) into
# paddle_tpu_torch/_build/train_demo.  PYTHON (default python3) is the
# interpreter the demo embeds: its includes, its libpython and its
# packages.
#   sh paddle_tpu_torch/native/build_demo.sh
#   ./paddle_tpu_torch/_build/train_demo [steps]
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
ROOT="$(dirname "$(dirname "$HERE")")"
OUT="$(dirname "$HERE")/_build"
PYTHON="${PYTHON:-python3}"
CXX="${CXX:-g++}"
PY_EXE="$("$PYTHON" -c 'import sys; print(sys.executable)')"
PY_CONFIG="$("$PYTHON" -c 'import sys, sysconfig, os; print(os.path.join(sysconfig.get_config_var("BINDIR"), "python3-config"))')"
[ -x "$PY_CONFIG" ] || PY_CONFIG=python3-config
PY_INC="$("$PY_CONFIG" --includes)"
PY_LD="$("$PY_CONFIG" --ldflags --embed 2>/dev/null \
         || "$PY_CONFIG" --ldflags)"
mkdir -p "$OUT"
# shellcheck disable=SC2086
"$CXX" -O2 -o "$OUT/train_demo" "$HERE/train_demo.cc" \
    -DDEMO_PYTHON="\"$PY_EXE\"" -DDEMO_REPO_ROOT="\"$ROOT\"" \
    $PY_INC $PY_LD
echo "built $OUT/train_demo"
