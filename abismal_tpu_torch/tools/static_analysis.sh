#!/usr/bin/env bash
# Static-analysis gate for the port's native C++ (↔ tools/static_analysis.sh,
# which gates abismal_tpu/native/): GCC's strictest relevant warning set,
# warnings as errors, over every source of abismal_tpu_torch/native/ in both
# build profiles (default and -DABISMAL_SHORT).  The CUDA sources
# (abismal_tpu_torch/csrc/*.cu) need nvcc and are not gated here.
#
# Usage: abismal_tpu_torch/tools/static_analysis.sh   (non-zero on a finding)
set -e
PORT="$(cd "$(dirname "$0")/.." && pwd)"
WARN=(-Wall -Wextra -Wpedantic -Wshadow -Wvla -Wformat=2 -Wundef
      -Wpointer-arith -Wcast-qual -Wwrite-strings -Wdouble-promotion
      -Wmissing-field-initializers -Woverflow -Werror)
for prof in "" "-DABISMAL_SHORT"; do
  for src in "$PORT"/native/*.cpp; do
    echo "checking $(basename "$src") ${prof:-(default)}"
    g++ -std=c++17 -O1 -fsyntax-only $prof "${WARN[@]}" \
      -march=native -pthread "$src"
  done
done
echo "static analysis clean"
