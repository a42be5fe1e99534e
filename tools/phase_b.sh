#!/bin/bash
# Phase B: measured end-to-end results for every sensor mode (the
# reference's app-level protocol: run a mode binary per sequence, save TUM
# trajectories, score offline — Examples/Event/fmt_ev_ethz.cpp + scripts/
# ev_ethz_batch.sh). All 10 configs MUST produce gated rows: the gates
# live in tools/make_results.py (tracked fraction, per-mode APE bounds,
# minimum row count) and this script exits nonzero when any gate fails.
#
# Usage: bash tools/phase_b.sh [results/r5]
set -u
OUT=${1:-results/r5}
mkdir -p "$OUT"
SUM="$OUT/summary.txt"
: > "$SUM"

gen() { # kind seq traj dur seed extra...
  local kind=$1 seq=$2 traj=$3 dur=$4 seed=$5; shift 5
  local root="data_synth/$kind"
  if [ ! -e "$root/$seq" ]; then
    python -m eorb_slam_tpu.io.synth_dataset --out "$root" --kind "$kind" \
      --seq "$seq" --traj "$traj" --duration "$dur" --seed "$seed" "$@" \
      || echo "GEN FAILED: $seq" >> "$SUM"
  fi
}

# ---- datasets (rendered once, reused across modes)
gen euroc corridor_01 corridor 30 0
gen euroc corridor_02 corridor 30 1
gen euroc room_01     room     60 2
gen euroc corridor_st_01 corridor 30 3 --stereo-baseline 0.11 --depth
gen ev_ethz shakes_01 shakes 10 0
gen ev_ethz shakes_02 shakes 10 1

run() { # config
  echo "== $1 ==" >&2
  python -m eorb_slam_tpu.apps.run_slam "configs/$1" --out "$OUT" --eval \
    >> "$SUM" 2>> "$OUT/log.txt" || echo "RUN FAILED: $1" >> "$SUM"
}

run synth_euroc_mono.yaml        # MONOCULAR (corridor_01/02, room_01)
run synth_euroc_mono_loop.yaml   # MONOCULAR + loop closing vocab
run synth_euroc_vi.yaml          # IMU_MONOCULAR
run synth_euroc_stereo.yaml      # STEREO
run synth_euroc_rgbd.yaml        # RGBD
run synth_euroc_imu_stereo.yaml  # IMU_STEREO
run synth_ev_only.yaml           # EVENT_ONLY
run synth_ev_imu.yaml            # EVENT_IMU
run synth_ev_mono.yaml           # EVENT_MONO
run synth_ev_imu_mono.yaml       # EVENT_IMU_MONO

# gates: a failing row (missing mode, tracked fraction, APE bound) makes
# the whole phase fail — telemetry that cannot fail is not a gate
if python tools/make_results.py "$SUM" > "$OUT/RESULTS.md"; then
  echo "phase B done, ALL GATES PASS -> $SUM" >&2
else
  echo "phase B done, GATES FAILED (see $OUT/RESULTS.md tail) -> $SUM" >&2
  exit 1
fi
