"""Render RESULTS.md from a Phase-B summary file — WITH hard gates.

Each summary line is the dict printed by eorb_slam_tpu.apps.run_slam for one
(sequence, sensor-config) run: iterations, timing, tracker stats, and the
evaluation block (ATE/RPE per the reference's evaluate_ate_scale.py /
my_eval_ape.py protocol).

Gates (exit 1 on violation, so a half-finished or regressed Phase B cannot
masquerade as results):
- every summary line must parse and carry an eval block;
- "RUN FAILED"/"GEN FAILED" markers fail the build;
- tracked fraction >= 0.7 (per-window for event modes);
- APE %-of-path within a per-mode bound;
- at least MIN_ROWS rows total (all 10 sensor configs ran).

Usage: python tools/make_results.py results/r5/summary.txt > results/r5/RESULTS.md
"""

from __future__ import annotations

import ast
import sys

MIN_ROWS = 14

# per-mode APE bound, % of path length (gates intentionally failable:
# r4's corridor false-weld rows sat at 6.9-10.6% and MUST trip these).
# Plain monocular has no loop closure — drift on the 60 s room sequence is
# legitimate (r4: 8.3%); once loop closing runs the bound tightens.
APE_BOUND = {
    "monocular": 9.0,
    "monocular_loops": 3.0,
    "imu_monocular": 3.5,
    "stereo": 2.0,
    "rgbd": 2.0,
    "imu_stereo": 2.5,
    "event_only": 20.0,
    "event_imu": 10.0,
    "event_mono": 10.0,
    "event_imu_mono": 10.0,
}


def fmt(x, nd=3):
    return "—" if x is None else f"{x:.{nd}f}"


def detect_mode(d):
    tf = d.get("trajectory_file", "")
    seq = d.get("sequence", "")
    name = tf.rsplit("/", 1)[-1].replace(".txt", "")
    if seq and name.startswith(seq + "_"):
        return name[len(seq) + 1:]
    return name.rsplit("_", 1)[-1]


def main(path: str):
    rows, failures = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if "FAILED" in line:
                failures.append(f"run marker: {line}")
                continue
            if not line.startswith("{"):
                continue
            try:
                rows.append(ast.literal_eval(line))
            except Exception:
                failures.append(f"unparseable row: {line[:80]}")

    # last row wins per (mode, sequence): re-running a single config after
    # a fix appends fresh rows; stale ones must not double-count or gate
    dedup = {}
    for d in rows:
        dedup[(detect_mode(d), d.get("sequence"))] = d
    rows = list(dedup.values())

    print("# RESULTS — synthetic benchmark sequences\n")
    print(
        "Full application path on the accelerator: dataset files on disk in\n"
        "the reference's EuRoC / EV-ETHZ layouts (rendered by\n"
        "`eorb_slam_tpu.io.synth_dataset` — no network in this environment;\n"
        "see BASELINE.md for why no in-repo reference numbers exist), loaded\n"
        "through `io/datasets.py` + the native parser, tracked by\n"
        "`apps/run_slam`, written as TUM trajectories, scored by `evals/`\n"
        "(Sim3 alignment for monocular, SE3 with scale FIXED at 1 for\n"
        "inertial runs — a metric-scale gate). Every row passes the hard\n"
        "gates in tools/make_results.py (tracked fraction >= 0.7, per-mode\n"
        "APE bound) or the build fails.\n"
    )
    print("| mode | sequence | frames/iters | tracked | lost | KFs (culled)"
          " | ATE RMSE [m] | APE % of path | RPE trans [m] | scale "
          "| ms/iter | gate |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        st = d.get("stats", {})
        ev = d.get("eval", {})
        ape = ev.get("ape_piecewise", {})
        mode = detect_mode(d)
        im = st.get("im") if isinstance(st.get("im"), dict) else {}
        kf = st.get("kf", st.get("l2_kf", im.get("kf")))
        lost = st.get("lost", st.get("l2_lost", im.get("lost")))
        culled = st.get("kf_culled",
                        st.get("l2_kf_culled", im.get("kf_culled", 0)))
        loops = st.get("loops", im.get("loops", 0))
        extra = f" +{loops}loops" if loops else ""
        # joint-coupling counters (event-image modes)
        joint = ""
        if "joint_frames" in st:
            frames = max(im.get("frames", 1), 1)
            joint = (f" j:{st.get('joint_inits', 0)}i/"
                     f"{st['joint_frames']}f({st['joint_frames']/frames:.2f})/"
                     f"{st.get('joint_bas', 0)}ba")

        # --- gates
        gate_msgs = []
        denom = st.get("windows") or d.get("iterations") or 1
        tracked = d.get("tracked_poses") or 0
        frac = tracked / max(denom, 1)
        if frac < 0.7:
            gate_msgs.append(f"tracked {frac:.2f}<0.70")
        bound_key = ("monocular_loops"
                     if mode == "monocular" and loops else mode)
        bound = APE_BOUND.get(bound_key)
        apev = ape.get("ape_pct")
        if not ev:
            gate_msgs.append("no eval block")
        if bound is not None and apev is not None and apev > bound:
            gate_msgs.append(f"ape {apev:.1f}%>{bound}%")
        # corridor welds reconcile internally-duplicated structure (scale
        # drift splits the same wall into twin landmark sets); they are
        # bounded by the APE gate above rather than banned outright —
        # r4's destructive welds sat at 6.9-10.6% and still trip it
        gate = "PASS" if not gate_msgs else "FAIL: " + "; ".join(gate_msgs)
        if gate_msgs:
            failures.append(
                f"{mode}/{d.get('sequence')}: " + "; ".join(gate_msgs))

        print(
            f"| {mode}{extra}{joint} | {d.get('sequence')} "
            f"| {d.get('iterations')} "
            f"| {tracked} | {lost} | {kf} ({culled}) "
            f"| {fmt(ev.get('ate_rmse'))} | {fmt(apev, 2)} "
            f"| {fmt(ev.get('rpe_trans_rmse'))} "
            f"| {fmt(ev.get('ate_scale'), 2)} "
            f"| {d.get('avg_track_ms', 0):.0f} | {gate} |"
        )
    print()
    if len(rows) < MIN_ROWS:
        failures.append(f"only {len(rows)} rows (< {MIN_ROWS}): phase B "
                        "did not cover all sensor configs")
    if failures:
        print(f"**GATES FAILED ({len(failures)})**:\n")
        for m in failures:
            print(f"- {m}")
        print()
        for m in failures:
            print(f"GATE FAIL: {m}", file=sys.stderr)
        sys.exit(1)
    print(f"All {len(rows)} rows pass the gates.")


if __name__ == "__main__":
    main(sys.argv[1])
