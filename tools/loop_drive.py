"""Loop closure at drift scale: a multi-km synthetic loop through the driver.

Round-3 verdict (weak #5): the 60-frame toy course of test_loop_closure.py
cannot show that revisit DETECTION survives accumulated odometry drift —
at a 1-2 % error rate, any loop longer than ~radius/drift_rate drifts past
a fixed proximity gate.  This drive:

  * builds a ring world around a multi-km circular course (boxes + poles,
    pruned per frame to the sensor's range so raycast stays tractable),
  * runs the FULL pipeline (VloamDriver, --loop-closure semantics) over
    1500+ frames with scan noise high enough to produce visible drift,
  * records: drift at the revisit point, revisit detection under the FIXED
    gate vs the drift-scaled gate (parallel/loop_closure.effective_radius),
    and raw-vs-refined ATE,

into chiprun_out/validation.json under "loop_drive".  The host-side
raycast dominates the runtime; run under nohup/tmux.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def ring_world(radius: float, seed: int = 12) -> np.ndarray:
    """Boxes + poles lining BOTH sides of a circular course of ``radius``
    centred at (0, radius): structure every ~9 m of arc, varied shapes so
    scan registration always has edges and planes in range."""
    rng = np.random.default_rng(seed)
    cx, cy = 0.0, radius
    boxes = []
    n_around = int(2 * np.pi * radius / 9.0)
    for i in range(n_around):
        a = i * 2 * np.pi / n_around
        for r_off, kind in ((14.0, "in"), (-14.0, "out")):
            r = radius + r_off + rng.uniform(-2.5, 2.5)
            x, y = cx + r * np.cos(a), cy + r * np.sin(a)
            if rng.uniform() < 0.35:
                # pole (edge feature)
                boxes.append([x, y, -1.7, x + 0.3, y + 0.3, rng.uniform(2.5, 4.5)])
            else:
                w, d = rng.uniform(3, 8), rng.uniform(3, 8)
                boxes.append([x, y, -1.7, x + w, y + d, -1.7 + rng.uniform(4, 14)])
    return np.array(boxes, np.float64)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--laps", type=int, default=1,
                    help="laps around the ring; >=2 distributes revisits "
                         "over the whole course (every lap-2 keyframe has a "
                         "lap-1 counterpart) instead of clustering them at "
                         "lap end — the interior becomes observable")
    ap.add_argument("--speed", type=float, default=1.3)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--n-azimuth", type=int, default=900)
    ap.add_argument("--keyframe-every", type=int, default=10)
    ap.add_argument("--drift-rate", type=float, default=0.02,
                    help="driver loop_drift_rate (gate growth per metre)")
    ap.add_argument("--exclude-unreliable", action="store_true",
                    help="original-LOAM unreliable-point exclusion")
    ap.add_argument("--tag", default="",
                    help="suffix for the artifact key (loop_drive<tag>)")
    ap.add_argument("--out", default="chiprun_out/validation.json")
    args = ap.parse_args()

    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.data import synthetic
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.parallel.loop_closure import detect_revisits, path_cumlen
    from vloam_tpu.runtime.driver import VloamDriver

    n = args.frames
    yaw_rate = args.laps * 2 * np.pi / n      # exactly --laps laps
    radius = args.speed / yaw_rate
    print(f"[loop_drive] {n} frames, {args.laps} lap(s), "
          f"course length {n * args.speed:.0f} m, radius {radius:.0f} m")
    world = ring_world(radius)
    centers = (world[:, :3] + world[:, 3:]) / 2.0
    poses = synthetic.straight_trajectory(n, speed=args.speed, yaw_rate=yaw_rate)

    cfg = kitti_hdl64()
    if args.exclude_unreliable:
        import dataclasses

        cfg = cfg.replace(
            scan=dataclasses.replace(cfg.scan, exclude_unreliable=True)
        )
    ext = fg.kitti_default_extrinsics()
    driver = VloamDriver(
        cfg, ext, loop_closure=True, keyframe_every=args.keyframe_every,
        loop_radius=6.0, loop_min_travel=100.0,
        loop_drift_rate=args.drift_rate,
    )

    t0 = time.perf_counter()
    mo = []
    for i, (R, t) in enumerate(poses):
        near = np.linalg.norm(centers[:, :2] - t[:2], axis=1) < 110.0
        cloud = synthetic.simulate_scan(
            R, t, world[near], n_azimuth=args.n_azimuth,
            noise=args.noise, seed=i,
        )
        driver.process(None, cloud)
        mo.append(driver._w_mo64.copy())     # the f64 host chain (what the
                                             # backend gates and refines on)
        if i % 100 == 0:
            err = np.linalg.norm(mo[-1][4:] - t)
            print(f"  frame {i:4d}  MO err {err:7.2f} m  "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    mo = np.stack(mo)
    gt = np.stack([t for _, t in poses])

    # detection comparison on the drifted keyframe chain: fixed vs scaled gate
    kf_ids = sorted(driver._keyframes)
    kf_pos = np.stack([mo[i][4:] for i in kf_ids if i < len(mo)])
    fixed_pairs = detect_revisits(kf_pos, min_gap=3, radius=6.0,
                                  min_spacing=2, min_travel=100.0)
    scaled_pairs = detect_revisits(kf_pos, min_gap=3, radius=6.0,
                                   min_spacing=2, min_travel=100.0,
                                   drift_rate=args.drift_rate)
    # drift at the true revisit point (end of lap vs start)
    loop_gap_est = float(np.linalg.norm(mo[-1, 4:] - mo[0, 4:]))
    cum = path_cumlen(kf_pos)

    raw_ate = float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1)))
    raw_final = float(np.linalg.norm(mo[-1, 4:] - gt[-1]))

    t_close = time.perf_counter()
    driver.close()        # runs detection + registration + pose graph
    refined = driver._refined
    ref_ate = ref_final = None
    if refined is not None:
        ref_ate = float(np.mean(np.linalg.norm(refined[:, 4:] - gt, axis=1)))
        ref_final = float(np.linalg.norm(refined[-1, 4:] - gt[-1]))
    unguarded = driver._refined_unguarded
    unguarded_ate = (
        round(float(np.mean(np.linalg.norm(unguarded[:, 4:] - gt, axis=1))), 3)
        if unguarded is not None else None
    )

    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    result = {
        "frames": n,
        "laps": args.laps,
        "refine_report": getattr(driver, "refine_report", {}),
        "f32_divergence_m": driver.f32_divergence_m,
        "path_len_m": round(path, 1),
        "keyframes": len(kf_pos),
        "scan_noise_m": args.noise,
        "drift_at_revisit_m": round(loop_gap_est, 2),
        "drift_pct_of_path": round(100.0 * loop_gap_est / path, 3),
        "detections_fixed_gate": len(fixed_pairs),
        "detections_drift_scaled_gate": len(scaled_pairs),
        "raw_ate_m": round(raw_ate, 3),
        "raw_final_err_m": round(raw_final, 3),
        "refined_ate_m": round(ref_ate, 3) if ref_ate is not None else None,
        "refined_final_err_m": round(ref_final, 3) if ref_final is not None else None,
        "unguarded_refined_ate_m": unguarded_ate,
        "drive_s": round(t_close - t0, 1),
        "close_s": round(time.perf_counter() - t_close, 1),
        "note": (
            "multi-km loop with accumulated drift; detection gate comparison "
            f"fixed (radius=6) vs drift-scaled (radius=6 + {args.drift_rate}"
            "*path); pose graph with loop factors closes the lap"
        ),
    }
    out_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), args.out
    )
    record = {}
    if os.path.exists(out_path):
        with open(out_path) as fp:
            record = json.load(fp)
    record["loop_drive" + args.tag] = result
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(record, fp, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
