"""Exercise the pose-graph backend on the reference's REAL drift signatures.

The reference ships saved trajectories for 8 real KITTI raw drives
(/root/reference/src/vloam_main/results/<drive>/{VO,LO,MO}{0,1}.txt, writer
vloam_tf.cpp:100-106) — 2,322 rows of real-world VO/LO/MO error shapes.
No KITTI sensor data exists in this environment, but these chains are real
data the backend can consume:

  * revisit DETECTION on the real MO chains with the production
    drift-scaled gate — the raw drives are straight/urban segments that do
    NOT loop, so the sane outcome is zero detections: this measures the
    false-positive side of the gate that synthetic ring courses cannot
    (they always loop);
  * 3-chain FUSION (VO+LO+MO odometry factors, banded solver) on each
    drive — checks the factor weights transfer to real drift shapes: the
    fused chain must stay anchored to MO (deviation << MO-LO gap) and
    reduce the summed odometry residual.

Writes chiprun_out/realchains.json.  tests/test_real_chains.py pins the same
behaviour on the two longest drives.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RESULTS = "/root/reference/src/vloam_main/results"


def load_chain(path: str) -> np.ndarray:
    """KITTI 3x4 rows -> (N, 7) [qx qy qz qw | t] poses (f64)."""
    from vloam_tpu.utils.trajectory import load_kitti_trajectory

    import jax.numpy as jnp

    from vloam_tpu import geometry as geo

    m34 = load_kitti_trajectory(path)
    out = []
    for m in m34:
        q = np.asarray(geo.matrix_to_quat(jnp.array(m[:, :3], jnp.float32)), np.float64)
        out.append(np.concatenate([q, m[:, 3]]))
    return np.stack(out)


def drives() -> list[tuple[str, str]]:
    """(drive_name, detach_suffix) pairs present in the reference results."""
    found = []
    for d in sorted(os.listdir(RESULTS)):
        for det in ("0", "1"):
            if os.path.exists(os.path.join(RESULTS, d, f"MO{det}.txt")):
                found.append((d, det))
    return found


def analyse(drive: str, det: str, keyframe_every: int = 5,
            drift_rate: float = 0.05) -> dict:
    import jax
    import jax.numpy as jnp

    from vloam_tpu import geometry as geo
    from vloam_tpu import geometry_np as gnp
    from vloam_tpu.parallel.loop_closure import detect_revisits
    from vloam_tpu.parallel.pose_graph import (
        concat_factors, odometry_factors, optimize_pose_graph_banded,
    )

    chains = {
        k: load_chain(os.path.join(RESULTS, drive, f"{k}{det}.txt"))
        for k in ("VO", "LO", "MO")
    }
    n = min(len(c) for c in chains.values())
    chains = {k: c[:n] for k, c in chains.items()}
    mo = chains["MO"]

    # --- detection sanity: production gate on a real NON-looping drive ---
    kf_pos = mo[::keyframe_every, 4:]
    pairs = detect_revisits(kf_pos, min_gap=3, radius=6.0, min_spacing=2,
                            min_travel=20.0, drift_rate=drift_rate)
    path = float(np.sum(np.linalg.norm(np.diff(mo[:, 4:], axis=0), axis=1)))

    # --- 3-chain fusion with the driver's weights ------------------------
    def deltas(p):
        d = [gnp.pose_compose(gnp.pose_inverse(p[i]), p[i + 1])
             for i in range(len(p) - 1)]
        return jnp.array(np.stack(d), jnp.float32)

    fac = concat_factors(
        odometry_factors(deltas(mo), 1.0),
        odometry_factors(deltas(chains["LO"]), 0.2),
        odometry_factors(deltas(chains["VO"]), 0.05),
    )
    fused = np.asarray(
        optimize_pose_graph_banded(jnp.array(mo, jnp.float32), fac, None, iters=8)
    )

    def gap(a, b):
        return float(np.mean(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1)))

    return {
        "frames": n,
        "path_m": round(path, 1),
        "spurious_revisits": len(pairs),
        "mo_lo_gap_m": round(gap(mo, chains["LO"]), 3),
        "mo_vo_gap_m": round(gap(mo, chains["VO"]), 3),
        "fused_mo_dev_m": round(gap(fused, mo), 3),
        "fused_finite": bool(np.isfinite(fused).all()),
    }


def main() -> None:
    results = {}
    for drive, det in drives():
        key = f"{drive}_det{det}"
        r = analyse(drive, det)
        results[key] = r
        print(key, json.dumps(r))
    ok_detect = all(r["spurious_revisits"] == 0 for r in results.values())
    ok_anchor = all(
        r["fused_mo_dev_m"] <= 0.5 * max(r["mo_lo_gap_m"], 0.2) or r["mo_lo_gap_m"] < 0.05
        for r in results.values()
    )
    summary = {
        "drives": results,
        "no_spurious_detections": ok_detect,
        "fusion_anchored_to_mo": ok_anchor,
        "note": (
            "real drift signatures from the reference's saved KITTI drives "
            "(results/<drive>/{VO,LO,MO}{0,1}.txt) fed through detection + "
            "banded 3-chain fusion; non-looping drives must yield zero "
            "revisit detections and MO-anchored fusion"
        ),
    }
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "chiprun_out", "realchains.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", out, "| no_spurious:", ok_detect, "| anchored:", ok_anchor)


if __name__ == "__main__":
    main()
