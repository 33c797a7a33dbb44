"""Production-scale validation drive: accuracy AND throughput on one chip.

Drives the full coupled pipeline over a LONG synthetic trajectory (default
300 frames, ~270 m, multiple 50 m cube-grid crossings) with exact ground
truth, then scores the MO trajectory with the self-contained KITTI
evaluation protocol (utils/kitti_eval: translational RMSE %% / rotational
deg/m over 100-800 m segments — the Table-I convention of BASELINE.md) and
records steady-state fps over the same frames.

This is the closest available stand-in for the "KITTI 00-10 within the
reference's ATE bounds" north star (no KITTI data exists in this
environment): same metrics, same engine path, known-exact ground truth.
The synthetic Manhattan world is structurally easier than real KITTI —
treat the absolute numbers as an upper bound on fidelity, not a KITTI
claim; the reference's own Table-I MO(C) average is 1.26 %% / 0.0055 deg/m.

Writes chiprun_out/validation.json (keyed by mode; ``--hard`` prefixes the mode and
enables the stressor world — dynamic vehicles, a textureless stretch, a
ground-dominated plaza; see bench._gen_frames).  Takes ~10 min (frame
raycast dominates); run under tmux or nohup, not a 10-minute shell window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--speed", type=float, default=0.9)
    ap.add_argument("--yaw-rate", type=float, default=0.004)
    ap.add_argument("--out", default="chiprun_out/validation.json")
    ap.add_argument("--couple", action="store_true",
                    help="coupled VLOAM mode (detach_VO_LO=false)")
    ap.add_argument("--hard", action="store_true",
                    help="stressor world: dynamic vehicles + textureless "
                         "stretch + ground-dominated plaza (bench._gen_frames "
                         "hard=True)")
    ap.add_argument("--exclude-unreliable", action="store_true",
                    help="original-LOAM occluded/parallel-beam exclusion "
                         "(ScanConfig.exclude_unreliable)")
    args = ap.parse_args()

    import jax

    from bench import _gen_frames
    from vloam_tpu import geometry as geo
    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu.utils import kitti_eval

    cfg = kitti_hdl64()
    if args.couple:
        cfg = cfg.replace(detach_vo_lo=False)
    if args.exclude_unreliable:
        import dataclasses

        cfg = cfg.replace(
            scan=dataclasses.replace(cfg.scan, exclude_unreliable=True)
        )
    ext = fg.kitti_default_extrinsics()
    t_gen0 = time.perf_counter()
    frames, poses = _gen_frames(
        cfg, ext, n_frames=args.frames, speed=args.speed, yaw_rate=args.yaw_rate,
        snake=True, hard=args.hard,
    )
    t_gen = time.perf_counter() - t_gen0

    step = jax.jit(
        lambda s, i, c, m, b, t: vloam_step(
            s, i, c, m, ext, cfg, pre_gridded=True, pre_buckets=b, pre_lf_table=t
        ),
        donate_argnums=0,
    )
    state = init_vloam_state(cfg)

    import jax.numpy as jnp

    outs = []
    # warmup/compile on frame 0 is inside the loop; time the steady tail,
    # closing the async window with ONE last-frame fetch — fetching the
    # whole history inside the window would serialise host and device
    # every frame
    t_steady = None
    for k, f in enumerate(frames):
        state, out = step(state, *f)
        outs.append(out.world_mo)
        if k == 3:
            np.asarray(out.world_mo)
            t_steady = time.perf_counter()
    np.asarray(out.world_mo)
    t_end = time.perf_counter()
    fps = (len(frames) - 4) / (t_end - t_steady)
    # history fetch (untimed): one stacked transfer
    mo = np.asarray(jnp.stack(outs))

    to_mat = jax.jit(jax.vmap(geo.pose_to_matrix))
    est44 = np.asarray(to_mat(jnp.array(mo, jnp.float32)))
    est = est44[:, :3, :4]
    gt = np.stack([np.concatenate([R, t[:, None]], axis=1) for R, t in poses])

    res = kitti_eval.evaluate(gt, est)
    res_ate = kitti_eval.ate(gt, est)
    path_len = float(
        np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1))
    )
    final_err = float(np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3]))
    mode = "coupled_C" if args.couple else "decoupled_D"
    if args.hard:
        mode = "hard_" + mode
    if args.exclude_unreliable:
        mode = "excl_" + mode
    result = {
        "mode": mode,
        "frames": len(frames),
        "path_len_m": round(path_len, 1),
        "mo_trans_pct": round(res["trans_pct"], 4),
        "mo_rot_deg_per_m": round(res["rot_deg_per_m"], 5),
        "segments": res["segments"],
        "ate_m": round(res_ate, 4),
        "final_err_m": round(final_err, 4),
        "fps": round(fps, 1),
        "frame_gen_s": round(t_gen, 1),
        "note": (
            ("STRESSOR world: oncoming + crossing vehicles (lidar+camera), "
             "12-frame textureless stretch, ground-dominated plaza; " if args.hard
             else "synthetic Manhattan world with exact ground truth; ")
            + "KITTI 100-800 m segment protocol; an engine-fidelity check, "
            "not a KITTI result. Reference Table-I MO(C) avg: 1.26 % / "
            "0.0055 deg/m."
        ),
    }
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", args.out)
    record = {}
    if os.path.exists(out_path):
        with open(out_path) as fp:
            prev = json.load(fp)
        # either already keyed by mode, or a bare single-mode record
        record = {prev["mode"]: prev} if "mode" in prev else prev
    record[mode] = result
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(record, fp, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
