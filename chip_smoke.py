"""Smoke run of the VLOAM engine on one NVIDIA GPU.

    python chip_smoke.py          # one card: device, kernels, pipeline
    python chip_smoke.py --four   # four cards: sharded step vs single device

Phases (any failure exits non-zero and prints no result line):
  1. device    — JAX must see a GPU; prints the card's name and power limit.
  2. kernels   — every hand-written kernel at production widths against the
                 repo's plain reference and a NumPy float64 brute force.
  3. pipeline  — ``run_synthetic`` at ``kitti_hdl64()`` with 1800-azimuth
                 sweeps, decoupled then coupled; every pose finite, final
                 VO/LO/MO errors against the exact synthetic trajectory
                 within BOUNDS_M.
  --four       — only: the map-sharded full step on a 4-card mesh against
                 the single-device step, frame by frame.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Times printed here are smoke readings, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")

N_FRAMES = 30
N_AZIMUTH = 1800
# Final translation error bound per chain (m) for the 30-frame drives: the
# same drive's final error with JAX_PLATFORMS=cpu plus 2 cm.  The 2 cm
# absorbs float reordering between backends (sums, scatter-adds, the bf16
# KLT matmuls, the kernel's difference-form d2 against the CPU's matmul
# form); a wrong scatter hint or a corrupted map shows up as decimetres to
# metres.  CPU errors: `JAX_PLATFORMS=cpu python -m vloam_tpu.runtime
# --dataset synthetic --frames 30 --azimuth 1800 [--couple]`.
CPU_FINAL_ERR_M = {
    "decoupled": {"vo": 0.5029928945725871, "lo": 0.48482535058737286,
                  "mo": 0.011122748595443955},
    "coupled": {"vo": 0.5030382978256395, "lo": 0.48368695337334544,
                "mo": 0.008483954626916874},
}
BOUNDS_M = {mode: {c: e + 0.02 for c, e in errs.items()}
            for mode, errs in CPU_FINAL_ERR_M.items()}

# Sharded step vs single device: the tolerance tests/test_vloam_sharded.py
# pins (per-shard top-k merge reorders sums; poses agree to millimetres).
FOUR_ATOL = 5e-3
FOUR_FRAMES = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: jax.devices()[0].platform = {devs[0].platform!r}")
    if len(devs) < n_cards:
        fail(f"needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines()[:n_cards]:
        print(f"card: {line.strip()}")
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    return devs


def _timeit(fn, n=20):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def _scan_points(n_azimuth: int = N_AZIMUTH) -> np.ndarray:
    """One synthetic HDL-64 sweep (~115k points) of the default scene."""
    from vloam_tpu.data import synthetic

    R, t = synthetic.straight_trajectory(1)[0]
    return synthetic.simulate_scan(R, t, synthetic.default_scene(),
                                   n_azimuth=n_azimuth, noise=0.005, seed=0)[:, :3]


def kernel_phase() -> None:
    """The fused k-NN kernel (ops/pallas_knn.py, Pallas through Triton) at
    the shapes the step calls it with, against the plain path of ops/knn.py
    and a NumPy float64 brute force on a query subsample."""
    import jax
    import jax.numpy as jnp

    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.models.laser_mapping import _prune_radius
    from vloam_tpu.ops.knn import knn, knn_mode, morton_sort

    cfg = kitti_hdl64()
    mc, sc = cfg.mapping, cfg.scan
    r_map = _prune_radius(cfg)
    n_sharp = sc.n_scans * sc.n_sectors * sc.max_sharp
    n_lsharp = sc.n_scans * sc.n_sectors * sc.max_less_sharp
    n_flat = sc.n_scans * sc.n_sectors * sc.max_flat
    problems = [
        # name, queries, candidates, k, prune radius (None: full search)
        ("mapping corner", mc.corner_stack_cap, mc.submap_corner_cap, mc.n_neighbors, r_map),
        ("mapping surf", mc.surf_stack_cap, mc.submap_surf_cap, mc.n_neighbors, r_map),
        ("LO edge", n_sharp, n_lsharp, cfg.odom.assoc_k, None),
        ("LO plane", n_flat, sc.less_flat_cap, cfg.odom.assoc_k_surf, None),
    ]
    pts = _scan_points()
    rng = np.random.default_rng(0)
    # d2 = (qx-cx)^2 + ...: the subtraction is exact for neighbours
    # (Sterbenz), so the kernel's d2 carries 3 rounded products + 2 adds.
    rtol_brute = 2.0 ** -20
    for name, m, n, k, r in problems:
        c = pts[rng.choice(len(pts), n, replace=False)].astype(np.float32)
        cmask = rng.random(n) < 0.7        # submaps and clouds are part-filled
        q = (pts[rng.choice(len(pts), m, replace=False)]
             + rng.normal(0, 0.05, (m, 3))).astype(np.float32)
        qj, cj, mj = jnp.array(q), jnp.array(c), jnp.array(cmask)
        if r is not None:                  # the mapping step Morton-sorts both
            cj, mj = morton_sort(cj, mj, cell=4.0)
            qj, _ = morton_sort(qj, jnp.ones(m, bool), cell=2.0)
        res = {}
        for mode in ("plain", "kernel"):
            with knn_mode(mode):
                f = jax.jit(lambda a, b, d: knn(a, b, d, k, prune_radius=r))
                out = f(qj, cj, mj)
                res[mode] = (np.asarray(out[0]), np.asarray(out[1]),
                             _timeit(lambda: f(qj, cj, mj)))
        (pd, pi, tp), (kd, ki, tk) = res["plain"], res["kernel"]
        if not np.isfinite(kd).all():
            fail(f"knn {name}: non-finite kernel distances")
        # exactness against float64 brute force on 256 queries
        qn, cn, mn = np.asarray(qj), np.asarray(cj), np.asarray(mj)
        sub = rng.choice(m, 256, replace=False)
        d64 = ((qn[sub, None, :].astype(np.float64) - cn[None]) ** 2).sum(-1)
        d64[:, ~mn] = np.inf
        ref = np.sort(d64, axis=1)[:, :k]
        gate = ref < (np.inf if r is None else r * r)
        err_b = float(np.max(np.abs(kd[sub][gate] - ref[gate]) / np.maximum(ref[gate], 1e-12)))
        rec = float(np.mean(np.take_along_axis(d64, ki[sub], 1)[gate]
                            <= ref[gate] * (1 + rtol_brute)))
        # against the plain path: its |q|^2+|c|^2-2q.c cancels up to
        # ~4 eps |x|^2 per entry, so compare inside that bound
        tol_p = 8 * 2.0 ** -24 * float(np.max((qn ** 2).sum(1)) + np.max((cn ** 2).sum(1)))
        pg = pd < (1e30 if r is None else r * r)
        err_p = float(np.max(np.abs(kd[pg] - pd[pg]))) if pg.any() else 0.0
        agree = float(np.mean(ki[pg] == pi[pg])) if pg.any() else 1.0
        print(f"kernel knn_fused [{name} {m}x{n} k={k} r={r}]: "
              f"vs brute max rel d2 err {err_b:.2e} (tol {rtol_brute:.2e}), "
              f"recall {rec:.4f} (tol 1.0); vs plain max |d2 diff| {err_p:.2e} "
              f"(tol {tol_p:.2e}), idx agreement {agree:.4f}; "
              f"plain {tp:.3f} ms, kernel {tk:.3f} ms")
        if err_b > rtol_brute or rec < 1.0 or err_p > tol_p:
            fail(f"knn {name}: kernel disagrees with the reference")


def pipeline_phase() -> None:
    import jax

    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.runtime import native
    from vloam_tpu.runtime.driver import run_synthetic

    print(f"host loader: {'native' if native.available() else 'numpy'}")
    for mode, detach in (("decoupled", True), ("coupled", False)):
        cfg = kitti_hdl64().replace(detach_vo_lo=detach)
        out_dir = os.path.join(OUT, mode)
        t0 = time.perf_counter()
        res = run_synthetic(cfg, n_frames=N_FRAMES, n_azimuth=N_AZIMUTH,
                            out_dir=out_dir, verbose=False, step_memory=True)
        wall = time.perf_counter() - t0
        d = int(detach)
        for chain in ("VO", "LO", "MO"):
            rows = np.loadtxt(os.path.join(out_dir, f"{chain}{d}.txt"))
            if rows.shape[0] != N_FRAMES or not np.isfinite(rows).all():
                fail(f"{mode}: {chain} trajectory has {rows.shape[0]} rows or non-finite poses")
        errs = {c: res[f"final_err_{c}_m"] for c in ("vo", "lo", "mo")}
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        print(f"pipeline {mode}: final err (m) " + ", ".join(
            f"{c.upper()} {errs[c]:.4f} (bound {BOUNDS_M[mode][c]:.4f})" for c in errs))
        print(f"pipeline {mode}: steady {res['steady_ms_per_frame']:.2f} ms/frame, "
              f"wall {wall:.1f} s incl. compile, step memory {res['step_memory']}, "
              f"peak_bytes_in_use {peak}")
        print(f"pipeline {mode}: mean ms per driver stage " + json.dumps(
            {k: round(v, 2) for k, v in res["stage_ms"].items()}))
        for c, e in errs.items():
            if not e <= BOUNDS_M[mode][c]:
                fail(f"{mode}: {c.upper()} final error {e:.4f} m over {BOUNDS_M[mode][c]:.4f} m")


def four_phase() -> None:
    """Full step with the cube map sharded over a 4-card mesh vs the
    single-device step, in one process, frame by frame."""
    import jax
    import jax.numpy as jnp

    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.data import synthetic
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu.parallel.mesh import map_mesh
    from vloam_tpu.parallel.vloam_shard import make_sharded_vloam_step, shard_vloam_state
    from vloam_tpu.runtime.driver import synthetic_frames

    cfg = kitti_hdl64()
    ext = fg.kitti_default_extrinsics()
    mesh = map_mesh(4)
    single = jax.jit(lambda s, i, c, m: vloam_step(s, i, c, m, ext, cfg))
    sharded = make_sharded_vloam_step(cfg, ext, mesh)
    st_1 = init_vloam_state(cfg)
    st_4 = shard_vloam_state(init_vloam_state(cfg, n_map_shards=4), mesh)
    poses = synthetic.straight_trajectory(FOUR_FRAMES, speed=0.8, yaw_rate=0.005)
    worst = {}
    for i, (img, cloud) in enumerate(synthetic_frames(cfg, ext, poses, N_AZIMUTH)):
        p, m = synthetic.pad_cloud(cloud, cfg.scan.max_points)
        args = (jnp.array(img), jnp.array(p), jnp.array(m))
        st_1, o1 = single(st_1, *args)
        st_4, o4 = sharded(st_4, *args)
        for name in ("vo_pose", "lo_pose", "mo_pose", "world_mo"):
            a, b = np.asarray(getattr(o4, name)), np.asarray(getattr(o1, name))
            if not np.isfinite(a).all():
                fail(f"--four frame {i}: non-finite {name}")
            worst[name] = max(worst.get(name, 0.0), float(np.max(np.abs(a - b))))
    if st_4.mp.cube_pts.sharding.is_fully_replicated:
        fail("--four: cube map is not partitioned")
    print(f"four-card sharded step vs single device, {FOUR_FRAMES} frames: max |diff| "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tol {FOUR_ATOL})")
    for name, v in worst.items():
        if v > FOUR_ATOL:
            fail(f"--four: {name} differs by {v:.2e} > {FOUR_ATOL}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded step and its comparison")
    args = ap.parse_args()

    from vloam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = device_phase(4 if args.four else 1)
    if args.four:
        four_phase()
    else:
        kernel_phase()
        pipeline_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
