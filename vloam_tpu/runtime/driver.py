"""Sequence driver: the frame loop of vloam_main_node.cpp:134-202 as a CLI.

Replaces actionlib goals + rosbag replay with direct dataset iteration.
Writes the same VO{d}.txt / LO{d}.txt / MO{d}.txt trajectory files
({d} = detach_VO_LO as 0/1, vloam_main_node.cpp:99-101) so the reference's
evaluation tooling applies unchanged.

World poses are accumulated TWICE: in f32 inside the jitted step (the
device-side coupling state) and in float64 on host from the per-frame
deltas in VloamOutputs (geometry_np; the reference leans on Ceres doubles,
laser_odometry.cpp:524-525).  Trajectory export, loop-closure gating, and
pose-graph refinement all read the f64 chains; the realised f32-vs-f64
divergence is tracked per chain (``f32_divergence_m``) and reported by
tools/validate_drive.py.
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo
from vloam_tpu import geometry_np as gnp
from vloam_tpu.config import VloamConfig
from vloam_tpu.data import synthetic
from vloam_tpu.data.gridding import depth_buckets, grid_cloud
from vloam_tpu.models import frame_graph as fg
from vloam_tpu.models.vloam import VloamOutputs, init_vloam_state, vloam_step
from vloam_tpu.utils.profiling import StageTimer
from vloam_tpu.utils.trajectory import TrajectoryWriter


def extrinsics_from_calib(calib) -> fg.Extrinsics:
    """KittiCalib -> frame-graph Extrinsics.  base_link is taken as the
    velodyne frame (the reference's coupling chain conflates them anyway;
    exports are rebased to cam0@start so the choice cancels there)."""
    cam_T_velo = jnp.array(calib.cam_T_velo, jnp.float32)
    rect = jnp.array(calib.rect0_T_cam, jnp.float32)
    velo_T_cam0 = geo.pose_from_matrix(jnp.linalg.inv(rect @ cam_T_velo))
    return fg.Extrinsics(
        base_T_cam0=velo_T_cam0,
        velo_T_cam0=velo_T_cam0,
        cam_T_velo=cam_T_velo,
        P_rect0=jnp.array(calib.P_rect0, jnp.float32),
        R_rect0=rect,
    )


def pad_image(img: np.ndarray, cfg: VloamConfig) -> np.ndarray:
    vc = cfg.visual
    out = np.zeros((vc.img_height, vc.img_width), np.float32)
    h = min(img.shape[0], vc.img_height)
    w = min(img.shape[1], vc.img_width)
    out[:h, :w] = img[:h, :w]
    return out


class VloamDriver:
    """Owns the jitted step, the host-side f64 pose chains, and exporters."""

    def __init__(
        self,
        cfg: VloamConfig,
        ext: fg.Extrinsics,
        out_dir: str | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        debug_dir: str | None = None,
        debug_every: int = 0,
        refine: bool = False,
        loop_closure: bool = False,
        keyframe_every: int = 10,
        loop_radius: float = 6.0,
        loop_min_travel: float = 20.0,
        loop_drift_rate: float = 0.05,
        loop_min_gap: int = 3,
    ):
        self.cfg = cfg
        self.ext = ext
        self.state = init_vloam_state(cfg)
        self.timer = StageTimer()
        self.count = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.debug_dir = debug_dir
        self.debug_every = debug_every
        self._debug_prev = None
        # Pose-graph backend (the reference has none): accumulate per-frame
        # world poses and fuse the three odometry chains after the sequence.
        self.refine = refine or loop_closure
        self._world_hist: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._refined: np.ndarray | None = None
        # f64 host world chains, rebased from per-frame f32 deltas (module
        # docstring; reference: Ceres doubles).  _anchor64 is the f64 twin
        # of cam0_init_T_cam0_start, captured at frame 0.
        self._w_vo64 = gnp.pose_identity()
        self._w_lo64 = gnp.pose_identity()
        self._w_mo64 = gnp.pose_identity()
        self._anchor64: np.ndarray | None = None
        self.f32_divergence_m = {"vo": 0.0, "lo": 0.0, "mo": 0.0}
        # Loop closure (parallel/loop_closure.py): keep every Nth frame's
        # ring grid on host (~2 MB/keyframe) so revisits detected on the MO
        # chain at close() can be re-registered scan-to-scan.
        self.loop_closure = loop_closure
        self.keyframe_every = keyframe_every
        self.loop_radius = loop_radius
        self.loop_min_travel = loop_min_travel
        self.loop_drift_rate = loop_drift_rate
        self.loop_min_gap = loop_min_gap
        self._keyframes: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.refine_report: dict = {}
        self._refined_unguarded: np.ndarray | None = None
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)
        # lidar frames arrive as host-built ring grids (data/gridding.py): the
        # O(N) ring ranking runs in the loader (overlapped with device compute
        # in the native prefetcher) instead of costing ~5 ms of the hot loop
        # donate the state: the cube-map arrays (hundreds of MB) update
        # in place instead of being copied every frame
        self._step = jax.jit(
            lambda s, i, g, m, b, t: vloam_step(
                s, i, g, m, ext, cfg, pre_gridded=True, pre_buckets=b, pre_lf_table=t
            ),
            donate_argnums=0,
        )
        self._arg_shapes = None
        self._proj = np.asarray(ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo)
        self.writers = {}
        self.out_dir = out_dir
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            d = int(cfg.detach_vo_lo)
            self.writers = {
                "vo": TrajectoryWriter(os.path.join(out_dir, f"VO{d}.txt")),
                "lo": TrajectoryWriter(os.path.join(out_dir, f"LO{d}.txt")),
                "mo": TrajectoryWriter(os.path.join(out_dir, f"MO{d}.txt")),
            }

    def save_checkpoint(self) -> None:
        """Snapshot the device pytree AND the host driver state
        (<path>_driver.npz: f64 chains, loop-closure keyframes, world
        history) so a resumed run is bit-equivalent to an uninterrupted
        one — including loop closure and refinement across the boundary."""
        from vloam_tpu.utils.checkpoint import save_checkpoint

        path = os.path.join(self.checkpoint_dir, f"ckpt_{self.count:06d}")
        save_checkpoint(path, self.state, self.count)
        for w in self.writers.values():
            w.flush()
        kf_ids = sorted(self._keyframes)
        arrs = {
            "w_vo64": self._w_vo64, "w_lo64": self._w_lo64, "w_mo64": self._w_mo64,
            "anchor64": (self._anchor64 if self._anchor64 is not None
                         else np.zeros(0, np.float64)),
            "divergence": np.array(
                [self.f32_divergence_m[k] for k in ("vo", "lo", "mo")], np.float64
            ),
            "world_hist": (np.stack([np.stack(h) for h in self._world_hist])
                           if self._world_hist else np.zeros((0, 3, 7), np.float64)),
            "kf_ids": np.array(kf_ids, np.int64),
        }
        for fid in kf_ids:
            g, m = self._keyframes[fid]
            arrs[f"kf_grid_{fid}"] = g
            arrs[f"kf_mask_{fid}"] = m
        np.savez(path + "_driver.npz", **arrs)

    def restore_checkpoint(self, path: str) -> int:
        """Restore device + driver state from a checkpoint; truncates the
        trajectory files to the checkpointed row count and re-opens them in
        append mode.  Returns the frame index to resume from."""
        from vloam_tpu.utils.checkpoint import load_checkpoint

        self.state, self.count = load_checkpoint(path, self.state)
        dpath = path.rstrip("/") + "_driver.npz"
        if os.path.exists(dpath):
            z = np.load(dpath)
            self._w_vo64 = z["w_vo64"]
            self._w_lo64 = z["w_lo64"]
            self._w_mo64 = z["w_mo64"]
            self._anchor64 = z["anchor64"] if z["anchor64"].size else None
            self.f32_divergence_m = dict(
                zip(("vo", "lo", "mo"), (float(v) for v in z["divergence"]))
            )
            wh = z["world_hist"]
            self._world_hist = [(wh[i, 0], wh[i, 1], wh[i, 2]) for i in range(len(wh))]
            self._keyframes = {
                int(fid): (z[f"kf_grid_{fid}"], z[f"kf_mask_{fid}"])
                for fid in z["kf_ids"]
            }
        elif self.refine or self.loop_closure:
            print(f"[warn] {dpath} missing: resumed run loses pre-resume "
                  "keyframes/world history (pre-round-5 checkpoint)")
        for w in self.writers.values():
            w.resume_at(self.count)
        return self.count

    def process(self, image: np.ndarray | None, cloud: np.ndarray) -> VloamOutputs:
        cfg = self.cfg
        with self.timer.stage("host_grid"):
            grid, gmask, _ = grid_cloud(cloud.astype(np.float32), cfg.scan)
        return self.process_grid(image, grid, gmask)

    def dump_debug(self, image: np.ndarray, grid: np.ndarray, gmask: np.ndarray) -> None:
        """Write keypoint / optical-flow / lidar-depth debug PNGs for the
        CURRENT frame (the reference's visualize_depth / visualize_optical_flow
        rviz topics, visual_odometry.cpp:548-581) into debug_dir."""
        import jax

        from vloam_tpu.ops import image_ops
        from vloam_tpu.ops.depth_map import project_cloud
        from vloam_tpu.utils import visualize as viz

        cfg = self.cfg
        img = pad_image(image, cfg)
        imj = jnp.array(img)
        kp, kp_mask, _ = jax.jit(
            lambda im: image_ops.detect_corners(im, cfg.visual)
        )(imj)
        viz.save_png(
            os.path.join(self.debug_dir, f"keypoints_{self.count:06d}.png"),
            viz.draw_keypoints(img, np.asarray(kp), np.asarray(kp_mask)),
        )
        if self._debug_prev is not None:
            pimg, pkp, pmask = self._debug_prev
            curr, ok = jax.jit(
                lambda a, b, p, m: image_ops.lk_track_fb(a, b, p, m, cfg.visual)
            )(jnp.array(pimg), imj, pkp, pmask)
            viz.save_png(
                os.path.join(self.debug_dir, f"flow_{self.count:06d}.png"),
                viz.draw_flow(img, np.asarray(pkp), np.asarray(curr), np.asarray(ok)),
            )
        proj = self.ext.P_rect0 @ self.ext.R_rect0 @ self.ext.cam_T_velo
        flat = jnp.array(grid.reshape(-1, 4)[:, :3])
        fmask = jnp.array(gmask.reshape(-1))
        uvz, ok = jax.jit(
            lambda c, m: project_cloud(c, m, proj, cfg.visual)
        )(flat, fmask)
        uvz, ok = np.asarray(uvz), np.asarray(ok)
        viz.save_png(
            os.path.join(self.debug_dir, f"depth_{self.count:06d}.png"),
            viz.draw_depth(img, uvz[:, :2], uvz[:, 2], ok),
        )
        self._debug_prev = (img, kp, kp_mask)

    def process_grid(
        self, image: np.ndarray | None, grid: np.ndarray, gmask: np.ndarray
    ) -> VloamOutputs:
        """Feed a pre-built ring grid (native prefetcher grid mode)."""
        cfg = self.cfg
        if image is None:
            img = np.zeros((cfg.visual.img_height, cfg.visual.img_width), np.float32)
        else:
            img = pad_image(image, cfg)
        if self.debug_dir and self.debug_every and self.count % self.debug_every == 0:
            self.dump_debug(img, np.asarray(grid), np.asarray(gmask))
        if self.loop_closure and self.count % self.keyframe_every == 0:
            self._keyframes[self.count] = (np.asarray(grid), np.asarray(gmask))
        with self.timer.stage("host_buckets"):
            # VO depth buckets built host-side (overlapped with the device's
            # previous frame under async dispatch), like the ring gridding
            from vloam_tpu.ops.depth_map import DepthBuckets
            from vloam_tpu.runtime import native

            flat = np.asarray(grid).reshape(-1, 4)
            fmask = np.asarray(gmask).reshape(-1)
            if native.available():
                bu, bv, bz, bc = native.depth_buckets_native(
                    flat, fmask, self._proj, cfg.visual
                )
            else:
                bu, bv, bz, bc = depth_buckets(flat, fmask, self._proj, cfg.visual)
            buckets = DepthBuckets(
                jnp.array(bu), jnp.array(bv), jnp.array(bz), jnp.array(bc)
            )
        with self.timer.stage("host_lf_voxel"):
            from vloam_tpu.data.gridding import less_flat_voxel_table

            if native.available():
                sg, bs, nr = native.lf_voxel_table_native(
                    np.asarray(grid), np.asarray(gmask), cfg.scan
                )
            else:
                sg, bs, nr = less_flat_voxel_table(
                    np.asarray(grid), np.asarray(gmask), cfg.scan
                )
            lf_table = (jnp.array(sg), jnp.array(bs), jnp.array(nr, jnp.int32))
        with self.timer.stage("vloam_step"):
            args = (jnp.array(img), jnp.array(grid), jnp.array(gmask), buckets, lf_table)
            if self._arg_shapes is None:      # shapes are fixed per config
                self._arg_shapes = jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), (self.state,) + args)
            self.state, out = self._step(self.state, *args)
            out.mo_pose.block_until_ready()
        if self.cfg.verbose_level >= 1 and self.count > 0:
            # degradation warning (laser_odometry.cpp:493-496: < 10
            # correspondences; the reference proceeds anyway, as do we)
            corr = np.asarray(out.lo_corr)
            if int(corr.sum()) < 10:
                print(
                    f"[warn] frame {self.count}: LO degraded — only "
                    f"{int(corr[0])} edge + {int(corr[1])} plane correspondences"
                )
        with self.timer.stage("host_f64_chain"):
            self._accumulate_f64(out)
        if self.writers:
            self.writers["vo"].append(self._export_row(self._w_vo64))
            self.writers["lo"].append(self._export_row(self._w_lo64))
            self.writers["mo"].append(self._export_row(self._w_mo64))
        if self.refine:
            self._world_hist.append(
                (self._w_vo64.copy(), self._w_lo64.copy(), self._w_mo64.copy())
            )
        self.count += 1
        if self.checkpoint_dir and self.checkpoint_every and self.count % self.checkpoint_every == 0:
            self.save_checkpoint()
        return out

    def step_memory_analysis(self):
        """``compiled.memory_analysis()`` of the jitted step at the shapes of
        the last processed frame."""
        return self._step.lower(*self._arg_shapes).compile().memory_analysis()

    def _accumulate_f64(self, out: VloamOutputs) -> None:
        """Rebase this frame's f32 device deltas onto the f64 host chains
        (module docstring; reference: Ceres doubles) and track the realised
        divergence of the in-jit f32 chains against them."""
        vo_d = np.asarray(out.vo_delta, np.float64)
        lo_d = np.asarray(out.lo_delta, np.float64)
        mo_c = np.asarray(out.mo_correction, np.float64)
        # mirror the in-jit NaN guard (frame_graph.accumulate_world)
        if np.all(np.isfinite(vo_d)):
            self._w_vo64 = gnp.pose_compose(self._w_vo64, gnp.as_pose64(vo_d))
        if np.all(np.isfinite(lo_d)):
            self._w_lo64 = gnp.pose_compose(self._w_lo64, gnp.as_pose64(lo_d))
        if np.all(np.isfinite(mo_c)):
            # world_MO = wmap_wodom o world_LO exactly (laser_mapping.py:453)
            self._w_mo64 = gnp.pose_compose(gnp.as_pose64(mo_c), self._w_lo64)
        if self._anchor64 is None:
            b = gnp.as_pose64(self.ext.base_T_cam0)
            self._anchor64 = gnp.pose_compose(
                gnp.pose_compose(gnp.pose_inverse(b), self._w_vo64), b
            )
        for key, w64, w32 in (
            ("vo", self._w_vo64, out.world_vo),
            ("lo", self._w_lo64, out.world_lo),
            ("mo", self._w_mo64, out.world_mo),
        ):
            d = float(np.linalg.norm(np.asarray(w32, np.float64)[4:] - w64[4:]))
            if d > self.f32_divergence_m[key]:
                self.f32_divergence_m[key] = d

    def _export_row(self, world64: np.ndarray) -> np.ndarray:
        """f64 KITTI trajectory row: cam0_start_T_cam0_curr
        (frame_graph.world_to_cam0_start on the host f64 chain)."""
        b = gnp.as_pose64(self.ext.base_T_cam0)
        cam = gnp.pose_compose(gnp.pose_compose(gnp.pose_inverse(b), world64), b)
        return gnp.pose_compose(gnp.pose_inverse(self._anchor64), cam)

    def _loop_factors(self, mo: np.ndarray):
        """Detect + register loop closures over the stored keyframes.

        Revisits are gated on the MO chain's keyframe positions; accepted
        registrations (parallel/loop_closure.register_loop) become
        relative-pose factors indexed into the full frame graph.  The gate
        requires real traveled path between the keyframes (index gap alone
        lets stopped segments register spurious 'revisits') and widens with
        distance traveled so detection survives accumulated drift on long
        loops (loop_closure.effective_radius)."""
        from vloam_tpu.ops.scan_registration import extract_features_from_grid
        from vloam_tpu.parallel.loop_closure import (
            detect_revisits, loop_factors, path_cumlen, register_loop,
        )

        kf_ids = sorted(self._keyframes)
        kf_ids = [i for i in kf_ids if i < len(mo)]
        if len(kf_ids) < 2:
            return None
        positions = np.stack([mo[i][4:] for i in kf_ids])
        cum = path_cumlen(positions)
        pairs_kf = detect_revisits(
            positions, min_gap=self.loop_min_gap, radius=self.loop_radius,
            min_spacing=2, min_travel=self.loop_min_travel,
            drift_rate=self.loop_drift_rate,
        )
        if not pairs_kf:
            return None

        feats_fn = jax.jit(
            lambda g, m: extract_features_from_grid(
                jnp.array(g), jnp.array(m),
                jnp.sum(jnp.array(m), axis=1).astype(jnp.int32), self.cfg.scan,
            )
        )
        feat_cache: dict[int, object] = {}

        def feats_of(fid):
            if fid not in feat_cache:
                g, m = self._keyframes[fid]
                feat_cache[fid] = feats_fn(g, m)
            return feat_cache[fid]

        accepted_pairs, zs, corrs = [], [], []
        for jk, kk in pairs_kf:
            fj, fk = kf_ids[jk], kf_ids[kk]
            rel_init = geo.pose_compose(
                geo.pose_inverse(jnp.array(mo[fj], jnp.float32)),
                jnp.array(mo[fk], jnp.float32),
            )
            z, n_tight, ok = register_loop(
                feats_of(fj), feats_of(fk), rel_init, self.cfg,
            )
            if self.cfg.verbose_level >= 1:
                print(f"[loop] frames ({fj},{fk}): tight_inliers={n_tight} "
                      f"accepted={ok}")
            if ok:
                accepted_pairs.append((fj, fk))
                zs.append(z)
                corrs.append(n_tight)
        if not accepted_pairs:
            return None
        # evidence weighting: information scales with the registration's
        # tight-inlier count (residual weight enters JtJ squared, hence
        # sqrt); normalised so a 600-inlier registration keeps the old 5.0
        w = 5.0 * np.sqrt(np.asarray(corrs, np.float64) / 600.0)
        return loop_factors(accepted_pairs, zs, weight=w)

    @staticmethod
    def _loop_resid_m(chain: np.ndarray, lf) -> float:
        """Mean translation residual (m) of loop factors evaluated on a
        chain: || (inv(chain[i]) o chain[j]).t - z.t || averaged."""
        i = np.asarray(lf.i)
        j = np.asarray(lf.j)
        z = np.asarray(lf.z)
        errs = [
            np.linalg.norm(
                gnp.pose_compose(
                    gnp.pose_inverse(gnp.as_pose64(chain[a])), gnp.as_pose64(chain[b])
                )[4:] - z[k][4:]
            )
            for k, (a, b) in enumerate(zip(i, j))
        ]
        return float(np.mean(errs))

    def refine_trajectory(
        self, w_mo: float = 1.0, w_lo: float = 0.2, w_vo: float = 0.05, iters: int = 8
    ) -> np.ndarray | None:
        """Pose-graph fusion over the whole sequence (the backend the
        reference lacks): the VO / LO / MO frame-to-frame motion estimates
        carry partially independent noise, so a relative-pose graph with the
        MO chain dominant smooths the trajectory.  Returns refined (W, 7)
        world poses (and writes ``MO{d}_refined.txt`` when exporting).

        Runs on host-collected poses (requires ``refine=True`` at
        construction).  The graph is a chain (up to 3 odometry chains over
        the same poses) plus a handful of loop factors, so the solve uses
        the structure-exploiting block-tridiagonal + Woodbury path
        (optimize_pose_graph_banded): O(W) per GN iteration, sub-second
        even at KITTI-00 scale (4500+ frames).
        """
        if self._refined is not None:
            return self._refined
        if len(self._world_hist) < 3:
            return None
        from vloam_tpu.parallel.pose_graph import (
            concat_factors, odometry_factors, optimize_pose_graph_banded,
        )

        hist = np.stack([np.stack(h) for h in self._world_hist])   # (W, 3, 7) f64
        vo, lo, mo = hist[:, 0], hist[:, 1], hist[:, 2]

        def chain_deltas(p):
            # deltas extracted on host in f64 (positions are km-scale; an
            # f32 inverse-compose there loses ~1e-4 m per link), then cast
            # to f32 — the deltas themselves are frame-scale and f32-safe
            d = [gnp.pose_compose(gnp.pose_inverse(p[i]), p[i + 1])
                 for i in range(len(p) - 1)]
            return jnp.array(np.stack(d), jnp.float32)

        def chain_path(p):
            return float(np.sum(np.linalg.norm(np.diff(p[:, 4:], axis=0), axis=1)))

        # lidar-only runs leave the VO chain parked at identity; fusing a
        # zero-motion chain would shrink every fused delta by roughly
        # w_vo/(w_mo+w_lo+w_vo) — drop chains that plainly didn't run
        mo_path = chain_path(mo)
        parts = [odometry_factors(chain_deltas(mo), weight=w_mo)]
        if chain_path(lo) > 0.05 * mo_path:
            parts.append(odometry_factors(chain_deltas(lo), weight=w_lo))
        if chain_path(vo) > 0.05 * mo_path:
            parts.append(odometry_factors(chain_deltas(vo), weight=w_vo))
        chain = concat_factors(*parts)
        lf = self._loop_factors(mo) if self._keyframes else None
        mo32 = jnp.array(mo, jnp.float32)
        refined = np.asarray(optimize_pose_graph_banded(mo32, chain, lf, iters=iters))

        # Interior-safety guard: loop factors constrain the
        # revisit gaps, not the interior shape — a bad registration bends
        # the interior without any observation saying so.  With >=2 loops,
        # cross-validate: refine with each half of the factor set and check
        # that the HELD-OUT half's residuals improve vs the raw chain.  If
        # they do not, the loop set is not self-consistent: fall back to
        # the raw chain and say so.
        self.refine_report: dict = {"loop_factors": 0, "fallback": False}
        if lf is not None:
            L = int(np.asarray(lf.i).shape[0])
            self.refine_report["loop_factors"] = L
            self.refine_report["loop_resid_raw_m"] = self._loop_resid_m(mo, lf)
            self.refine_report["loop_resid_refined_m"] = self._loop_resid_m(refined, lf)
            if L >= 2:
                from vloam_tpu.parallel.pose_graph import PoseGraphFactors

                def subset(parity):
                    sel = np.arange(L) % 2 == parity
                    return PoseGraphFactors(*[
                        jnp.array(np.asarray(f)[sel]) for f in lf
                    ])

                even, odd = subset(0), subset(1)
                ref_e = np.asarray(optimize_pose_graph_banded(mo32, chain, even, iters=iters))
                ref_o = np.asarray(optimize_pose_graph_banded(mo32, chain, odd, iters=iters))
                held_raw = 0.5 * (self._loop_resid_m(mo, odd) + self._loop_resid_m(mo, even))
                held_ref = 0.5 * (self._loop_resid_m(ref_e, odd) + self._loop_resid_m(ref_o, even))
                self.refine_report["heldout_raw_m"] = held_raw
                self.refine_report["heldout_refined_m"] = held_ref
                if held_ref > held_raw:
                    self.refine_report["fallback"] = True
                    if self.cfg.verbose_level >= 1:
                        print(
                            f"[loop] guard: held-out loop residual worsened "
                            f"({held_raw:.2f} -> {held_ref:.2f} m); keeping the "
                            "raw chain"
                        )
                    # keep the rejected solution for diagnostics/ablation
                    self._refined_unguarded = refined
                    refined = np.asarray(mo, np.float32).copy()

        if self.out_dir is not None:
            d = int(self.cfg.detach_vo_lo)
            path = os.path.join(self.out_dir, f"MO{d}_refined.txt")
            w = TrajectoryWriter(path)
            for p in refined:
                w.append(self._export_row(gnp.as_pose64(p)))
            w.close()
        self._refined = refined
        return refined

    def close(self):
        if self.refine:
            self.refine_trajectory()
        for w in self.writers.values():
            w.close()


def synthetic_frames(cfg: VloamConfig, ext: fg.Extrinsics, poses, n_azimuth: int = 900,
                     lidar_only: bool = False):
    """Yield (image or None, cloud) per pose of the synthetic raycast world:
    a lidar sweep of ``n_azimuth`` steps per ring and a camera image of a
    blob texture raycast once onto the world from the first pose."""
    boxes = synthetic.default_scene()
    K = np.asarray(ext.P_rect0)[:, :3].astype(np.float64)
    rng = np.random.default_rng(11)
    vc = cfg.visual
    uv0 = np.stack(
        [rng.uniform(20, vc.img_width - 20, 1400), rng.uniform(20, vc.img_height - 20, 1400)], -1
    )
    R_wc0 = poses[0][0] @ synthetic.CAM_R_WORLD.T
    pc0, hit = synthetic.raycast_camera(R_wc0, poses[0][1], boxes, K, uv0)
    blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]
    for i, (R, t) in enumerate(poses):
        cloud = synthetic.simulate_scan(R, t, boxes, n_azimuth=n_azimuth, noise=0.005, seed=i)
        img = None
        if not lidar_only:
            R_wc = R @ synthetic.CAM_R_WORLD.T
            img = synthetic.render_blob_image(
                (blob_world - t) @ R_wc, K, vc.img_height, vc.img_width)
        yield img, cloud


def run_synthetic(
    cfg: VloamConfig,
    n_frames: int = 10,
    speed: float = 0.8,
    yaw_rate: float = 0.005,
    out_dir: str | None = None,
    n_azimuth: int = 900,
    verbose: bool = True,
    lidar_only: bool = False,
    refine: bool = False,
    loop_closure: bool = False,
    keyframe_every: int = 10,
    loop_kw: dict | None = None,
    step_memory: bool = False,
):
    """Full-pipeline run on the synthetic raycast world.  Returns a dict of
    drift metrics vs the exact trajectory (our replacement for the
    reference's saved-rosbag smoke runs).  ``step_memory`` adds the jitted
    step's compiled memory analysis (bytes) under "step_memory"."""
    ext = fg.kitti_default_extrinsics()
    driver = VloamDriver(cfg, ext, out_dir, refine=refine,
                         loop_closure=loop_closure, keyframe_every=keyframe_every,
                         **(loop_kw or {}))
    poses = synthetic.straight_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate)
    outs, t_per_frame = [], []
    for i, (img, cloud) in enumerate(synthetic_frames(cfg, ext, poses, n_azimuth, lidar_only)):
        t = poses[i][1]
        t0 = time.perf_counter()
        out = driver.process(img, cloud)
        t_per_frame.append(time.perf_counter() - t0)
        outs.append(out)
        if verbose:
            mo = np.asarray(out.world_mo)[4:]
            print(
                f"frame {i:3d}  {t_per_frame[-1]*1e3:7.1f} ms  "
                f"MO err {np.linalg.norm(mo - t):.3f} m"
            )
    driver.close()

    gt_final = poses[-1][1]
    path_len = sum(np.linalg.norm(poses[i + 1][1] - poses[i][1]) for i in range(n_frames - 1))
    res = {
        "frames": n_frames,
        "path_len_m": float(path_len),
        "final_err_vo_m": float(np.linalg.norm(np.asarray(outs[-1].world_vo)[4:] - gt_final)),
        "final_err_lo_m": float(np.linalg.norm(np.asarray(outs[-1].world_lo)[4:] - gt_final)),
        "final_err_mo_m": float(np.linalg.norm(np.asarray(outs[-1].world_mo)[4:] - gt_final)),
        "steady_ms_per_frame": float(np.median(t_per_frame[2:]) * 1e3) if n_frames > 2 else None,
        "fps": float(1.0 / np.median(t_per_frame[2:])) if n_frames > 2 else None,
        "stage_ms": {k: driver.timer.mean_ms(k) for k in driver.timer.total_ms},
    }
    if step_memory:
        ma = driver.step_memory_analysis()
        res["step_memory"] = {
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes")
        }
    if refine and len(driver._world_hist) >= 3:
        refined = driver.refine_trajectory()
        if refined is not None:
            res["final_err_refined_m"] = float(np.linalg.norm(refined[-1][4:] - gt_final))
    if verbose:
        print(driver.timer.summary())
        for k, v in res.items():
            print(f"{k}: {v}")
    return res


def run_kitti(
    cfg: VloamConfig,
    sequence,                 # RawSequence | OdometrySequence
    out_dir: str | None = None,
    start: int = 0,
    end: int | None = None,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: str | None = None,
    debug_dir: str | None = None,
    debug_every: int = 0,
    refine: bool = False,
    loop_closure: bool = False,
    keyframe_every: int = 10,
    loop_kw: dict | None = None,
):
    """Run the pipeline over a real KITTI sequence (raw or odometry layout).

    Uses the native C++ prefetcher (vloam_tpu.runtime.native) when built so
    disk IO + PNG decode overlap device compute; falls back to the NumPy
    loaders otherwise."""
    from vloam_tpu.runtime import native

    ext = extrinsics_from_calib(sequence.calib)
    driver = VloamDriver(cfg, ext, out_dir,
                         checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                         debug_dir=debug_dir, debug_every=debug_every, refine=refine,
                         loop_closure=loop_closure, keyframe_every=keyframe_every,
                         **(loop_kw or {}))
    if resume:
        start = driver.restore_checkpoint(resume)
    end = len(sequence) if end is None else min(end, len(sequence))
    t_per_frame = []

    def frames():
        """Yields (image, grid, gmask) — ring gridding runs in the loader."""
        if native.available():
            import os

            bins = [os.path.join(sequence.velo_dir, f) for f in sequence.files[start:end]]
            imgs = None
            if sequence.with_images:
                imgs = [
                    os.path.join(sequence.img_dir, os.path.splitext(f)[0] + ".png")
                    for f in sequence.files[start:end]
                ]
            pf = native.NativePrefetcher(
                bins, imgs, cfg.scan.max_points,
                cfg.visual.img_height, cfg.visual.img_width,
                scan_cfg=cfg.scan,
            )
            for grid, gmask, _, img in pf.iter_grids():
                yield img, grid, gmask
            pf.close()
        else:
            for i in range(start, end):
                f = sequence.frame(i)
                grid, gmask, _ = grid_cloud(f.cloud, cfg.scan)
                yield f.image, grid, gmask

    for i, (img, grid, gmask) in enumerate(frames()):
        t0 = time.perf_counter()
        driver.process_grid(img, grid, gmask)
        t_per_frame.append(time.perf_counter() - t0)
        if verbose and i % 50 == 0:
            print(f"frame {start + i}  {t_per_frame[-1]*1e3:.1f} ms")
    driver.close()
    if verbose:
        print(driver.timer.summary())
    return {
        "frames": end - start,
        "steady_ms_per_frame": float(np.median(t_per_frame[2:]) * 1e3) if len(t_per_frame) > 2 else None,
    }
