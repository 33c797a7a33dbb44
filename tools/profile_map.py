"""Sub-profile of mapping_step internals on the current accelerator."""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.config import kitti_hdl64
from vloam_tpu import geometry as geo
from vloam_tpu.models.laser_mapping import (
    init_map_state, mapping_step, _gather_submap, _submap_coords,
    _corner_correspondences, _surf_correspondences, _scatter_insert_pair, cube_coord_of,
)
from vloam_tpu.ops.voxel import voxel_downsample
from vloam_tpu.ops.knn import knn, nn1

cfg = kitti_hdl64()
mc = cfg.mapping
rng = np.random.default_rng(0)

# plausible scan-like feature clouds
n_c, n_s = 32768, 32768
corner_in = jnp.array(np.concatenate([rng.normal(0, 30, (n_c, 3)), np.ones((n_c, 1))], -1).astype(np.float32))
surf_in = jnp.array(np.concatenate([rng.normal(0, 30, (n_s, 3)), np.ones((n_s, 1))], -1).astype(np.float32))
c_in_mask = jnp.array(rng.random(n_c) < 0.15)
s_in_mask = jnp.ones((n_s,), bool)

state = init_map_state(cfg)
pose = geo.pose_identity()

step_j = jax.jit(lambda st, ci, cm, si, sm, p: mapping_step(st, ci, cm, si, sm, p, cfg))
state, _ = step_j(state, corner_in, c_in_mask, surf_in, s_in_mask, pose)
state, _ = step_j(state, corner_in, c_in_mask, surf_in, s_in_mask, pose)
jax.block_until_ready(state)

vox_c = jax.jit(lambda p, m: voxel_downsample(p, m, mc.line_resolution, mc.corner_stack_cap, max_grid=1024, presorted=True))
vox_s = jax.jit(lambda p, m: voxel_downsample(p, m, mc.plane_resolution, mc.surf_stack_cap, max_grid=512, presorted=True))
corner_stack, cs_mask = vox_c(corner_in, c_in_mask)
surf_stack, ss_mask = vox_s(surf_in, s_in_mask)

gather_j = jax.jit(lambda st, p: _gather_submap(st, _submap_coords(cube_coord_of(geo.pose_t(p)[None, :], mc.cube_size)[0], cfg), cfg))
(c_pts, c_mask), (s_pts, s_mask), slots, fresh = gather_j(state, pose)
print("submap occupancy: corner", int(c_mask.sum()), "surf", int(s_mask.sum()))

cc_j = jax.jit(lambda p: _corner_correspondences(p, corner_stack, cs_mask, c_pts, c_mask, cfg))
sc_j = jax.jit(lambda p: _surf_correspondences(p, surf_stack, ss_mask, s_pts, s_mask, cfg))
knn_c_j = jax.jit(lambda q: knn(q, c_pts[:, :3], c_mask, mc.n_neighbors))
knn_s_j = jax.jit(lambda q: knn(q, s_pts[:, :3], s_mask, mc.n_neighbors))
nn1_j = jax.jit(lambda q: nn1(q, s_pts[:, :3], s_mask))
ins_j = jax.jit(lambda p, m: _scatter_insert_pair(p, m, surf_stack, ss_mask, state.cube_pts, state.corner_cnt, state.surf_cnt, state.cube_coord, cfg))

_ = cc_j(pose); _ = sc_j(pose); _ = knn_c_j(corner_stack[:, :3]); _ = knn_s_j(surf_stack[:, :3]); _ = nn1_j(surf_stack[:, :3]); _ = ins_j(corner_stack, cs_mask)

def timeit(name, fn, n_=20):
    small = lambda r: min(jax.tree.leaves(r), key=lambda a: a.size)
    r = fn(); np.asarray(small(r))
    t0 = time.perf_counter()
    for _ in range(n_):
        r = fn()
    np.asarray(small(r))  # force a (tiny) host fetch
    print(f"{name:28s} {(time.perf_counter()-t0)/n_*1000:8.2f} ms")

timeit("voxel corner in", lambda: vox_c(corner_in, c_in_mask))
timeit("voxel surf in", lambda: vox_s(surf_in, s_in_mask))
timeit("gather submap", lambda: gather_j(state, pose))
timeit("knn corner (4096x32768)", lambda: knn_c_j(corner_stack[:, :3]))
timeit("knn surf (8192x65536)", lambda: knn_s_j(surf_stack[:, :3]))
timeit("corner corr (knn+fit)", lambda: cc_j(pose))
timeit("surf corr (knn+fit)", lambda: sc_j(pose))
timeit("nn1 surf (dedup gate)", lambda: nn1_j(surf_stack[:, :3]))
timeit("scatter insert pair", lambda: ins_j(corner_stack, cs_mask))
timeit("full mapping_step", lambda: step_j(state, corner_in, c_in_mask, surf_in, s_in_mask, pose), n_=10)
