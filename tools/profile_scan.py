"""Sub-profile of extract_features on the current accelerator."""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.ops import scan_registration as sr
from vloam_tpu.ops.voxel import voxel_downsample

cfg = kitti_hdl64().scan
rng = np.random.default_rng(0)
n = cfg.max_points
az = rng.uniform(-np.pi, np.pi, n)
el = np.radians(rng.uniform(-24.0, 1.9, n))
r = rng.uniform(5.5, 60.0, n)
pts = jnp.array(np.stack([r*np.cos(el)*np.cos(az), r*np.cos(el)*np.sin(az), r*np.sin(el)], -1).astype(np.float32))
mask = jnp.ones((n,), bool)

org_j = jax.jit(lambda p, m: sr.organize_scan(p, m, cfg))
grid, gmask, npr = org_j(pts, mask)
curv_j = jax.jit(lambda g, nr: sr.ring_curvature(g, nr, cfg))
sup_j = jax.jit(lambda g, m: sr._suppression_reach(g, m, cfg))
full_j = jax.jit(lambda p, m: sr.extract_features(p, m, cfg))
_ = full_j(pts, mask)

ring_out_cap = min(cfg.ring_cap, max(cfg.less_flat_cap // 64, 512))
vox_j = jax.jit(lambda g, m: jax.vmap(
    lambda gg, mm: voxel_downsample(gg, mm, cfg.less_flat_voxel, ring_out_cap, max_grid=1024, presorted=True))(g, m))
_ = vox_j(grid, gmask)

def timeit(name, fn, n_=20):
    small = lambda r: min(jax.tree.leaves(r), key=lambda a: a.size)
    r = fn(); np.asarray(small(r))
    t0 = time.perf_counter()
    for _ in range(n_):
        r = fn()
    np.asarray(small(r))  # force a (tiny) host fetch
    print(f"{name:28s} {(time.perf_counter()-t0)/n_*1000:8.2f} ms")

timeit("organize_scan", lambda: org_j(pts, mask))
timeit("ring_curvature", lambda: curv_j(grid, npr))
timeit("suppression_reach", lambda: sup_j(grid, gmask))
timeit("per-ring voxel (less flat)", lambda: vox_j(grid, gmask))
timeit("extract_features (full)", lambda: full_j(pts, mask))
