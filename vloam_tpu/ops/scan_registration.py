"""LOAM feature extraction as fixed-shape, jit-once array programs.

Replaces the reference's ScanRegistration
(/root/reference/src/lidar_odometry_mapping/src/scan_registration.cpp:144-513):
NaN/min-range filtering, per-point ring ID from vertical angle, azimuth
relative-time, 11-point curvature, and the per-(ring x sector) greedy
edge/planar selection with +-5 neighbour suppression.

Re-design decisions:
  * The cloud lives on a dense ``(n_scans, ring_cap)`` grid — points keep
    their scan order inside each ring (one stable sort), so the curvature
    window and neighbour suppression become pure shifts along the ring axis.
  * The sequential "sort by curvature, pick greedily, suppress" loop becomes
    K masked-argmax rounds over all (ring, sector) cells at once — each round
    every sector picks its best eligible point and suppresses its reach.
    This preserves the reference's selection semantics (including the
    gap^2 > 0.05 suppression break) up to pick ordering across sector
    boundaries, which only matters within +-5 points of a boundary.
  * Selected indices land in fixed per-(ring, sector, round) slots, so the
    feature clouds have static shapes: sharp (R*S*2), less-sharp (R*S*20),
    flat (R*S*4), less-flat = voxel-downsampled remainder.

Feature points are (x, y, z, w) where w = ring + 0.1 * rel_time — the
reference's intensity encoding (scan_registration.cpp:294-297).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu.config import ScanConfig
from vloam_tpu.ops.voxel import voxel_downsample


class ScanFeatures(NamedTuple):
    """Fixed-shape feature clouds for one lidar frame (all xyzw)."""

    sharp: jax.Array          # (R*S*2, 4)
    sharp_mask: jax.Array     # (R*S*2,)
    less_sharp: jax.Array     # (R*S*20, 4)
    less_sharp_mask: jax.Array
    flat: jax.Array           # (R*S*4, 4)
    flat_mask: jax.Array
    less_flat: jax.Array      # (less_flat_cap, 4)
    less_flat_mask: jax.Array


def assign_rings(points: jax.Array, mask: jax.Array, cfg: ScanConfig) -> tuple[jax.Array, jax.Array]:
    """Vertical-angle -> ring ID per the reference's sensor formulas.

    Returns (ring (N,) int32, valid (N,) bool).  Semantics of
    scan_registration.cpp:217-254 (16/32/64-beam; C truncation-toward-zero).
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    horiz = jnp.sqrt(x * x + y * y)
    angle = jnp.degrees(jnp.arctan2(z, jnp.maximum(horiz, 1e-12)))

    if cfg.n_scans == 16:
        sid_f = (angle + 15.0) / 2.0 + 0.5
        sid = sid_f.astype(jnp.int32)  # trunc toward zero, like C int()
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 32:
        sid_f = (angle + 92.0 / 3.0) * 3.0 / 4.0
        sid = sid_f.astype(jnp.int32)
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 64:
        upper = ((2.0 - angle) * 3.0 + 0.5).astype(jnp.int32)
        lower = cfg.n_scans // 2 + ((-8.83 - angle) * 2.0 + 0.5).astype(jnp.int32)
        sid = jnp.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported n_scans={cfg.n_scans}")
    return sid, mask & ok


def relative_times(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Azimuth-based intra-scan relative time in [0, 1].

    Vectorised version of the startOri/endOri unwrap
    (scan_registration.cpp:185-294): rel = ((-atan2(y,x)) - startOri) mod 2pi,
    normalised by the (~2pi) sweep.  Exact for KITTI's azimuth-ordered scans.
    """
    ori = -jnp.arctan2(points[:, 1], points[:, 0])
    n = points.shape[0]
    idx = jnp.arange(n)
    first = jnp.argmax(mask)                       # first valid index
    last = n - 1 - jnp.argmax(mask[::-1])          # last valid index
    start = ori[first]
    end = ori[last] + 2.0 * jnp.pi
    end = jnp.where(end - start > 3.0 * jnp.pi, end - 2.0 * jnp.pi,
                    jnp.where(end - start < jnp.pi, end + 2.0 * jnp.pi, end))
    sweep = jnp.maximum(end - start, 1e-6)
    rel = jnp.mod(ori - start, 2.0 * jnp.pi) / sweep
    del idx
    return jnp.clip(rel, 0.0, 1.0)


def organize_scan(
    points: jax.Array, mask: jax.Array, cfg: ScanConfig
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Raw padded cloud -> dense ring grid.

    Returns (grid (R, C, 4) xyzw, grid_mask (R, C), n_per_ring (R,)).
    Points keep their original (scan) order within each ring; each ring's
    valid points occupy columns [0, n_r).
    """
    n = points.shape[0]
    r = jnp.sqrt(jnp.sum(points[:, :3] ** 2, axis=-1))
    mask = mask & (r >= cfg.minimum_range) & jnp.all(jnp.isfinite(points[:, :3]), axis=-1)

    ring, mask = assign_rings(points, mask, cfg)
    rel = relative_times(points, mask)
    w = ring.astype(jnp.float32) + cfg.scan_period * rel
    pts4 = jnp.concatenate([points[:, :3], w[:, None]], axis=1)

    # Rank within ring = number of earlier same-ring points; a one-hot cumsum
    # keeps scan order without any sort (the cloud is already azimuth-ordered).
    oh = (ring[:, None] == jnp.arange(cfg.n_scans, dtype=jnp.int32)[None, :]) & mask[:, None]
    before = jnp.cumsum(oh.astype(jnp.int32), axis=0) - oh.astype(jnp.int32)
    rank = jnp.take_along_axis(before, jnp.clip(ring, 0, cfg.n_scans - 1)[:, None], axis=1)[:, 0]

    ok = mask & (rank < cfg.ring_cap)
    flat_idx = jnp.where(ok, ring * cfg.ring_cap + rank, cfg.n_scans * cfg.ring_cap)
    grid = jnp.zeros((cfg.n_scans * cfg.ring_cap + 1, 4), jnp.float32).at[flat_idx].set(
        jnp.where(ok[:, None], pts4, 0.0), mode="drop", unique_indices=True
    )[:-1].reshape(cfg.n_scans, cfg.ring_cap, 4)
    gmask = jnp.zeros((cfg.n_scans * cfg.ring_cap + 1,), bool).at[flat_idx].set(
        ok, mode="drop", unique_indices=True
    )[:-1]
    gmask = gmask.reshape(cfg.n_scans, cfg.ring_cap)
    n_per_ring = jnp.sum(gmask, axis=1).astype(jnp.int32)
    return grid, gmask, n_per_ring


def ring_curvature(grid: jax.Array, n_per_ring: jax.Array, cfg: ScanConfig) -> tuple[jax.Array, jax.Array]:
    """11-point curvature per grid cell + selectability mask.

    curvature_i = || sum_{l=-5..5} p_{i+l} - 11 p_i ||^2 over in-ring
    neighbours (scan_registration.cpp:323-346); cells without 5 neighbours on
    both sides (the per-ring [start+5, end-6] margins) are unselectable.
    """
    xyz = grid[..., :3]
    w = cfg.curvature_window
    acc = -2.0 * w * xyz
    for l in range(1, w + 1):
        acc = acc + jnp.roll(xyz, l, axis=1) + jnp.roll(xyz, -l, axis=1)
    curv = jnp.sum(acc * acc, axis=-1)

    col = jnp.arange(grid.shape[1])[None, :]
    selectable = (col >= w) & (col <= n_per_ring[:, None] - w - 1)
    return curv, selectable


def unreliable_mask(grid: jax.Array, gmask: jax.Array, cfg: ScanConfig) -> jax.Array:
    """Original-LOAM occluded / parallel-beam point marking: (R, C) bool,
    True = do NOT select as a feature.

    The A-LOAM-derived reference dropped this stage; original LOAM
    (loam_velodyne scanRegistration.cpp, the cloudNeighborPicked pre-pass)
    marks two classes of sensor-relative artifacts before selection:

      * OCCLUSION silhouettes: consecutive ring points i, i+1 whose gap
        exceeds 0.1 m^2 AND that lie along nearly the same ray (the scaled
        difference < 0.1 of the nearer depth) are a foreground/background
        edge; the 6 points on the FARTHER side of the edge are marked —
        their position is a shadow of the foreground object and moves with
        the sensor, not the world.
      * PARALLEL (grazing) beams: a point whose gaps to BOTH ring
        neighbours exceed 0.0002 * depth^2 sits on a surface nearly
        parallel to the beam (distant grazing ground, cutoff arcs); its
        apparent geometry is dominated by the sampling, not the surface.

    All comparisons are pure shifts along the ring axis — the same
    fixed-shape formulation as curvature and suppression."""
    xyz = grid[..., :3]
    r = jnp.linalg.norm(xyz, axis=-1)
    nxt = jnp.roll(xyz, -1, axis=1)
    r_nxt = jnp.roll(r, -1, axis=1)
    pair_ok = gmask & jnp.roll(gmask, -1, axis=1)
    diff_next = jnp.sum((nxt - xyz) ** 2, axis=-1)

    # occlusion: gap > 0.1 and near-collinear rays (scanRegistration.cpp:
    # i farther -> mark i-5..i; i+1 farther -> mark i+1..i+6)
    big = pair_ok & (diff_next > 0.1)
    safe_rn = jnp.maximum(r_nxt, 1e-6)
    safe_r = jnp.maximum(r, 1e-6)
    d_far_i = jnp.linalg.norm(nxt * (r / safe_rn)[..., None] - xyz, axis=-1)
    d_far_n = jnp.linalg.norm(nxt - xyz * (r_nxt / safe_r)[..., None], axis=-1)
    # normalise by the FARTHER depth so the criterion is the pure angular
    # gate of loam_velodyne (scale farther point to nearer depth, divide by
    # nearer depth — algebraically identical to dividing these expressions,
    # which scale the nearer point up, by the farther depth); dividing by
    # the nearer depth instead made the gate stricter by farther/nearer and
    # let high-ratio occlusion edges escape at coarse azimuth sampling
    mark_back = big & (r > r_nxt) & (d_far_i / safe_r < 0.1)     # i-5..i
    mark_fwd = big & (r <= r_nxt) & (d_far_n / safe_rn < 0.1)    # i+1..i+6
    unrel = jnp.zeros(gmask.shape, bool)
    for l in range(6):
        unrel = unrel | jnp.roll(mark_back, -l, axis=1)          # edge at i+l
        unrel = unrel | jnp.roll(mark_fwd, l + 1, axis=1)        # edge at i-1-l

    # parallel beam: both neighbour gaps > 0.0002 * depth^2
    diff_prev = jnp.roll(diff_next, 1, axis=1)
    prev_ok = jnp.roll(pair_ok, 1, axis=1)
    thresh = 0.0002 * r * r
    unrel = unrel | (
        pair_ok & prev_ok & (diff_next > thresh) & (diff_prev > thresh)
    )
    return unrel


def _suppression_reach(grid: jax.Array, gmask: jax.Array, cfg: ScanConfig) -> tuple[jax.Array, jax.Array]:
    """Forward/backward suppression reach per cell.

    After picking point i the reference suppresses i+1..i+5 while consecutive
    gaps stay <= 0.05 (squared) and symmetrically backwards
    (scan_registration.cpp:406-429).  reach_fwd[i] = how many forward
    neighbours get suppressed; reach_bwd likewise.
    """
    xyz = grid[..., :3]
    nxt = jnp.roll(xyz, -1, axis=1)
    gap_ok = jnp.sum((nxt - xyz) ** 2, axis=-1) <= cfg.suppression_gap_sq  # gap between i and i+1
    gap_ok = gap_ok & gmask & jnp.roll(gmask, -1, axis=1)

    w = cfg.neighbor_suppression
    fwd = jnp.zeros(gap_ok.shape, jnp.int32)
    run = jnp.ones(gap_ok.shape, bool)
    for l in range(w):
        run = run & jnp.roll(gap_ok, -l, axis=1)
        fwd = fwd + run.astype(jnp.int32)
    prv_gap_ok = jnp.roll(gap_ok, 1, axis=1)  # gap between i-1 and i
    bwd = jnp.zeros(gap_ok.shape, jnp.int32)
    run = jnp.ones(gap_ok.shape, bool)
    for l in range(w):
        run = run & jnp.roll(prv_gap_ok, l, axis=1)
        bwd = bwd + run.astype(jnp.int32)
    return fwd, bwd


def extract_features(
    points: jax.Array, mask: jax.Array, cfg: ScanConfig
) -> ScanFeatures:
    """Full scan registration: raw padded cloud -> LOAM feature clouds."""
    grid, gmask, n_per_ring = organize_scan(points, mask, cfg)
    return extract_features_from_grid(grid, gmask, n_per_ring, cfg)


def extract_features_from_grid(
    grid: jax.Array,          # (R, C, 4) xyzw ring grid (see organize_scan)
    gmask: jax.Array,         # (R, C)
    n_per_ring: jax.Array,    # (R,) int32
    cfg: ScanConfig,
    lf_table=None,            # optional host voxel table (slot_grid, base_sums, n_runs)
) -> ScanFeatures:
    """Scan registration from a pre-built ring grid.

    The ring gridding itself (ring id, intra-scan time, rank within ring) is
    an O(N) sequential pass that the host data layer performs for free while
    the device is busy with the previous frame (data/gridding.py, native
    loader) — the device-side ``organize_scan`` stays as the self-contained
    fallback for raw padded clouds.

    ``lf_table`` (data/gridding.less_flat_voxel_table) likewise moves the
    less-flat voxel reduction's segment sums to the host: the device only
    scatter-subtracts the <= R*S*20 edge-labeled cells from their runs —
    ~0.1 ms instead of a 131k-row segment scatter.  Output slots of runs
    emptied by the subtraction stay masked holes (downstream consumers are
    mask-driven; the knn valid-length uses last-valid+1, not sum).
    """
    curv, selectable = ring_curvature(grid, n_per_ring, cfg)
    fwd, bwd = _suppression_reach(grid, gmask, cfg)

    R, C = gmask.shape
    S = cfg.n_sectors
    col = jnp.arange(C, dtype=jnp.int32)[None, :]

    # Sector id per cell: reference splits [start+5, end-6] into 6 equal index
    # ranges (scan_registration.cpp:358-361).  span = (end - start) indices.
    w = cfg.curvature_window
    span = jnp.maximum(n_per_ring[:, None] - 2 * w - 1, 1)  # scanEnd-scanStart
    sector = ((col - w) * S) // span
    sector = jnp.clip(sector, 0, S - 1)
    # Rings with < 6 usable points are skipped (scan_registration.cpp:355).
    ring_ok = (n_per_ring[:, None] - 2 * w - 1) >= 6
    selectable = selectable & gmask & ring_ok
    if cfg.exclude_unreliable:
        selectable = selectable & ~unreliable_mask(grid, gmask, cfg)

    sector_oh = sector[:, None, :] == jnp.arange(S, dtype=jnp.int32)[None, :, None]  # (R, S, C)

    neg_inf = jnp.float32(-jnp.inf)
    edge_thr = cfg.edge_threshold
    surf_thr = cfg.surf_threshold

    # --- candidate pre-reduction -------------------------------------------
    # At most 20 edge + 4 flat picks happen per sector and each pick suppresses
    # <= 11 neighbours, so the greedy loop only ever touches the ~top candidates
    # of each sector.  Reducing (R, S, C) to (R*S, NCAND) first makes each of
    # the 24 greedy rounds ~30x cheaper.  (Deviation from the full-row loop:
    # suppression no longer crosses sector boundaries — a +-5-point edge
    # effect, same order as the reference's sector-ordering asymmetry.)
    NCAND = 64
    RS = R * S
    ring_row = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)   # (RS,)

    # top_k returns descending order, which the greedy rounds rely on.
    _top = lambda s: jax.lax.top_k(s, NCAND)

    # Suppression reach rides in the score's 6 low mantissa bits (3 bits each
    # way; reach <= neighbor_suppression = 5), so the greedy rounds and the
    # edge->flat cross-suppression never gather from the (R, C) reach grids.
    # The perturbation is < 2^-17 relative, far below curvature noise.
    _RB = 3
    _RMASK = (1 << (2 * _RB)) - 1
    reach_bits = (fwd << _RB) | bwd                            # (R, C) int32

    def _pack(v):
        return jax.lax.bitcast_convert_type(
            (jax.lax.bitcast_convert_type(v, jnp.int32) & ~_RMASK) | reach_bits,
            jnp.float32,
        )

    def _unpack(v):
        bits = jax.lax.bitcast_convert_type(v, jnp.int32)
        return (bits >> _RB) & ((1 << _RB) - 1), bits & ((1 << _RB) - 1)

    score_e = jnp.where(
        (selectable & (curv > edge_thr))[:, None, :] & sector_oh,
        _pack(curv)[:, None, :], neg_inf,
    ).reshape(RS, C)
    ce_val, ce_col = _top(score_e)                             # (RS, 64) descending curvature
    score_f = jnp.where(
        (selectable & (curv < surf_thr))[:, None, :] & sector_oh,
        _pack(-curv)[:, None, :], neg_inf,
    ).reshape(RS, C)
    cf_val, cf_col = _top(score_f)                             # ascending curvature

    def greedy(vals, cols, n_rounds):
        """n_rounds of pick-best + suppress over the candidate axis."""
        def body(t, carry):
            sup, sel_col, sel_val, sel_f, sel_b = carry
            score = jnp.where(sup, neg_inf, vals)
            pick = jnp.argmax(score, axis=-1)                  # (RS,)
            v_sel = jnp.take_along_axis(score, pick[:, None], 1)[:, 0]
            has = v_sel > neg_inf
            col_sel = jnp.take_along_axis(cols, pick[:, None], 1)[:, 0]
            f_sel, b_sel = _unpack(v_sel)
            within = (cols >= (col_sel - b_sel)[:, None]) & (cols <= (col_sel + f_sel)[:, None])
            within = within | (cols == col_sel[:, None])
            sup = sup | (within & has[:, None])
            sel_col = sel_col.at[:, t].set(col_sel)
            sel_val = sel_val.at[:, t].set(has)
            sel_f = sel_f.at[:, t].set(f_sel)
            sel_b = sel_b.at[:, t].set(b_sel)
            return sup, sel_col, sel_val, sel_f, sel_b

        sup0 = jnp.zeros((RS, NCAND), bool)
        zi = jnp.zeros((RS, n_rounds), jnp.int32)
        _, sel_col, sel_val, sel_f, sel_b = jax.lax.fori_loop(
            0, n_rounds, body, (sup0, zi, jnp.zeros((RS, n_rounds), bool), zi, zi)
        )
        return sel_col, sel_val, sel_f, sel_b

    e_col, e_val, e_fr, e_br = greedy(ce_val, ce_col, cfg.max_less_sharp)

    # edge picks suppress flat candidates within their reach (the shared
    # cloudNeighborPicked array of the reference)
    cross = (
        (cf_col[:, :, None] >= (e_col - e_br)[:, None, :])
        & (cf_col[:, :, None] <= (e_col + e_fr)[:, None, :])
        & e_val[:, None, :]
    )
    cf_val = jnp.where(jnp.any(cross, axis=-1), neg_inf, cf_val)

    f_col, f_val, _, _ = greedy(cf_val, cf_col, cfg.max_flat)

    edge_slots = e_col.reshape(R, S, cfg.max_less_sharp)
    edge_valid = e_val.reshape(R, S, cfg.max_less_sharp)
    flat_slots = f_col.reshape(R, S, cfg.max_flat)
    flat_valid = f_val.reshape(R, S, cfg.max_flat)

    def gather_slots(slots, valid, k):
        idx = slots[:, :, :k].reshape(R, -1)                 # (R, S*k)
        v = valid[:, :, :k].reshape(R, -1)
        pts = jnp.take_along_axis(grid, idx[..., None], axis=1)
        pts = jnp.where(v[..., None], pts, 0.0)
        return pts.reshape(-1, 4), v.reshape(-1)

    sharp, sharp_mask = gather_slots(edge_slots, edge_valid, cfg.max_sharp)
    less_sharp, less_sharp_mask = gather_slots(edge_slots, edge_valid, cfg.max_less_sharp)
    flat, flat_mask = gather_slots(flat_slots, flat_valid, cfg.max_flat)

    # Less-flat: every valid point not labelled edge, voxel-downsampled per ring
    # (scan_registration.cpp:486-504).  Edge labels live in edge_slots.
    if lf_table is not None:
        # Host pre-reduced runs: subtract the edge-labeled cells (they are the
        # less-sharp gather positions, already fetched above) from their runs.
        slot_grid, base_sums, n_runs = lf_table
        cap = cfg.less_flat_cap
        e_cols = edge_slots.reshape(R, -1)                     # (R, S*20)
        e_ok = edge_valid.reshape(R, -1)
        slot_e = jnp.take_along_axis(slot_grid, e_cols, axis=1)  # (R, S*20)
        slot_e = jnp.where(e_ok & (slot_e >= 0), slot_e, cap).reshape(-1)
        aug_e = jnp.concatenate(
            [less_sharp, less_sharp_mask[:, None].astype(jnp.float32)], axis=1
        )
        sums = base_sums.at[slot_e].add(-aug_e, mode="drop")
        cnt = sums[:, 4]
        live = (jnp.arange(cap) < n_runs) & (cnt > 0.5)
        less_flat = jnp.where(
            live[:, None], sums[:, :4] / jnp.maximum(cnt, 1.0)[:, None], 0.0
        )
        less_flat_mask = live
    else:
        edge_lab = jnp.zeros((R, C + 1), bool).at[
            jnp.arange(R)[:, None], jnp.where(edge_valid, edge_slots, C).reshape(R, -1)
        ].set(True)[:, :C]
        lf_mask = gmask & ~edge_lab
        # ONE flat run-merge over all rings (PCL is called once per ring,
        # scan_registration.cpp:496-503; the ring group key reproduces that
        # separation): a single segment reduction over R*C points beats R
        # vmapped ones, and the compaction step disappears.
        ring_id = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None], (R, C))
        less_flat, less_flat_mask = voxel_downsample(
            grid.reshape(-1, 4), lf_mask.reshape(-1), cfg.less_flat_voxel,
            cfg.less_flat_cap, group_key=ring_id.reshape(-1), max_grid=1024,
            presorted=True,
        )

    return ScanFeatures(
        sharp, sharp_mask, less_sharp, less_sharp_mask, flat, flat_mask, less_flat, less_flat_mask
    )
