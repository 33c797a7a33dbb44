"""Weak-scaling benchmark for distributed (cube-sharded) mapping.

North star (BASELINE.json): >=70% weak-scaling efficiency for distributed
mapping at >=2 hosts.  Weak scaling here means: per-shard work constant —
each shard owns a constant slice of the cube map and runs NN association
against a constant-size local candidate window, so total map capacity grows
linearly with the shard count while step time should stay flat.  The only
cross-shard traffic is the neighbour top-k merge: a butterfly ppermute
all-reduce whose per-device payload grows as O(log2 S) (power-of-two
meshes; see parallel/mapping_shard._merge_topk), not the O(S) of a flat
all_gather.  This harness reports the MEASURED per-device merge payload
bytes per frame at each S (merge_payload_bytes) alongside step times —
virtual-mesh step times at S>2 are oversubscription-dominated on small CPU
boxes and indicative only.

Run on real multi-device hardware as-is; with --virtual N it executes on a
virtual host-platform CPU mesh of N devices —
the efficiency numbers are then only indicative (virtual devices share
cores), but the harness, shardings, and collectives are identical.

Prints one JSON line per shard count plus a summary efficiency line:
  {"metric": "mapping_weak_scaling_eff_S", "value": ..., "vs_baseline": .../0.70}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force a virtual CPU mesh of this many devices")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--tiny", action="store_true",
                    help="shrunken map config (CPU/virtual-mesh smoke runs)")
    ap.add_argument("--out", default=None,
                    help="append results into this JSON file (e.g. "
                         "chiprun_out/scaling.json); existing keys are preserved")
    ap.add_argument("--ablate-merge", action="store_true",
                    help="ALSO time the collective-free twin at each S "
                         "(cross-shard top-k merge replaced by local "
                         "candidates) and report merge_ms = normal - "
                         "ablated, isolating the communication share from "
                         "oversubscription on virtual meshes")
    args = ap.parse_args()

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import numpy as np
    import jax

    if args.virtual:
        # override any platform set at interpreter startup before a backend
        # initializes, so the virtual host-platform device count takes effect
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from vloam_tpu import geometry as geo
    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.models.laser_mapping import init_map_state
    from vloam_tpu.parallel.mapping_shard import (
        make_sharded_step, map_state_specs, merge_payload_bytes,
    )

    devices = jax.devices()
    # Single real chip: still measure S=1 (the real-hardware anchor point for
    # the artifact); the multi-S efficiencies come from a --virtual run.

    cfg = kitti_hdl64()
    if args.tiny:
        import dataclasses

        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping,
            corner_cube_cap=128, surf_cube_cap=256,
            corner_stack_cap=512, surf_stack_cap=1024,
            submap_corner_cap=2048, submap_surf_cap=4096,
        ))
        args.queries = min(args.queries, 1024)
    rng = np.random.default_rng(0)
    n_q = args.queries
    corner_in = jnp.array(np.concatenate(
        [rng.normal(0, 30, (n_q, 3)), np.ones((n_q, 1))], -1).astype(np.float32))
    surf_in = jnp.array(np.concatenate(
        [rng.normal(0, 30, (n_q, 3)), np.ones((n_q, 1))], -1).astype(np.float32))
    cmask = jnp.ones((n_q,), bool)
    smask = jnp.ones((n_q,), bool)
    pose = geo.pose_identity()

    shard_counts = [s for s in (1, 2, 4, 8) if s <= len(devices)]
    times = {}
    times_ablated = {}
    payloads = {}
    for S in shard_counts:
        # weak scaling: the map GROWS with the fleet (grid_w x S) so every
        # shard owns a constant cube slice; per-frame scan work is constant
        import dataclasses

        cfg_s = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, grid_w=cfg.mapping.grid_w * S))
        mesh = Mesh(np.array(devices[:S]), ("map",))
        shardings = jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), map_state_specs("map")
        )

        def timed(step):
            state = init_map_state(cfg_s, n_shards=S, sharded=True)
            state = jax.tree.map(jax.device_put, state, shardings)
            # bootstrap: two steps populate cubes + compile
            state, _ = step(state, corner_in, cmask, surf_in, smask, pose)
            state, pw = step(state, corner_in, cmask, surf_in, smask, pose)
            np.asarray(pw)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, pw = step(state, corner_in, cmask, surf_in, smask, pose)
            np.asarray(pw)
            return (time.perf_counter() - t0) / args.steps * 1e3

        dt = timed(make_sharded_step(cfg_s, mesh))
        times[S] = dt
        if args.ablate_merge and S > 1:
            times_ablated[S] = timed(make_sharded_step(cfg_s, mesh, ablate_merge=True))
        # Per-device collective bytes received per frame: one merge per
        # feature type per outer iteration (mapping_shard.optimize).
        mc = cfg_s.mapping
        payload = mc.outer_iters * (
            merge_payload_bytes(S, mc.corner_stack_cap, mc.n_neighbors)
            + merge_payload_bytes(S, mc.surf_stack_cap, mc.n_neighbors)
        )
        payloads[S] = payload
        entry = {
            "metric": f"mapping_sharded_step_ms_S{S}", "value": round(dt, 3),
            "unit": "ms",
            "merge_payload_bytes_per_frame": payload,
        }
        if S in times_ablated:
            entry["ablated_ms"] = round(times_ablated[S], 3)
            entry["merge_ms"] = round(dt - times_ablated[S], 3)
        print(json.dumps(entry))

    base = times[shard_counts[0]]
    effs = {}
    for S in shard_counts[1:]:
        eff = base / times[S]
        effs[S] = eff
        print(json.dumps({
            "metric": f"mapping_weak_scaling_eff_S{S}", "value": round(eff, 3),
            "unit": "ratio", "vs_baseline": round(eff / 0.70, 3),
        }))

    if args.out:
        path = args.out
        record = {}
        if os.path.exists(path):
            with open(path) as f:
                record = json.load(f)
        backend = jax.default_backend()
        key = (
            f"virtual_cpu_{args.virtual}dev" if args.virtual else f"real_{backend}"
        )
        record[key] = {
            "indicative_only": bool(args.virtual),
            "note": (
                "virtual host-platform devices share the CPU cores: step times "
                "inflate with S but the shardings/collectives are the real "
                "program" if args.virtual else
                "real hardware; single chip measures the S=1 anchor"
            ),
            "queries_per_step": args.queries,
            "tiny_config": bool(args.tiny),
            "step_ms": {str(s): round(t, 3) for s, t in times.items()},
            "ablated_step_ms": {str(s): round(t, 3) for s, t in times_ablated.items()},
            "merge_ms": {str(s): round(times[s] - t, 3) for s, t in times_ablated.items()},
            "weak_scaling_efficiency": {str(s): round(e, 3) for s, e in effs.items()},
            "merge_payload_bytes_per_frame": {str(s): p for s, p in payloads.items()},
        }
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
