"""Step time and device-trace breakdown of the production step on the GPU,
with the fused k-NN kernel and with the plain XLA k-NN path.

Runs the same jitted step as bench.py (``kitti_hdl64()``, 1800-azimuth
synthetic sweeps, pre-gridded host inputs).  For each k-NN mode it times
the step over the same frames from the same initial state, in turns
(plain, kernel, kernel, plain), then traces a short window per mode and
reduces the GPU device planes of the ``.xplane.pb`` to:

  * device busy time per step and the idle share of the window;
  * time per stage named scope (visual_odometry, scan_registration,
    laser_odometry, laser_mapping) and per op family scope (knn,
    gauss_newton, patch_gather), attributed through the compiled HLO's
    op_name metadata;
  * the top kernels by device time.

    python tools/profile_trace.py [--frames 20] [--trace-steps 8] [--dump]

Writes the full report to chiprun_out/profile_trace.json.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("visual_odometry", "scan_registration", "laser_odometry", "laser_mapping")
FAMILIES = ("knn", "gauss_newton", "patch_gather")
N_WARMUP = 4
_META = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]+)"')
_CALLS = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?calls=%?([\w.\-]+)')
_COMP = re.compile(r'^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$')


def hlo_scopes(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> the named-scope paths it carries: its own
    op_name metadata and, for a fusion or call, that of every instruction
    in the computation it calls (space-separated)."""
    own, calls, inside = {}, {}, collections.defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace():
            m = _COMP.match(line)
            comp = m.group(1) if m else None
            continue
        m = _META.match(line)
        if m:
            own[m.group(1)] = m.group(2)
            if comp:
                inside[comp].append(m.group(2))
        m = _CALLS.match(line)
        if m:
            calls[m.group(1)] = m.group(2)
    return {name: " ".join([own.get(name, "")] + inside.get(calls.get(name), []))
            for name in set(own) | set(calls)}


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def scope_lookup(scopes: dict[str, str]):
    """Event -> named-scope path.  Kernels launched inside an XLA command
    buffer carry hlo_op "command_buffer"; their kernel name is the HLO
    instruction name with "." written "_" (``loop_select_fusion_23`` for
    ``loop_select_fusion.23``), sometimes with one more "_N" suffix
    (``sort_151_1``)."""
    norm = {_norm(k): v for k, v in scopes.items()}

    def find(name: str, hlo_op: str) -> str:
        if hlo_op in scopes:
            return scopes[hlo_op]
        n = _norm(name)
        if n in norm:
            return norm[n]
        return norm.get(re.sub(r"_\d+$", "", n), "")

    return find


def device_events(xplane_path: str):
    """(start_ns, dur_ns, kernel name, hlo_op) of every op event on the GPU
    device planes.  Only the per-op lines are kept: module and step lines
    span the ops inside them."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    evs = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Modules" in line.name or "Step" in line.name or "Launch" in line.name:
                continue
            for ev in line.events:
                st = dict(ev.stats)
                evs.append((ev.start_ns, ev.duration_ns, ev.name,
                            str(st.get("hlo_op", ev.name)), line.name))
    return evs


def busy_ns(evs) -> float:
    """Length of the union of the event intervals."""
    total, end = 0.0, -1.0
    for s, d, *_ in sorted(evs):
        if s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def reduce_trace(xplane_path: str, scopes: dict[str, str], n_steps: int,
                 window_ns: float, top: int = 25) -> dict:
    evs = device_events(xplane_path)
    total = sum(d for _, d, *_ in evs)
    by_stage, by_family = collections.Counter(), collections.Counter()
    by_kernel = collections.Counter()
    find = scope_lookup(scopes)
    for _, d, name, hlo_op, _ in evs:
        path = find(name, hlo_op)
        stage = next((s for s in STAGES if f"/{s}/" in f"/{path}/"), "other")
        by_stage[stage] += d
        fam = next((f for f in FAMILIES if f"/{f}/" in f"/{path}/" or f in name), None)
        if fam:
            by_family[fam] += d
        by_kernel[name] += d
    busy = busy_ns(evs)
    ms = lambda ns: ns / 1e6 / n_steps  # noqa: E731
    return {
        "device_ops_ms_per_step": ms(total),
        "device_busy_ms_per_step": ms(busy),
        "idle_share": 1.0 - busy / window_ns if window_ns else None,
        "stage_ms_per_step": {k: ms(v) for k, v in by_stage.most_common()},
        "family_ms_per_step": {k: ms(v) for k, v in by_family.most_common()},
        "family_share_of_ops": {k: v / total for k, v in by_family.most_common()} if total else {},
        "top_kernels_ms_per_step": {k: ms(v) for k, v in by_kernel.most_common(top)},
        "n_events": len(evs),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20, help="timed frames per turn")
    ap.add_argument("--trace-steps", type=int, default=8)
    ap.add_argument("--dump", action="store_true",
                    help="print a sample of raw device events (to read a trace by hand)")
    ap.add_argument("--keep", action="store_true",
                    help="keep each trace and its compiled HLO text (gzip) under "
                         "chiprun_out/trace_<mode>_*/ for offline reduction")
    args = ap.parse_args()

    import shutil

    import jax

    import bench
    from vloam_tpu.config import kitti_hdl64
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu.ops.knn import knn_mode
    from vloam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_trace: no GPU found")
    cfg = kitti_hdl64()
    ext = fg.kitti_default_extrinsics()
    frames, _ = bench._gen_frames(cfg, ext, n_frames=N_WARMUP + args.frames)

    steps, hlo = {}, {}
    for mode in ("plain", "kernel"):
        with knn_mode(mode):
            f = jax.jit(lambda s, i, c, m, b, t: vloam_step(
                s, i, c, m, ext, cfg, pre_gridded=True, pre_buckets=b, pre_lf_table=t),
                donate_argnums=0)
            t0 = time.perf_counter()
            lowered = f.lower(init_vloam_state(cfg), *frames[0])
            compiled = lowered.compile()
            hlo[mode] = (compiled.as_text(), time.perf_counter() - t0)
            steps[mode] = compiled

    def turn(mode):
        state = init_vloam_state(cfg)
        for fr in frames[:N_WARMUP]:
            state, out = steps[mode](state, *fr)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for fr in frames[N_WARMUP:]:
            state, out = steps[mode](state, *fr)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.frames * 1e3, state

    times = collections.defaultdict(list)
    for mode in ("plain", "kernel", "kernel", "plain"):
        ms, _ = turn(mode)
        times[mode].append(ms)
        print(f"step [{mode}] {ms:.3f} ms/frame over {args.frames} frames")

    report = {"card_ms_per_frame": dict(times),
              "compile_s": {m: hlo[m][1] for m in hlo}}
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for mode in ("plain", "kernel"):
        state = init_vloam_state(cfg)
        for fr in frames[:N_WARMUP]:
            state, out = steps[mode](state, *fr)
        jax.block_until_ready(out)
        tdir = tempfile.mkdtemp(prefix=f"trace_{mode}_", dir=out_dir)
        with jax.profiler.trace(tdir):
            t0 = time.perf_counter_ns()
            for fr in frames[N_WARMUP:N_WARMUP + args.trace_steps]:
                state, out = steps[mode](state, *fr)
            jax.block_until_ready(out)
            window = time.perf_counter_ns() - t0
        path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True)[0]
        if args.dump and mode == "kernel":
            for ev in device_events(path)[:40]:
                print("event", ev)
        r = reduce_trace(path, hlo_scopes(hlo[mode][0]), args.trace_steps, window)
        r["window_ms_per_step"] = window / 1e6 / args.trace_steps
        report[f"trace_{mode}"] = r
        if args.keep:
            with gzip.open(os.path.join(tdir, "hlo.txt.gz"), "wt") as fh:
                fh.write(hlo[mode][0])
        else:
            shutil.rmtree(tdir, ignore_errors=True)
        print(f"trace [{mode}]: " + json.dumps({k: r[k] for k in (
            "device_busy_ms_per_step", "idle_share", "stage_ms_per_step",
            "family_ms_per_step")}))
    with open(os.path.join(out_dir, "profile_trace.json"), "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
