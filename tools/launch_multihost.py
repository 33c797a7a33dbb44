"""Multi-host launcher: N processes over loopback, a CPU rehearsal of a multi-host job.

Spawns ``--procs`` local processes, each registering with a jax.distributed
coordinator and owning 4 virtual CPU devices; the sharded mapping step runs
over the GLOBAL mesh, so its all_gather/psum collectives cross the process
boundary the same way they would cross the network between hosts.  Process
0 writes the agreement record (default chiprun_out/multihost.json).

Usage:  python tools/launch_multihost.py [--procs 2] [--out chiprun_out/multihost.json]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/multihost.json")
    ap.add_argument("--timeout", type=int, default=480)
    args = ap.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tools", "multihost_worker.py")
    coordinator = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, str(args.procs), str(i),
             os.path.join(root, args.out)],
            env=env,
        )
        for i in range(args.procs)
    ]
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=args.timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()  # exact PIDs we spawned
        print("TIMEOUT")
        return 1
    if any(rcs):
        print(f"FAIL rcs={rcs}")
        return 1
    print(f"OK ({args.procs} processes) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
