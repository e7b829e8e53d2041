"""Sweep driver: run every (arch x shape x mesh) dry-run cell in a fresh
subprocess (each cell gets its own ``fake`` process group; one bad cell
can't kill the sweep).  Writes per-cell JSON to --out, a summary line per
cell, and the cells that failed, with the end of their standard error, to
``<out>/_failures.json``.

Port of ``repro/launch/dryrun_all.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..configs import cells

SRC = str(Path(__file__).resolve().parents[2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--only", default="", help="substring filter arch__shape")
    ap.add_argument("--skip-done", action="store_true", default=True)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default=None,
                    help="passed to each cell (cuda unless cpu is asked for)")
    ap.add_argument("--save-hlo", action="store_true",
                    help="passed to each cell: its operators by name")
    args = ap.parse_args(argv)

    meshes = args.meshes.split(",")
    todo = []
    for arch, shape in cells():
        for mesh in meshes:
            stem = f"{arch}__{shape}__{mesh}"
            if args.only and args.only not in stem:
                continue
            if args.skip_done and os.path.exists(
                os.path.join(args.out, stem + ".json")
            ):
                print(f"[skip] {stem}")
                continue
            todo.append((arch, shape, mesh, stem))

    failures = []
    for i, (arch, shape, mesh, stem) in enumerate(todo):
        t0 = time.time()
        cmd = [
            sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", args.out,
        ] + (["--device", args.device] if args.device else []) + (
            ["--save-hlo"] if args.save_hlo else [])
        print(f"[{i+1}/{len(todo)}] {stem} ...", flush=True)
        try:
            p = subprocess.run(
                cmd, capture_output=True, text=True, timeout=args.timeout,
                env=dict(os.environ, PYTHONPATH=SRC),
            )
            ok = p.returncode == 0
        except subprocess.TimeoutExpired:
            ok, p = False, None
        dt = time.time() - t0
        if ok:
            print(f"    OK in {dt:.0f}s", flush=True)
        else:
            msg = (p.stderr[-2000:] if p else "TIMEOUT")
            failures.append({"cell": stem, "err": msg})
            print(f"    FAIL in {dt:.0f}s: {msg[-300:]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "_failures.json"), "w") as f:
        json.dump(failures, f, indent=1)
    print(f"done: {len(todo) - len(failures)}/{len(todo)} cells OK")


if __name__ == "__main__":
    main()
