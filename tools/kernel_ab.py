"""Before/after device times of the single-request move and place kernels,
on one card in one call.

    python3 tools/kernel_ab.py --parent DIR

DIR holds an unpacked earlier commit of this repository (for example
``git archive <commit> | tar -x -C build/parent``) whose port has the same
wrappers (``kernels/minplus/minplus.py::masked_minplus_cuda`` and
``kernels/place/place.py::place_window_cuda``).  The parent's package is
imported under another name and runs its own wrappers, which build its own
kernels.  Both versions are checked bitwise against each other and timed in
turns (parent, this, this, parent) in ``chip_smoke.py``'s CUDA-graph
harness at the shapes ``chip_smoke.py`` times.  Prints one line per shape
with the card's name and power limit, and writes the numbers to
``results/kernel_ab.json``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.minplus import minplus as tm  # noqa: E402
from repro_torch.kernels.place import place as tp  # noqa: E402
from torch_kernel_cases import minplus_block, place_instance  # noqa: E402


def parent_wrappers(parent: Path):
    """The parent's ``repro_torch`` (its imports are relative) imported as
    ``parent_repro_torch``: its move and place wrappers."""
    pkg = parent / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    move = importlib.import_module("parent_repro_torch.kernels.minplus.minplus")
    place = importlib.import_module("parent_repro_torch.kernels.place.place")
    return move.masked_minplus_cuda, place.place_window_cuda


def in_turns(old, new, args, flush=None):
    """Parent, this, this, parent: the mean of each side's two times."""
    def t(fn):
        if flush is None:
            return cs.graph_ms(lambda: fn(*args))
        return cs.cold_ms(lambda: fn(*args), flush)

    a0, b0, b1, a1 = t(old), t(new), t(new), t(old)
    return dict(parent_ms=(a0 + a1) / 2, ms=(b0 + b1) / 2,
                parent_runs=[a0, a1], runs=[b0, b1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    tag = cs.card()
    print(tag)
    old_move, old_place = parent_wrappers(args.parent)
    floor = cs.empty_floor(ROOT, tag)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    rows = []
    K = cs.P + 1
    for n_v, n_w, cold in ((1024, 1024, False), (1024, 1024, True),
                           (1024, 512, False), (1024, 256, False),
                           (4096, 4096, False), (4096, 4096, True)):
        a = cs.on_card(minplus_block(n_v, n_w, K, n_w + n_v))
        cs.assert_same(old_move(*a), tm.masked_minplus_cuda(*a), "parent")
        r = in_turns(old_move, tm.masked_minplus_cuda, a,
                     flush if cold else None)
        nbytes, ops = cs.minplus_cost(n_v, n_w, K)
        r.update(kernel="masked_minplus", shape=[n_v, n_w, K],
                 l2="cold" if cold else "warm",
                 bound_ms=1e3 * max(nbytes / cs.HBM_BYTES_S,
                                    ops / cs.LANE_OPS_S))
        rows.append(r)
    del flush
    for n, k in ((1024, K), (4096, K), (2**20, K), (2**20, 33)):
        a = cs.on_card(place_instance(n, k, n + k))
        cs.assert_same(old_place(*a), tp.place_window_cuda(*a), "parent")
        r = in_turns(old_place, tp.place_window_cuda, a)
        nbytes, ops = cs.place_cost(n, k)
        r.update(kernel="place_window", shape=[n, k], l2="warm",
                 bound_ms=1e3 * max(nbytes / cs.HBM_BYTES_S,
                                    ops / cs.LANE_OPS_S))
        rows.append(r)
    for r in rows:
        print(f"[{tag}] {r['kernel']} {r['shape']} L2 {r['l2']}: parent "
              f"{r['parent_ms']:.5f} ms {r['parent_runs']}, this "
              f"{r['ms']:.5f} ms {r['runs']}; bound {r['bound_ms']:.5f} ms; "
              f"empty-kernel floor {floor:.5f} ms")
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        dict(card=tag, empty_kernel_ms=floor, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
