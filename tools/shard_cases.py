"""Run cases of ``tests/test_torch_sharded_step.py`` on another machine.

The port's side of ``tests/torch_shard_worker.py`` needs no JAX, so it can
run where the reference cannot (a machine with another torch).  Three
steps:

    python tools/shard_cases.py make DIR [NAME ...]
        (needs JAX) writes DIR/in.pkl, the named cases (all with no
        NAME), and runs the reference's worker into DIR/ref.pkl
    python tests/torch_shard_worker.py port DIR/in.pkl OUT.pkl PORT
        (no JAX) the port on 4 gloo ranks, there
    python tools/shard_cases.py check DIR OUT.pkl
        (needs JAX) each case of OUT.pkl against DIR/ref.pkl with the
        test module's checks and tolerances: prints "ok" or the failure,
        and the layouts the worker recorded; exits 1 if any case failed

Run from the repository root with ``PYTHONPATH=src``.
"""
import os
import pathlib
import pickle
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = ("embed_grad_partial", "decode_kv_local", "ssm_by_channel",
           "expert_blocks", "moe_dropped", "head_rows", "q_heads")


def _tests():
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_sharded_step as T
    return T


def make(out, names):
    T = _tests()
    out.mkdir(parents=True, exist_ok=True)
    cases = [c for c in list(T.train_cases()) + list(T.serve_cases())
             if not names or c["name"] in names]
    missing = set(names) - {c["name"] for c in cases}
    if missing:
        raise SystemExit(f"no such cases: {sorted(missing)}")
    with open(out / "in.pkl", "wb") as f:
        pickle.dump({"cases": cases}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_shard_worker.py"),
                    "ref", str(out / "in.pkl"), str(out / "ref.pkl")],
                   env=env, cwd=ROOT, check=True)
    print(f"{len(cases)} cases: {[c['name'] for c in cases]}")


def check(out, port_pkl) -> int:
    T = _tests()
    with open(out / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(port_pkl, "rb") as f:
        port = pickle.load(f)
    failed = 0
    for name, got in port.items():
        try:
            if "error" in got:
                raise AssertionError(got["error"].strip().splitlines()[-1])
            want = ref[name]
            if "losses" in want:
                T.check_train(want, got)
            else:
                results = {"ref": {name: want}, "port": {name: got}}
                T.test_serving_steps_match_reference(results, name)
            verdict = "ok"
        except AssertionError as e:
            failed += 1
            verdict = f"FAILED: {str(e)[:300]}"
        seen = {k: got[k] for k in RECORDS if got.get(k)}
        print(f"{name}: {verdict} ({got.get('seconds', 0):.1f} s) {seen}")
    return 1 if failed else 0


def main():
    mode, out = sys.argv[1], pathlib.Path(sys.argv[2])
    if mode == "make":
        make(out, sys.argv[3:])
    elif mode == "check":
        sys.exit(check(out, sys.argv[3]))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
