"""Every dot of an optimized HLO module, with its FLOPs per device.

    python tools/hlo_dots.py PROGRAM.hlo.txt [--top N] [--grep TEXT]

Reads the per-device program that the reference's dry run writes with
``--save-hlo`` (``python -m repro.launch.dryrun --arch ARCH --shape SHAPE
--mesh MESH --save-hlo --out DIR``: ``DIR/ARCH__SHAPE__MESH.hlo.txt``) and
prints each ``dot`` weighted by the trip counts of the loops around it
(2 x the result's elements x the contracting dimensions, the reference
cost model's rule), with its result and operand shapes and the JAX
operation it came from, largest first, then the sum.  ``--grep`` keeps
the dots whose line or operand shapes hold TEXT (a dimension, say).  For
comparing where the port's per-device products (``tools/mm_layouts.py``)
and the reference's differ.  Imports neither JAX nor either package.
"""
import argparse
import collections
import re

_SHAPE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_INSTR = re.compile(r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\(")
_COMP = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$")
_CALLS = re.compile(r"(?:calls=|to_apply=|condition=|body=|"
                    r"true_computation=|false_computation=)%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CONST = re.compile(r"constant\((-?\d+)\)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def _dims(type_str):
    m = _SHAPE.search(type_str or "")
    return [int(d) for d in m.group(2).split(",") if d] if m else []


def parse(text):
    """{computation: [(name, type, op, line)]} and the entry's name."""
    comps, cur, entry = {}, None, None
    for raw in text.splitlines():
        line = raw.strip()
        cm = _COMP.match(line)
        if cm and line.endswith("{"):
            cur = comps.setdefault(cm.group(2), [])
            entry = cm.group(2) if cm.group(1) else entry
            continue
        if line == "}":
            cur = None
            continue
        im = _INSTR.match(raw) if cur is not None else None
        if im:
            cur.append((im.group(2), im.group(3), im.group(4), line))
    return comps, entry


def _trip(cond):
    consts = {n: int(m.group(1)) for n, _, op, line in cond
              if op == "constant" and (m := _CONST.search(line))}
    for _, _, op, line in cond:
        if op == "compare" and ("direction=LT" in line
                                or "direction=GT" in line):
            m = _CONST.search(line)
            if m:
                return int(m.group(1))
            for n in re.findall(r"%([\w.\-]+)", line[line.index("("):]):
                if n in consts:
                    return consts[n]
    return None


def multipliers(comps, entry):
    """How many times each computation runs per step (loops weighted by
    their trip counts; 1 where a trip count cannot be read)."""
    mult = collections.defaultdict(float)
    mult[entry] = 1.0
    order, i = [entry], 0
    while i < len(order):
        name = order[i]
        i += 1
        for _, _, op, line in comps.get(name, ()):
            callees = _CALLS.findall(line)
            bm = _BRANCHES.search(line)
            if bm:
                callees += [s.strip().lstrip("%") for s in bm.group(1).split(",")]
            weights = {c: 1 for c in callees}
            if op == "while":
                body = re.search(r"body=%?([\w.\-]+)", line)
                cond = re.search(r"condition=%?([\w.\-]+)", line)
                tm = _TRIP.search(line)
                trip = int(tm.group(1)) if tm else (
                    _trip(comps.get(cond.group(1), ())) if cond else None) or 1
                weights = {c: trip for c in callees}
                if cond:
                    weights[cond.group(1)] = trip + 1
                if body:
                    weights[body.group(1)] = trip
            for c, w in weights.items():
                mult[c] += mult[name] * w
                if c not in order:
                    order.append(c)
    return mult


def dots(text):
    """[(FLOPs per step, count per step, result, lhs, rhs, op_name)]."""
    comps, entry = parse(text)
    types = {n: t for instrs in comps.values() for n, t, _, _ in instrs}
    mult = multipliers(comps, entry)
    rows = []
    for cname, instrs in comps.items():
        m = mult.get(cname, 0.0)
        for _, type_str, op, line in instrs:
            if op != "dot" or not m:
                continue
            args = line[line.index(" dot(") + 5:]
            names = re.findall(r"%([\w.\-]+)", args.split(")")[0])
            lhs = types.get(names[0], "") if names else ""
            rhs = types.get(names[1], "") if len(names) > 1 else ""
            mc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            ld, k = _dims(lhs), 1
            for c in (mc.group(1).split(",") if mc else ()):
                if c and int(c) < len(ld):
                    k *= ld[int(c)]
            out = 1
            for d in _dims(type_str):
                out *= d
            on = _OP_NAME.search(line)
            rows.append((2.0 * out * k * m, m, type_str.split("{")[0],
                         lhs.split("{")[0], rhs.split("{")[0],
                         on.group(1) if on else ""))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("hlo")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--grep", default="")
    a = ap.parse_args()
    with open(a.hlo) as f:
        rows = dots(f.read())
    total = sum(r[0] for r in rows)
    if a.grep:
        rows = [r for r in rows if any(a.grep in str(x) for x in r[2:])]
    rows.sort(key=lambda r: -r[0])
    for flops, m, out, lhs, rhs, op in rows[:a.top]:
        print(f"{flops:.4e}  x{m:<6g} {out} = dot({lhs}, {rhs})  {op}")
    print(f"{len(rows)} dots shown of FLOPs {sum(r[0] for r in rows):.6e}; "
          f"all dots {total:.6e} per device")


if __name__ == "__main__":
    main()
