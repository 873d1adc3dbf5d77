"""Readings for the limit of a cell's comparison, in one process.

    python3 -m benchmark.calibrate --workload mag250k.sweep \
        --seeds 101 102 ... --seconds 10 --control 201 202 203

For each of ``--seeds``: one window of that seed's traffic at the cell's
own size, judged as a run judges it (the program's readings: the lower
end of the limit). For each of ``--control``: the seed's first request,
solved by the plain reference in float32 throughout in the program's
place and judged the same way (the control's readings: the upper end).
Prints one JSON line per reading. The set-up is shared, so these
windows are not measurements of speed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark import meshcheck
from benchmark.run import Cell
from benchmark.traffic import Traffic


def control(cell: Cell, seed: int) -> dict:
    """The float32 reference's answer to the seed's first request."""
    params = {**cell.params, **Traffic(cell.mix, seed).request(0)}
    mesh = cell.shared
    if mesh is None:
        mesh = cell.mesher.mesh_problem(cell.prob.build(params))
    ref = cell.prob.reference(params, mesh.nodes, mesh.elements,
                              mesh.element_labels)
    t = time.perf_counter()
    x32, steps = cell.prob.reference_solve(ref, dtype=np.float32)
    t32 = time.perf_counter() - t
    return {"control_seed": seed, "gap": cell.prob.judge(ref, x32),
            "newton_steps": steps, "seconds": t32,
            "mesh": meshcheck.check(cell.prob, params, mesh)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    cell.set_up()
    for seed in args.seeds:
        run = cell.window(seed, args.seconds, False)
        t = time.perf_counter()
        checks = cell.judge(run)
        print(json.dumps({"seed": seed, "correct": run.correct,
                          "requests": len(run.requests),
                          "judge_s": time.perf_counter() - t,
                          "checks": checks}), flush=True)
    for seed in args.control:
        print(json.dumps(control(cell, seed)), flush=True)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
