"""Command-line driver: ``python -m xfemm_tpu_torch <command> <file>``.

Covers the reference's fmesher/fsolver/hsolver/esolver binaries in one
entry point (their CLI surface: take a problem file, mesh and/or solve,
write the solution next to it -- cfemm/fsolver/main.cpp:40,
cfemm/fmesher/main.cpp:38-57):

    python -m xfemm_tpu_torch mesh  problem.fem        # .node/.ele/.edge/.pbc
    python -m xfemm_tpu_torch solve problem.fem        # -> problem.ans
    python -m xfemm_tpu_torch solve problem.feh        # -> problem.anh
    python -m xfemm_tpu_torch solve problem.fee        # -> problem.res
    python -m xfemm_tpu_torch script femmcli_script.lua

``solve`` and ``script`` run on the CUDA card unless ``--device`` names
another device (``--device cpu`` runs the kernels' plain PyTorch
versions and needs ``--hbm-bytes``, the memory the band planner plans
against); without a card and without ``--device cpu`` they fail.
The JAX package's ``--devices N`` (domain decomposition) is not ported
yet (ROADMAP A.6).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _load(path: str):
    from .geometry import femfile
    return femfile.load(path)


def _mesh(problem, base: str, write: bool):
    from .mesh import mesher
    from .mesh.meshdata import write_mesh_files
    mesh = mesher.mesh_problem(problem)
    if write:
        write_mesh_files(mesh, base)
    return mesh


def cmd_mesh(args) -> int:
    base = os.path.splitext(args.file)[0]
    problem = _load(args.file)
    t0 = time.time()
    mesh = _mesh(problem, base, write=True)
    print(f"meshed {mesh.num_nodes} nodes / {mesh.num_elements} elements "
          f"in {time.time() - t0:.2f}s -> {base}.node/.ele/.edge/.pbc")
    return 0


def cmd_solve(args) -> int:
    from .constants import FileType
    from .io import ansfile
    from .mesh.meshdata import read_mesh_files
    from . import models

    base = os.path.splitext(args.file)[0]
    problem = _load(args.file)
    if args.premeshed:
        mesh = read_mesh_files(base)
    else:
        mesh = _mesh(problem, base, write=False)
    print(f"solving {mesh.num_nodes} nodes ...")
    t0 = time.time()
    sol = models.solve(problem, mesh, device=args.device,
                       hbm_bytes=args.hbm_bytes)
    elapsed = time.time() - t0

    if problem.filetype == FileType.MAGNETICS:
        out = base + ".ans"
        sf = ansfile.SolutionFile(
            problem=problem,
            mesh=ansfile.solution_mesh_from_solver(mesh, 1.0),
            values=sol.A, label_case=sol.label_case)
        ansfile.write_ans(sf, out)
    elif problem.filetype == FileType.HEATFLOW:
        out = base + ".anh"
        ansfile.write_scalar_solution(
            problem, mesh, sol.T, sol.node_Q,
            list(zip(sol.conductor_V, sol.conductor_q)), out)
    else:
        out = base + ".res"
        ansfile.write_scalar_solution(
            problem, mesh, sol.V, sol.node_Q,
            list(zip(sol.conductor_V, sol.conductor_q)), out)
    print(f"solved in {elapsed:.2f}s (residual {sol.residual:.2e}, "
          f"{sol.iterations} CG iterations) -> {out}")
    return 0


def cmd_script(args) -> int:
    from .scripting import lua
    kw = dict(trace_calls=getattr(args, "lua_trace_functions", False),
              pedantic=getattr(args, "lua_pedantic_mode", False),
              device=args.device, hbm_bytes=args.hbm_bytes)
    if getattr(args, "quiet", False):
        kw["output"] = lambda s: None
    try:
        if getattr(args, "lua_init", None):
            # run the init script in the same interpreter, then the
            # main script (femmcli --lua-init, main.cpp:150)
            interp = lua.Interpreter(script_path=args.lua_init, **kw)
            with open(args.lua_init) as f:
                interp.run(f.read())
            interp.script_path = args.file
            with open(args.file) as f:
                interp.run(f.read())
        else:
            lua.run_file(args.file, **kw)
    except lua.LuaError as e:
        print(f"lua error: {e}", file=sys.stderr)
        return 1
    return 0


def _device_args(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the solves (default: cuda; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--hbm-bytes", type=float, default=None,
                   help="device memory in bytes the band planner plans "
                        "against (read from the card on CUDA; needed "
                        "with --device cpu)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xfemm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("mesh", help="triangulate a problem file")
    mp.add_argument("file")
    mp.set_defaults(fn=cmd_mesh)
    spp = sub.add_parser("solve", help="mesh (or load mesh) and solve")
    spp.add_argument("file")
    _device_args(spp)
    spp.add_argument("--premeshed", action="store_true",
                     help="read existing .node/.ele/.edge/.pbc files")
    spp.set_defaults(fn=cmd_solve)
    lp = sub.add_parser("script", help="run a FEMM Lua automation script "
                        "(femmcli --lua-script equivalent)")
    lp.add_argument("file")
    lp.add_argument("--lua-trace-functions", action="store_true",
                    help="print every command call (femmcli "
                         "--lua-trace-functions, LuaInstance.cpp:128)")
    lp.add_argument("--lua-pedantic-mode", action="store_true",
                    help="warn on access to undefined variables")
    lp.add_argument("--lua-init", metavar="FILE",
                    help="run FILE in the interpreter before the script")
    lp.add_argument("-q", "--quiet", action="store_true",
                    help="suppress script console output")
    _device_args(lp)
    lp.set_defaults(fn=cmd_script)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
