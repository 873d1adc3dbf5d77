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
``solve --devices N`` runs the linear solves as a domain decomposition
over N parts (``parallel/driver.py``), all N on that one device; AC
problems with circuit Case-2 DOFs keep the single-device path:

    python -m xfemm_tpu_torch solve problem.fem --devices 4

Under ``torchrun`` (which sets ``WORLD_SIZE``) each rank is one part:
``WORLD_SIZE`` must equal N, the ranks join one process group
(``parallel/launch.py``: NCCL with a card per rank, gloo with
``--device cpu``), and rank 0 alone prints and writes the solution:

    torchrun --nproc-per-node 4 -m xfemm_tpu_torch solve problem.fem \
        --devices 4
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
    from .mesh.meshdata import read_mesh_files
    from . import models

    if "WORLD_SIZE" in os.environ:
        return _solve_ranks(args)
    base = os.path.splitext(args.file)[0]
    problem = _load(args.file)
    if args.premeshed:
        mesh = read_mesh_files(base)
    else:
        mesh = _mesh(problem, base, write=False)
    print(f"solving {mesh.num_nodes} nodes ...")
    t0 = time.time()
    kw = {}
    if args.devices:
        kw["devices"] = args.devices
    sol = models.solve(problem, mesh, device=args.device,
                       hbm_bytes=args.hbm_bytes, **kw)
    _write(problem, mesh, sol, base, time.time() - t0)
    return 0


def _solve_ranks(args) -> int:
    """``solve`` in one rank of a ``torchrun`` launch: one part per rank
    over the launch's process group; rank 0 prints and writes."""
    import torch.distributed as dist

    from .mesh.meshdata import read_mesh_files
    from . import models
    from .parallel import launch

    world = int(os.environ["WORLD_SIZE"])
    if args.devices != world:
        print(f"solve: --devices {args.devices} under a launch of {world} "
              f"ranks; one part per rank needs --devices {world}",
              file=sys.stderr)
        return 2
    group, dev, created = launch.init_from_env(args.device)
    try:
        lead = dist.get_rank(group) == 0
        base = os.path.splitext(args.file)[0]
        if args.premeshed:
            problem, mesh = _load(args.file), read_mesh_files(base)
        else:
            # rank 0 meshes; the others receive its problem and mesh
            box = [None]
            if lead:
                problem = _load(args.file)
                box = [(problem, _mesh(problem, base, write=False))]
            dist.broadcast_object_list(box, src=0, group=group)
            problem, mesh = box[0]
        if lead:
            print(f"solving {mesh.num_nodes} nodes over {world} ranks "
                  f"({dist.get_backend(group)}) ...")
        t0 = time.time()
        sol = models.solve(problem, mesh, devices=world, device_mesh=group,
                           device=dev, hbm_bytes=args.hbm_bytes)
        if lead:
            _write(problem, mesh, sol, base, time.time() - t0)
    finally:
        if created:
            dist.destroy_process_group()
    return 0


def _write(problem, mesh, sol, base: str, elapsed: float) -> None:
    from .constants import FileType
    from .io import ansfile

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
    spp.add_argument("--devices", type=int, default=None,
                     help="run the linear solves as a domain "
                          "decomposition over N parts on the one device "
                          "(under torchrun: one part per rank, N = "
                          "WORLD_SIZE)")
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
