"""Runs one cell of the benchmark once and prints one JSON line.

    python3 -m benchmark.run --workload mag250k.sweep --seed 7 \
        --seconds 51 --trace 0

One client sends solve requests back to back (a closed loop) for
``--seconds`` seconds, each request drawn from ``--seed`` by the cell's
traffic file and ending in ``torch.cuda.synchronize()``. ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` runs the same
window under ``torch.profiler`` with the program's phase timers on and
reports its per-layer metrics. After the window, the plain reference
judges a sample of the served solutions (``correct``). The set-up
(imports, the kernels' build cache, meshing, one warm-up request) is
``setup_s``. Without a CUDA card the run exits with an error and prints
no result.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()

#: host threads of every pool the run's libraries keep (OpenMP, BLAS,
#: torch's intra-op pool), fixed before any of them loads, so that a run
#: does not take its pool sizes from the machine or the environment
HOST_THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from benchmark import meshcheck, spec  # noqa: E402
from benchmark.traffic import Traffic  # noqa: E402

#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "xfemm_tpu")
#: served requests the reference judges in a run: the slowest, and the
#: rest drawn from the seed
JUDGED = 6


@dataclass
class Request:
    index: int
    params: dict
    seconds: float = 0.0
    mesh_seconds: float | None = None
    iterations: int = 0
    phases: dict = field(default_factory=dict)
    answer: object = None     # the nodal solution (numpy)
    mesh: object = None       # the mesh it was solved on
    error: str | None = None


@dataclass
class Run:
    """What a run measured; the metric readers take their numbers
    from it."""
    cell: dict
    config: dict
    requests: list
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: int = 0
    carried: int = 0
    masked: int = 0
    trace: object = None      # trace.Summary of a traced run
    device_name: str = ""
    op_bytes: list = field(default_factory=list)   # per request
    traffic: Traffic | None = None
    correct: bool = False


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _regime(solver) -> str:
    """The band engine's regime of the newest solve, from the program's
    band cache: "bt-alone" is one f32 band level and a frozen
    block-tridiagonal factor as the whole preconditioner."""
    if not solver._BAND_CACHE:
        return "no band"
    entry = next(reversed(solver._BAND_CACHE.values()))
    amg, bt = entry["band_amg"], entry["bt"]
    if amg is None:
        return "no band"
    kind = type(bt).__name__ if bt is not None else "none"
    levels = len(amg.levels)
    if levels == 1 and kind == "BTFactor":
        shape = tuple(amg.levels[0].A.dense.shape)
        return f"bt-alone band {shape} factor {tuple(entry['bt_shape'])}"
    return f"{levels} levels, factor {kind}"


class Cell:
    """One cell on one device: its configuration, problem module and
    the program, set up once; ``window`` serves a seed's traffic and
    ``judge`` checks what it served. ``device``/``hbm_bytes``/
    ``override`` (parameters), ``config_override`` (configuration
    keys) and ``entry`` (a cell not in ``BENCHMARK.json``) serve the CPU
    tests; a measured run passes none."""

    def __init__(self, name: str, device: str | None = None,
                 hbm_bytes: float | None = None,
                 override: dict | None = None,
                 config_override: dict | None = None,
                 entry: dict | None = None):
        self.name = name
        self.bench = spec.load_benchmark()
        self.cell = entry or spec.cell(self.bench, name)
        self.config = spec.config(self.bench, self.cell["config"])
        self.config.update(config_override or {})
        self.mix = spec.traffic(self.cell["traffic"])
        self.prob = spec.problem(self.config["problem"])
        self.params = {**self.config["params"], **(override or {})}
        self.hbm_bytes = hbm_bytes

        import torch
        self.torch = torch
        torch.set_num_threads(HOST_THREADS)
        if device is None:
            if not torch.cuda.is_available():
                fail("no CUDA device: the benchmark measures the card only")
            if torch.cuda.device_count() < self.cell["chips"]:
                fail(f"{self.cell['chips']} CUDA devices needed, "
                     f"{torch.cuda.device_count()} present")
            device = "cuda"
        self.device = device
        self.on_card = torch.device(device).type == "cuda"

        from xfemm_tpu_torch import models
        from xfemm_tpu_torch.mesh import mesher
        from xfemm_tpu_torch.ops import kernels, loop, solver
        from xfemm_tpu_torch.utils import profiling
        self.models, self.mesher, self.kernels = models, mesher, kernels
        self.loop, self.solver, self.profiling = loop, solver, profiling
        if self.on_card:
            kernels.build()
        self.shared = None

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def serve(self, req: Request, trace: bool = False):
        """Serve one request: build its problem, mesh it unless the mesh
        is shared, solve, synchronize."""
        mesh = self.shared
        t = time.perf_counter()
        problem = self.prob.build({**self.params, **req.params})
        if mesh is None:
            with _span(trace, "bench:mesh"):
                tm = time.perf_counter()
                mesh = self.mesher.mesh_problem(problem)
                req.mesh_seconds = time.perf_counter() - tm
        sol = self.models.solve(problem, mesh, device=self.device,
                                hbm_bytes=self.hbm_bytes)
        self.sync()
        req.seconds = time.perf_counter() - t
        req.iterations = int(sol.iterations)
        req.answer = self.prob.answer(sol).copy()
        req.mesh = mesh

    def check_regime(self, what: str):
        want = self.config.get("regime")
        got = _regime(self.solver)
        if want and not got.startswith(want):
            fail(f"{what}: the planner chose {got!r}, not the "
                 f"configuration's {want!r}", 3)
        return got

    def set_up(self):
        """The mesh of the configuration's geometry (unless every request
        meshes its own) and one warm-up request at the configuration's
        own parameters; neither depends on the seed."""
        if self.mix["mesh"] == "once":
            self.shared = self.mesher.mesh_problem(
                self.prob.build(self.params))
        warm = Request(index=-1, params={})
        self.serve(warm)
        got = self.check_regime("the warm-up request")
        print(f"benchmark: {self.name}: set-up meshed "
              f"{len(warm.mesh.nodes)} nodes, regime {got}",
              file=sys.stderr, flush=True)

    def window(self, seed: int, seconds: float, trace: bool) -> Run:
        """Serve the seed's requests back to back for ``seconds``."""
        torch, profiling, loop = self.torch, self.profiling, self.loop
        traffic = Traffic(self.mix, seed)
        capture = None
        if trace:
            from benchmark import trace as trace_mod
            roles = {r: spec.kernel_role(r)
                     for r in ("operator_apply", "bt_sweep")}
            capture = trace_mod.Capture(torch, profiling, self.kernels,
                                        roles)
        gc.collect()
        self.sync()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        carried0 = sum(loop.CARRIED.values())
        masked0 = sum(loop.MASKED.values())
        requests = []
        if capture is not None:
            capture.start()
        tw = time.perf_counter()
        while time.perf_counter() - tw < seconds:
            req = Request(index=len(requests),
                          params=traffic.request(len(requests)))
            requests.append(req)
            snap = profiling.snapshot() if trace else None
            try:
                with _span(trace, "bench:request"):
                    self.serve(req, trace)
            except Exception as exc:  # counted as failed, not fatal
                req.error = f"{type(exc).__name__}: {exc}"
                print(f"benchmark: request {req.index} failed: {req.error}",
                      file=sys.stderr, flush=True)
            if snap is not None:
                now = profiling.snapshot()
                req.phases = {k: v - snap.get(k, 0.0)
                              for k, v in now.items()
                              if v - snap.get(k, 0.0) > 0.0}
            if req.error is None:
                self.check_regime(f"request {req.index}")
        window_s = time.perf_counter() - tw
        peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        summary = None
        if capture is not None:
            tr = time.perf_counter()
            summary = capture.stop()
            print(f"benchmark: trace of {summary.events} events reduced in "
                  f"{time.perf_counter() - tr:.1f} s; {summary.sweep_calls} "
                  f"sweep launches wrapped", file=sys.stderr, flush=True)
            done = [r for r in requests if r.error is None]
            per = {}
            for r in done:
                for k, v in r.phases.items():
                    per[k] = per.get(k, 0.0) + v / len(done)
            print("benchmark: phase seconds per request (nested phases "
                  "counted in their parents too): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(
                          per.items(), key=lambda kv: -kv[1])),
                  file=sys.stderr, flush=True)
        run = Run(cell=self.cell, config=self.config, requests=requests,
                  window_s=window_s, peak_bytes=peak,
                  carried=sum(loop.CARRIED.values()) - carried0,
                  masked=sum(loop.MASKED.values()) - masked0, trace=summary,
                  device_name=(torch.cuda.get_device_name(0)
                               if self.on_card else ""), traffic=traffic)
        return run

    def judge(self, run: Run) -> dict:
        """The checks of a window: the slowest served request and
        ``JUDGED`` - 1 more drawn from the seed, each meshed geometry
        checked and each answer judged by the plain reference (one
        thread per request)."""
        checks = {k: {"value": 0.0, "limit": lim}
                  for k, lim in self.config["limits"].items()}
        served = [r for r in run.requests if r.error is None]
        judged = []
        if served:
            slow = max(served, key=lambda r: r.seconds)
            rest = [r for r in served if r is not slow]
            judged = [slow] + [rest[i] for i in run.traffic.check_sample(
                len(rest), JUDGED - 1)]
        t = time.perf_counter()
        with ThreadPoolExecutor(max(len(judged), 1)) as pool:
            readings = list(pool.map(self._check, judged))
        for got in readings:
            for k, v in got.items():
                checks[k]["value"] = max(checks[k]["value"], v)
        print(f"benchmark: requests {[r.index for r in judged]} judged in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
        run.correct = (bool(judged) and len(served) == len(run.requests)
                       and all(c["value"] <= c["limit"]
                               for c in checks.values()))
        return checks

    def _check(self, r: Request) -> dict:
        """One served request's mesh checks and its reference gap."""
        p = {**self.params, **r.params}
        got = meshcheck.check(self.prob, p, r.mesh)
        ref = self.prob.reference(p, r.mesh.nodes, r.mesh.elements,
                                  r.mesh.element_labels)
        got["gap"] = self.prob.judge(ref, r.answer)
        return got

    def metrics(self, run: Run, trace: bool) -> dict:
        if trace:
            from benchmark import roofline
            per_mesh = {}
            for r in run.requests:
                if r.error is None and id(r.mesh) not in per_mesh:
                    per_mesh[id(r.mesh)] = roofline.csr_apply_bytes(
                        r.mesh.elements, len(r.mesh.nodes),
                        self.prob.fixed_nodes({**self.params, **r.params},
                                              r.mesh.nodes))
            run.op_bytes = [per_mesh[id(r.mesh)] if r.error is None else 0
                            for r in run.requests]
        out = {}
        kind = "per_layer" if trace else "end_to_end"
        for m in spec.metrics_for(self.bench, self.name, kind):
            value = spec.metric(m["name"]).read(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t0: float | None = None, **cell_kw) -> tuple:
    """One run of cell ``name``: set-up, window, metrics, checks.
    Returns (the result object, the window's Run)."""
    t0 = _T0 if t0 is None else t0
    cell = Cell(name, **cell_kw)
    cell.set_up()
    setup_s = time.perf_counter() - t0
    run = cell.window(seed, seconds, trace)
    run.setup_s = setup_s
    metrics = cell.metrics(run, trace)
    checks = cell.judge(run)

    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        fail(f"modules loaded in the run's process: {', '.join(found)}", 4)

    served = sum(r.error is None for r in run.requests)
    result = {
        "correct": run.correct,
        "attempted": len(run.requests),
        "failed": len(run.requests) - served,
        "metrics": metrics,
        "device": _device(cell.torch, cell.on_card, cell.cell,
                          run.peak_bytes, run.trace),
    }
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result, run


def _span(trace: bool, name: str):
    """A span in the profiler's timeline (traced runs only)."""
    if not trace:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def _device(torch, on_card: bool, cell: dict, peak: int, summary) -> dict:
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def report(result: dict, run: Run | None = None) -> None:
    """The window's requests and then the checks on standard error (its
    last lines), then the result as the last line of standard output."""
    for r in run.requests if run is not None else []:
        print(f"request {r.index}: {r.seconds:.4f} s"
              + (f" (mesh {r.mesh_seconds:.4f} s)" if r.mesh_seconds else "")
              + f", {r.iterations} CG, "
              + ", ".join(f"{k} {v:.6g}" for k, v in sorted(r.params.items()))
              + (f", failed: {r.error}" if r.error else ""),
              file=sys.stderr, flush=True)
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER LIMIT"
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not math.isfinite(args.seconds) or args.seconds <= 0:
        fail("--seconds must be positive")
    report(*run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace)))


if __name__ == "__main__":
    main()
