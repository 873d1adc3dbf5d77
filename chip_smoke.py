"""Smoke run of the PyTorch port (xfemm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. print the card's name and power limit (nvidia-smi) and build the
   hand-written CUDA kernels from ``xfemm_tpu_torch/ops/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: the band matvec at (1949, 128, 2176) in f32 and
   bf16 and an R=512 band, the block-Thomas apply (its three kernels) at
   b=1024, NB=244 and at b=2048; print errors and median times;
3. drive the main path: ``benchprob.build(250_000)``, the port's mesher
   (npz cache under .bench_cache/), and ``magnetostatics.solve`` cold
   and warm on the card, counting the kernels' launches; check the
   residual, the regime and the launch counts; time each kernel and its
   plain version on the main path's own band and factor; solve a small
   problem on the card and on the CPU path and compare; profile one more
   warm solve with torch.profiler (device time by kernel, busy share);
4. print the ``kernels`` JSON line, the nvidia-smi line and, last,
   ``{"ok": true, "device": {...}}``.

The random inputs of phase 2 come from ``torch.Generator`` seeded with
SEED; the main path's problem is deterministic.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NODES = 250_000          # benchprob.build target: 249,469 mesh nodes

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
#: (non-tensor-core) flop/s -- the kernels' roofline
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: file:line of the TPU kernel each CUDA kernel replaces
REPLACES = {
    "band_mv": "xfemm_tpu/ops/pallas_band.py:70",
    "bt_fwd": "xfemm_tpu/ops/blocktri.py:410",
    "bt_q": "xfemm_tpu/ops/blocktri.py:448",
    "bt_bwd": "xfemm_tpu/ops/blocktri.py:472",
}
SOURCES = {
    "band_mv": "xfemm_tpu_torch/ops/csrc/band_mv.cu",
    "bt_fwd": "xfemm_tpu_torch/ops/csrc/bt_sweep.cu",
    "bt_q": "xfemm_tpu_torch/ops/csrc/bt_sweep.cu",
    "bt_bwd": "xfemm_tpu_torch/ops/csrc/bt_sweep.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed nothing")
    return out[0]


def median_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` (CUDA events around each
    call; the inputs are larger than L2, so every call streams from
    device memory)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(y, ref) -> float:
    return float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_band_mv(kernels, torch, gen, NT, R, W, shift0, ncols, dtype,
                  tol):
    dense = torch.randn((NT, R, W), generator=gen, device="cuda") \
        .to(dtype)
    x = torch.randn(ncols, generator=gen, device="cuda")
    y = kernels.band_mv(dense, x, shift0, R, ncols)
    ref = kernels.band_mv_plain(dense, x, shift0, R, ncols)
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    ms = median_ms(lambda: kernels.band_mv(dense, x, shift0, R, ncols))
    print(f"K1 band_mv ({NT},{R},{W}) {str(dtype)[6:]} shift0={shift0}: "
          f"max rel err {err:.3e} (tol {tol:g}), median {ms:.4f} ms",
          flush=True)
    if not err <= tol:
        fail(f"band_mv disagrees with its plain version: {err:.3e}")
    del dense


def random_factor(torch, gen, NB, b):
    """A factor whose sweeps stay bounded: ||G|| ~ 0.6."""
    from xfemm_tpu_torch.ops.blocktri import BTFactor
    Sinv = torch.randn((NB, b, b), generator=gen, device="cuda") / b ** 0.5
    G = 0.3 * torch.randn((NB - 1, b, b), generator=gen,
                          device="cuda") / b ** 0.5
    s = 0.5 + torch.rand(NB * b, generator=gen, device="cuda")
    return BTFactor(Sinv=Sinv, G=G, s=s)


def bt_apply_plain(kernels, bt, r):
    NB, b, _ = bt.Sinv.shape
    n = r.shape[0]
    import torch
    rs = torch.zeros(NB * b, device=r.device)
    rs[:n] = bt.s[:n] * r
    rs = rs.view(NB, b)
    z = kernels.bt_bwd_plain(bt.G, kernels.bt_q_plain(
        bt.Sinv, kernels.bt_fwd_plain(bt.G, rs)))
    return bt.s[:n] * z.view(-1)[:n]


def check_bt_apply(kernels, blocktri, torch, gen, NB, b, tol):
    bt = random_factor(torch, gen, NB, b)
    n = NB * b - 37
    r = torch.randn(n, generator=gen, device="cuda")
    z = blocktri.bt_apply(bt, r)
    ref = bt_apply_plain(kernels, bt, r)
    torch.cuda.synchronize()
    err = rel_err(z, ref)
    rs = (bt.s[:n] * r)
    rs = torch.nn.functional.pad(rs, (0, 37)).view(NB, b)
    ys = kernels.bt_fwd(bt.G, rs)
    qs = kernels.bt_q(bt.Sinv, ys)
    t_f = median_ms(lambda: kernels.bt_fwd(bt.G, rs), reps=7)
    t_q = median_ms(lambda: kernels.bt_q(bt.Sinv, ys), reps=7)
    t_b = median_ms(lambda: kernels.bt_bwd(bt.G, qs), reps=7)
    print(f"K2-K4 bt_apply b={b} NB={NB} f32: max scaled err {err:.3e} "
          f"(tol {tol:g}); median fwd {t_f:.4f} ms, q {t_q:.4f} ms, "
          f"bwd {t_b:.4f} ms", flush=True)
    if not err <= tol:
        fail(f"bt_apply disagrees with its plain version: {err:.3e}")
    del bt


def kernel_phase(torch, seed: int) -> None:
    from xfemm_tpu_torch.ops import blocktri, kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    # the 250k main path's band: (1949, 128, 2176), shift0 -8
    check_band_mv(kernels, torch, gen, 1949, 128, 2176, -8, 249_469,
                  torch.float32, 1e-5)
    # bf16 storage: the aggregate bound of the CPU test (3e-2)
    check_band_mv(kernels, torch, gen, 1949, 128, 2176, -8, 249_469,
                  torch.bfloat16, 3e-2)
    check_band_mv(kernels, torch, gen, 488, 512, 2560, -2, 249_600 - 300,
                  torch.float32, 1e-5)
    check_bt_apply(kernels, blocktri, torch, gen, 244, 1024, 1e-5)
    check_bt_apply(kernels, blocktri, torch, gen, 6, 2048, 1e-5)
    # the one-call library equivalent of K3 (batched GEMV)
    bt = random_factor(torch, gen, 244, 1024)
    y = torch.randn((244, 1024), generator=gen, device="cuda")
    lib = median_ms(lambda: torch.bmm(bt.Sinv, y[:, :, None]))
    print(f"library torch.bmm for K3 at b=1024 NB=244: median {lib:.4f} ms",
          flush=True)
    del bt, y
    torch.cuda.empty_cache()


def get_mesh(prob, nodes: int):
    from xfemm_tpu_torch.mesh import meshdata, mesher
    path = os.path.join(HERE, ".bench_cache", f"torch_mesh_{nodes}.npz")
    if os.path.exists(path):
        return meshdata.load_npz(path)
    mesh = mesher.mesh_problem(prob)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meshdata.save_npz(mesh, path)
    return mesh


def main_path(torch, nodes: int):
    """Two solves of the nonlinear problem on the card; returns the
    launch counts and what the checks need."""
    import numpy as np

    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.utils import profiling

    t0 = time.time()
    prob = benchprob.build(nodes)
    mesh = get_mesh(prob, nodes)
    print(f"mesh: {mesh.num_nodes} nodes, {mesh.num_elements} elements "
          f"({time.time() - t0:.1f} s incl. cache)", flush=True)
    profiling.ENABLED = True
    kernels.reset_launches()
    sols = []
    for label in ("cold", "warm"):
        profiling.reset()
        t0 = time.time()
        sol = magnetostatics.solve(prob, mesh)
        torch.cuda.synchronize()
        dt = time.time() - t0
        sols.append(sol)
        print(f"{label} solve: {dt:.3f} s, Newton iterations "
              f"{sol.newton_iterations}, CG iterations {sol.iterations}, "
              f"residual {sol.residual:.3e}", flush=True)
        print(profiling.report(), flush=True)
    launches = dict(kernels.LAUNCHES)
    profiling.ENABLED = False
    for sol in sols:
        if not sol.residual <= prob.Precision:
            fail(f"residual {sol.residual:.3e} above {prob.Precision:g}")
        if sol.A.shape != (mesh.num_nodes,) or not np.isfinite(sol.A).all():
            fail("A is not a finite per-node vector")
    cg = sum(s.iterations for s in sols)
    state = next(iter(solver._BAND_CACHE.values()))
    band = state["band_amg"].levels[0].A
    bt = state["bt"]
    b, NB = state["bt_shape"]
    print(f"regime: band {tuple(band.dense.shape)} {band.dense.dtype} "
          f"shift0={band.shift0}, block-tridiagonal factor b={b} NB={NB}",
          flush=True)
    print(f"launches over both solves: {launches}; CG iterations {cg}",
          flush=True)
    if not (launches["bt_fwd"] == launches["bt_q"] == launches["bt_bwd"]
            >= cg > 0 and launches["band_mv"] >= cg):
        fail("a kernel of the main path was launched less than once per "
             "CG iteration")
    dA = float(abs(sols[0].A - sols[1].A).max() / abs(sols[0].A).max())
    print(f"cold vs warm solution: max rel diff {dA:.3e}", flush=True)
    if not dA <= 1e-5:
        fail("cold and warm solves disagree")
    return launches, band, bt, prob, mesh


def measure_on_main_path(torch, band, bt):
    """Each kernel and its plain version on the main path's band and
    factor: errors, median times, bounds, library times."""
    from xfemm_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows = []
    x = torch.randn(band.ncols, generator=gen, device="cuda")
    d = band.dense
    NT, R, W = d.shape
    k = kernels.band_mv(d, x, band.shift0, band.cchunk, band.ncols)
    p = kernels.band_mv_plain(d, x, band.shift0, band.cchunk, band.ncols)
    rows.append(dict(
        name="band_mv", err=float((k - p).abs().max()), rel=rel_err(k, p),
        ms=median_ms(lambda: kernels.band_mv(d, x, band.shift0, band.cchunk,
                                             band.ncols)),
        plain_ms=median_ms(lambda: kernels.band_mv_plain(
            d, x, band.shift0, band.cchunk, band.ncols), reps=7),
        bound=bound_ms(d.numel() * d.element_size() + 4 * band.ncols
                       + 4 * NT * R, 2.0 * NT * R * W),
        library_ms=None))
    NB, b, _ = bt.Sinv.shape
    rs = torch.randn((NB, b), generator=gen, device="cuda")
    ys = kernels.bt_fwd(bt.G, rs)
    qs = kernels.bt_q(bt.Sinv, ys)
    vec = 2 * 4 * NB * b
    gbytes = bt.G.numel() * bt.G.element_size()
    sbytes = bt.Sinv.numel() * bt.Sinv.element_size()
    for name, fn, plain, mat, v, mb in (
            ("bt_fwd", kernels.bt_fwd, kernels.bt_fwd_plain, bt.G, rs,
             gbytes),
            ("bt_q", kernels.bt_q, kernels.bt_q_plain, bt.Sinv, ys, sbytes),
            ("bt_bwd", kernels.bt_bwd, kernels.bt_bwd_plain, bt.G, qs,
             gbytes)):
        k, p = fn(mat, v), plain(mat, v)
        err, rel = float((k - p).abs().max()), rel_err(k, p)
        lib = None
        if name == "bt_q":
            lib = median_ms(lambda: torch.bmm(mat, v[:, :, None]))
        rows.append(dict(
            name=name, err=err, rel=rel,
            ms=median_ms(lambda: fn(mat, v), reps=7),
            plain_ms=median_ms(lambda: plain(mat, v), reps=5),
            bound=bound_ms(mb + vec, 2.0 * mat.shape[0] * b * b),
            library_ms=lib))
    for r in rows:
        print(f"main-path {r['name']}: max abs err {r['err']:.3e} "
              f"(rel {r['rel']:.3e}), "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
              + ("" if r["library_ms"] is None
                 else f", library {r['library_ms']:.4f} ms") + ")",
              flush=True)
    return rows


def profile_solve(torch, prob, mesh) -> None:
    """One more warm solve under torch.profiler: device time by kernel
    and the device's busy share of the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from xfemm_tpu_torch.models import magnetostatics
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        magnetostatics.solve(prob, mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e6
    print(f"profiled warm solve: {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100.0 * busy / wall:.1f}%)", flush=True)
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:70]}", flush=True)


def small_reference(torch, nodes: int) -> None:
    """The same small problem on the card and through the CPU path (the
    path the CPU tests hold against the JAX package)."""
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.mesh import mesher
    prob = benchprob.build(nodes)
    mesh = mesher.mesh_problem(prob)
    a = magnetostatics.solve(prob, mesh, device="cuda")
    prob2 = benchprob.build(nodes)
    c = magnetostatics.solve(prob2, mesh, device="cpu",
                             hbm_bytes=torch.cuda.mem_get_info()[1])
    d = float(abs(a.A - c.A).max() / abs(c.A).max())
    print(f"small problem ({mesh.num_nodes} nodes): card vs CPU path max "
          f"rel diff {d:.3e} (residuals {a.residual:.2e} / "
          f"{c.residual:.2e})", flush=True)
    if not d <= 1e-5:
        fail("card and CPU path disagree on the small problem")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    try:
        from xfemm_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"the xfemm_tpu_torch package is not next to this script "
             f"({exc})")
    smi = smi_line()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    kernels.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        lines = [ln for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)

    kernel_phase(torch, SEED)
    launches, band, bt, prob, mesh = main_path(torch, NODES)
    rows = measure_on_main_path(torch, band, bt)
    profile_solve(torch, prob, mesh)
    small_reference(torch, 10_000)
    out = []
    for r in rows:
        out.append({"name": r["name"], "route": "cuda",
                    "source": SOURCES[r["name"]],
                    "replaces": REPLACES[r["name"]],
                    "launches": launches[r["name"]],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    if any(o["launches"] == 0 for o in out):
        fail("a kernel of the main path was never launched")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
