"""Smoke run of the PyTorch port (xfemm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only | --large-only]

Phases (any failure exits non-zero, with no result line):

1. print the card's name and power limit (nvidia-smi) and build the
   hand-written CUDA kernels from ``xfemm_tpu_torch/ops/csrc`` with nvcc
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the band matvec (K1) at (1949, 128, 2176) in f32
   and bf16 and an R=512 band, the block-Thomas apply (the persistent
   forward sweep bt_fwd (K2) and the fused Sinv product + backward sweep
   bt_qbwd (K3 + K4)) at b=1024, NB=244, at b=2048 (a ring of chunks),
   in bf16 at b=896 and b=256, and at NB=1 and 2 (each sweep also step
   by step, and twice for bitwise determinism), the fused symmetric
   apply (K5) at the 4.47M fine level's (34909, 128, 1024) in f32, a
   bf16 band, and an R=256 band with a positive shift0; print errors,
   median times and both sweeps' launch plans (``--kernels-only`` stops
   here);
3. the 250k path (slice 1): ``benchprob.build(250_000)``, the port's
   mesher (npz cache under .bench_cache/), ``magnetostatics.solve`` cold
   and warm on the card, counting the kernels' launches; check the
   residual, the bt-alone regime, the launch counts and that the device
   Newton loop ran (``newton.run``, not the scatter mode; host passes,
   device runs and steps, CG iterations in each and the "device newton"
   seconds printed per solve); the same cold and warm solves on the host
   Newton chain (``XFEMM_TPU_NO_DEVICE_NEWTON=1``), checked the same way
   and against the loop's A; time each kernel and its plain version on
   the path's own band and factor, with the clock cycles per phase of a
   step of both sweeps (their traces), and the loop's delta sidecar
   (its ``index_add`` per operator apply); profile one more warm solve
   with torch.profiler (device time by kernel, busy share); one cold
   solve with the fine level alone and one with the full hierarchy (the
   cost of the bt-alone regime's fine-only build); solve a 10k problem
   on the card and on the CPU path and compare;
4. the large path (slice 2): ``benchprob.build(4_500_000)`` (4,468,229
   nodes), one cold solve on the card at the card's own memory size;
   check the planner's regime (partitioned ordering, f32 triu fine band,
   bf16 BTSmoother, band-AMG V-cycle), the residual, the launch counts,
   that the device Newton loop ran in its scatter mode
   (``newton.run_scatter``) and refreshed the fine band in place (the
   same storage throughout; the refresh timed per step); hold every
   kernel against its plain version on the live
   hierarchy and smoother (each level's K5 or K1 band, bf16 copy and
   prolongator; the sweeps step by step, chained and repeated); time K5
   on the live fine band and the live smoother's bt_fwd and bt_qbwd
   (with both sweeps' launch plans and clock cycles per phase of a
   step), profile a few CG iterations; then the V-cycle on a small
   problem (Temp.fem at a 1.5e8-byte plan, triu storage forced for this
   check only), card against CPU, cold and again, with its CG iterations
   bounded;
   ``--large-only`` runs phases 1, 2 and 4;
5. print the ``kernels`` JSON line, the nvidia-smi line and, last,
   ``{"ok": true, "device": {...}}``.

The random inputs of phase 2 come from ``torch.Generator`` seeded with
SEED; the problems of the main paths are deterministic.
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
LARGE_NODES = 4_500_000  # benchprob.build target: 4,468,229 mesh nodes

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
#: (non-tensor-core) flop/s -- the kernels' roofline
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: file:line of the TPU kernel each CUDA kernel replaces
REPLACES = {
    "band_mv": "xfemm_tpu/ops/pallas_band.py:70",
    "band_sym": "xfemm_tpu/ops/pallas_band.py:115",
    "bt_fwd": "xfemm_tpu/ops/blocktri.py:410",
    "bt_qbwd": "xfemm_tpu/ops/blocktri.py:448 (q_kernel) and "
               "xfemm_tpu/ops/blocktri.py:472 (bwd_kernel)",
}
SOURCES = {
    "band_mv": "xfemm_tpu_torch/ops/csrc/band_mv.cu",
    "band_sym": "xfemm_tpu_torch/ops/csrc/band_sym.cu",
    "bt_fwd": "xfemm_tpu_torch/ops/csrc/bt_fwd.cu",
    "bt_qbwd": "xfemm_tpu_torch/ops/csrc/bt_qbwd.cu",
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


def check_band_sym(kernels, torch, gen, NT, R, W, shift0, ncols, dtype,
                   tol):
    """K5 against its plain version (the XLA two-pass) on a random band;
    the error is relative to max|y|."""
    dense = torch.empty((NT, R, W), dtype=dtype, device="cuda")
    for t0 in range(0, NT, 4096):     # fill in slices: no f32 transient
        dense[t0:t0 + 4096] = torch.randn(
            (min(4096, NT - t0), R, W), generator=gen, device="cuda")
    x = torch.randn(ncols, generator=gen, device="cuda")
    dvec = torch.randn(ncols, generator=gen, device="cuda")
    y = kernels.band_sym(dense, dvec, x, shift0, R, ncols)
    ref = kernels.band_sym_plain(dense, dvec, x, shift0, R, ncols)
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    ms = median_ms(lambda: kernels.band_sym(dense, dvec, x, shift0, R, ncols),
                   reps=9)
    print(f"K5 band_sym ({NT},{R},{W}) {str(dtype)[6:]} shift0={shift0} "
          f"ncols={ncols}: max rel err {err:.3e} (tol {tol:g}), median "
          f"{ms:.4f} ms", flush=True)
    if not err <= tol:
        fail(f"band_sym disagrees with its plain version: {err:.3e}")
    del dense, ref


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
    z = kernels.bt_qbwd_plain(bt.Sinv, bt.G,
                              kernels.bt_fwd_plain(bt.G, rs))
    return bt.s[:n] * z.view(-1)[:n]


#: kernel against plain version, relative to max|y|, wherever both sides
#: see the same inputs (the bf16 bands' rounding of x included): only
#: the fp32 summation order differs
TOL = 1e-5
#: a whole bf16 sweep against its plain version: every step rounds the
#: carried vector to bf16 on both sides, and a rounding that flips on a
#: 1e-7 difference moves that element by up to 2^-9 of itself, which
#: the following steps carry on (1.1e-3 measured at NB=64)
BF16_CHAIN_TOL = 3e-2


def describe_plan(p, per_sm: int, n_sm: int) -> str:
    return (f"grid {p.blocks} blocks ({per_sm} resident per SM x {n_sm} "
            f"SMs), {p.rows} rows per block, ring of {p.stages} stages x "
            f"{p.stage_rows} rows ({p.chunks} chunk(s) per matrix and "
            f"step), {p.smem_bytes} B shared memory")


def describe_qbwd_plan(kernels, torch, b: int, dtype) -> str:
    """bt_qbwd's launch on this card: grid, residency, ring."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = kernels._qbwd_plan(b, dtype, n_sm)
    return describe_plan(p, kernels.qbwd_blocks_per_sm(b, dtype,
                                                       p.smem_bytes), n_sm)


def describe_fwd_plan(kernels, torch, b: int, dtype) -> str:
    """bt_fwd's launch on this card: grid, residency, ring."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = kernels._fwd_plan(b, dtype, n_sm)
    return describe_plan(p, kernels.fwd_blocks_per_sm(dtype, p.smem_bytes),
                         n_sm)


def step_breakdown(tr, names) -> str:
    """Mean clock cycles between a persistent sweep's trace points, over
    the steps of ``tr`` (2, steps, points), in the first and the last
    block."""
    tr = tr.double().cpu()
    n = len(names)
    out = []
    for blk, label in ((0, "first"), (1, "last")):
        t = tr[blk]
        step = float((t[1:, 0] - t[:-1, 0]).mean())
        parts = [f"{names[i + 1]} {float((t[:, i + 1] - t[:, i]).mean()):.0f}"
                 for i in range(n - 1)]
        parts.append(
            f"to next step {float((t[1:, 0] - t[:-1, n - 1]).mean()):.0f}")
        out.append(f"{label} block {step:.0f} cycles per step: "
                   + ", ".join(parts))
    return "; ".join(out)


def qbwd_breakdown(kernels, torch, bt, ys) -> str:
    """Where a step of bt_qbwd goes: one traced call on (bt, ys), over
    the steps that have every trace point (NB-2 .. 1)."""
    NB = ys.shape[0]
    if NB < 4:
        return "too few steps to trace"
    tr = torch.zeros((2, NB, len(kernels.QBWD_TRACE_POINTS)),
                     dtype=torch.int64, device="cuda")
    kernels.bt_qbwd(bt.Sinv, bt.G, ys, trace=tr)
    return step_breakdown(tr[:, 1:NB - 1], kernels.QBWD_TRACE_POINTS)


def fwd_breakdown(kernels, torch, G, rs) -> str:
    """Where a step of bt_fwd goes: one traced call on (G, rs), over the
    steps that have every trace point (1 .. NB-2)."""
    NB = rs.shape[0]
    if NB < 4:
        return "too few steps to trace"
    tr = torch.zeros((2, NB, len(kernels.FWD_TRACE_POINTS)),
                     dtype=torch.int64, device="cuda")
    kernels.bt_fwd(G, rs, trace=tr)
    return step_breakdown(tr[:, 1:NB - 1], kernels.FWD_TRACE_POINTS)


def check_sweeps(kernels, torch, gen, bt, label: str, chain_tol: float,
                 chunk: int = 256) -> dict:
    """bt_fwd and bt_qbwd on factor ``bt`` against their plain versions.
    Each is held STEP BY STEP at TOL: the plain step applied to the
    kernel's own neighbouring output (y_{t-1} for fwd, z_{t+1} for
    bt_qbwd), which both sides round to the factor's storage type alike.
    The chained sweeps are held at ``chain_tol``, and two calls of each
    on the same inputs must agree bit for bit. Returns the step errors
    by kernel."""
    NB, b, _ = bt.Sinv.shape
    G, Sinv = bt.G, bt.Sinv
    rs = torch.randn((NB, b), generator=gen, device="cuda")
    ys = kernels.bt_fwd(G, rs)
    zs = kernels.bt_qbwd(Sinv, G, ys)
    same = {"bt_fwd": torch.equal(ys, kernels.bt_fwd(G, rs)),
            "bt_qbwd": torch.equal(zs, kernels.bt_qbwd(Sinv, G, ys))}

    def rnd(v):
        return kernels._as_factor_dtype(v, G.dtype)

    step = {"bt_fwd": float((ys[0] - rs[0]).abs().max()), "bt_qbwd": 0.0}
    qs = torch.empty_like(ys)       # the plain Sinv products, in chunks
    with kernels.fp32_matmul():
        for t0 in range(0, NB, chunk):
            t1 = min(t0 + chunk, NB)
            qs[t0:t1] = kernels.bt_q_plain(Sinv[t0:t1], ys[t0:t1])
            a = max(t0, 1)
            if a < t1:
                f_ref = rs[a:t1] - torch.bmm(
                    G[a - 1:t1 - 1].float(),
                    rnd(ys[a - 1:t1 - 1])[:, :, None])[:, :, 0]
                step["bt_fwd"] = max(step["bt_fwd"],
                                     float((ys[a:t1] - f_ref).abs().max()))
            e = min(t1, NB - 1)
            if t0 < e:
                b_ref = qs[t0:e] - torch.bmm(
                    G[t0:e].float().transpose(1, 2),
                    rnd(zs[t0 + 1:e + 1])[:, :, None])[:, :, 0]
                step["bt_qbwd"] = max(step["bt_qbwd"],
                                      float((zs[t0:e] - b_ref).abs().max()))
    step["bt_qbwd"] = max(step["bt_qbwd"],
                          float((zs[NB - 1] - qs[NB - 1]).abs().max()))
    for name, out in (("bt_fwd", ys), ("bt_qbwd", zs)):
        step[name] /= float(out.abs().max())
    chain = {"bt_fwd": rel_err(ys, kernels.bt_fwd_plain(G, rs)),
             "bt_qbwd": rel_err(zs, kernels.bt_bwd_plain(G, qs))}
    print(f"K2 + bt_qbwd {label} b={b} NB={NB} {str(G.dtype)[6:]}: per-step "
          f"max rel err fwd {step['bt_fwd']:.3e}, qbwd {step['bt_qbwd']:.3e} "
          f"(tol {TOL:g}); chained fwd {chain['bt_fwd']:.3e}, qbwd "
          f"{chain['bt_qbwd']:.3e} (tol {chain_tol:g}); two calls bitwise "
          f"equal: fwd {same['bt_fwd']}, qbwd {same['bt_qbwd']}", flush=True)
    if not max(step.values()) <= TOL:
        fail(f"a sweep kernel disagrees with its plain step on {label}")
    if not max(chain.values()) <= chain_tol:
        fail(f"a chained sweep disagrees with its plain version on {label}")
    for name, ok in same.items():
        if not ok:
            fail(f"{name} gave two results on the same inputs on {label}")
    return step


def check_bt_apply(kernels, blocktri, torch, gen, NB, b, tol,
                   dtype=None):
    dtype = dtype or torch.float32
    bt = random_factor(torch, gen, NB, b)
    bt = bt._replace(Sinv=bt.Sinv.to(dtype), G=bt.G.to(dtype))
    n = NB * b - 37
    r = torch.randn(n, generator=gen, device="cuda")
    z = blocktri.bt_apply(bt, r)
    ref = bt_apply_plain(kernels, bt, r)
    torch.cuda.synchronize()
    err = rel_err(z, ref)
    rs = (bt.s[:n] * r)
    rs = torch.nn.functional.pad(rs, (0, 37)).view(NB, b)
    ys = kernels.bt_fwd(bt.G, rs)
    t_f = median_ms(lambda: kernels.bt_fwd(bt.G, rs), reps=7)
    t_qb = median_ms(lambda: kernels.bt_qbwd(bt.Sinv, bt.G, ys), reps=7)
    print(f"bt_apply b={b} NB={NB} {str(dtype)[6:]}: max scaled err "
          f"{err:.3e} (tol {tol:g}); median fwd {t_f:.4f} ms, qbwd "
          f"{t_qb:.4f} ms; bt_fwd "
          f"{describe_fwd_plan(kernels, torch, b, dtype)}; bt_qbwd "
          f"{describe_qbwd_plan(kernels, torch, b, dtype)}", flush=True)
    if not err <= tol:
        fail(f"bt_apply disagrees with its plain version: {err:.3e}")
    check_sweeps(kernels, torch, gen, bt, "random factor", tol)
    del bt


def kernel_phase(torch, seed: int) -> None:
    from xfemm_tpu_torch.ops import blocktri, kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    # the 250k main path's band: (1949, 128, 2176), shift0 -8
    check_band_mv(kernels, torch, gen, 1949, 128, 2176, -8, 249_469,
                  torch.float32, TOL)
    # bf16 storage: both sides round x to bf16 alike
    check_band_mv(kernels, torch, gen, 1949, 128, 2176, -8, 249_469,
                  torch.bfloat16, TOL)
    check_band_mv(kernels, torch, gen, 488, 512, 2560, -2, 249_600 - 300,
                  torch.float32, TOL)
    bf16 = torch.bfloat16
    # the 250k factor's shape; b=2048 streams a block step in chunks
    check_bt_apply(kernels, blocktri, torch, gen, 244, 1024, TOL)
    check_bt_apply(kernels, blocktri, torch, gen, 6, 2048, TOL)
    # the 4.47M path's bf16 BTSmoother block size, the smallest b, and
    # the shortest chains (NB=1: no G, no exchange)
    check_bt_apply(kernels, blocktri, torch, gen, 64, 896, BF16_CHAIN_TOL,
                   bf16)
    check_bt_apply(kernels, blocktri, torch, gen, 300, 256, BF16_CHAIN_TOL,
                   bf16)
    for NB in (1, 2):
        check_bt_apply(kernels, blocktri, torch, gen, NB, 1024, TOL)
        check_bt_apply(kernels, blocktri, torch, gen, NB, 896,
                       BF16_CHAIN_TOL, bf16)
    # K5 at the 4.47M fine level's triu band (34909, 128, 1024), shift0 0
    check_band_sym(kernels, torch, gen, 34909, 128, 1024, 0, 4_468_229,
                   torch.float32, TOL)
    check_band_sym(kernels, torch, gen, 8192, 128, 1024, 0, 8192 * 128 - 77,
                   torch.bfloat16, TOL)
    # R=256, positive shift0, ncols not a multiple of R, a partial slice
    check_band_sym(kernels, torch, gen, 3001, 256, 768, 1, 3001 * 256 - 131,
                   torch.float32, TOL)
    torch.cuda.empty_cache()
    # the one-call library equivalent of bt_qbwd's q part (K3: batched GEMV)
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


class NewtonRecorder:
    """Records, while active, what a solve did: every host linear solve
    (``solver.solve``: its CG iterations), every device Newton dispatch
    (``newton.run`` / ``run_scatter``: steps and CG iterations from its
    stats), the fine band's storage address at each scatter step, and
    the device time of each in-place band refresh (CUDA events, read
    after the solve). It wraps the modules' functions and restores them
    on exit; the kernels' launch counts are not touched."""

    def __init__(self, torch):
        self.torch = torch
        self.host = []          # CG iterations per host pass
        self.dev = []           # (name, steps, CG its, res, relax)
        self.ptrs = []          # fine band data_ptr at each scatter step
        self._events = []       # (start, end) per in-place refresh

    def __enter__(self):
        from xfemm_tpu_torch.ops import newton, solver
        self._saved = [(solver, "solve", solver.solve),
                       (newton, "run", newton.run),
                       (newton, "run_scatter", newton.run_scatter),
                       (newton, "_scatter_refresh", newton._scatter_refresh)]
        torch = self.torch
        real = {name: fn for _m, name, fn in self._saved}

        def solve(*a, **kw):
            out = real["solve"](*a, **kw)
            self.host.append(int(out[2]))
            return out

        def loop(name):
            def wrapped(dn, amg, *a, **kw):
                if name == "run_scatter":
                    self.ptrs.append(amg.levels[0].A.dense.data_ptr())
                out = real[name](dn, amg, *a, **kw)
                st = out[-1].tolist()
                self.dev.append((name, int(st[3]), int(st[4]), st[1],
                                 st[0]))
                return out
            return wrapped

        def refresh(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real["_scatter_refresh"](*a, **kw)
            ev[1].record()
            self._events.append(ev)
            return out

        solver.solve = solve
        newton.run = loop("run")
        newton.run_scatter = loop("run_scatter")
        newton._scatter_refresh = refresh
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def refresh_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]

    def summary(self, profiling) -> str:
        steps = sum(d[1] for d in self.dev)
        out = (f"host passes {len(self.host)} ({sum(self.host)} CG "
               f"iterations), device runs {len(self.dev)} "
               f"({', '.join(sorted({d[0] for d in self.dev})) or 'none'}; "
               f"{steps} steps, {sum(d[2] for d in self.dev)} CG "
               f"iterations)")
        if profiling.ENABLED:
            out += (f", device newton "
                    f"{profiling.phase_seconds('device newton'):.3f} s")
        return out


def main_path(torch, nodes: int):
    """Two solves of the nonlinear problem on the card (the device
    Newton loop); returns the launch counts and what the checks need."""
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import kernels, solver

    t0 = time.time()
    prob = benchprob.build(nodes)
    mesh = get_mesh(prob, nodes)
    print(f"mesh: {mesh.num_nodes} nodes, {mesh.num_elements} elements "
          f"({time.time() - t0:.1f} s incl. cache)", flush=True)
    sols, launches, state = solve_twice(torch, prob, mesh, "device loop")
    band = state["band_amg"].levels[0].A
    bt = state["bt"]
    b, NB = state["bt_shape"]
    print(f"regime: band {tuple(band.dense.shape)} {band.dense.dtype} "
          f"shift0={band.shift0}, block-tridiagonal factor b={b} NB={NB}; "
          f"bt_fwd {describe_fwd_plan(kernels, torch, b, bt.G.dtype)}; "
          f"bt_qbwd {describe_qbwd_plan(kernels, torch, b, bt.Sinv.dtype)}",
          flush=True)
    extra = next(iter(magnetostatics._PACK_CACHE.values()))[2]
    dn = extra[("dn", str(solver.resolve_device()))][0]
    return launches, band, bt, dn, prob, mesh, sols


def solve_twice(torch, prob, mesh, chain: str):
    """A cold and a warm solve of the 250k problem on the card, the
    kernels' launches counted from 0 over both; checks the result, the
    bt-alone regime, the launch counts and which Newton chain ran
    ("device loop": ``newton.run`` with at least one device step and no
    scatter step; "host chain": no loop call). Returns (solutions,
    launches, band cache entry)."""
    import numpy as np

    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import blocktri, kernels, solver
    from xfemm_tpu_torch.utils import profiling

    profiling.ENABLED = True
    kernels.reset_launches()
    sols = []
    for label in ("cold", "warm"):
        profiling.reset()
        with NewtonRecorder(torch) as rec:
            t0 = time.time()
            sol = magnetostatics.solve(prob, mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
        sols.append(sol)
        print(f"{chain}, {label} solve: {dt:.3f} s, Newton iterations "
              f"{sol.newton_iterations}, CG iterations {sol.iterations}, "
              f"residual {sol.residual:.3e}; {rec.summary(profiling)}",
              flush=True)
        print(profiling.report(), flush=True)
        names = {d[0] for d in rec.dev}
        if chain == "device loop" and not (
                names == {"run"} and sum(d[1] for d in rec.dev) >= 1):
            fail(f"the {label} solve did not run the device Newton loop "
                 f"(newton.run, no scatter step): {rec.dev}")
        if chain == "host chain" and rec.dev:
            fail(f"the host-chain {label} solve called the device loop")
    launches = dict(kernels.LAUNCHES)
    profiling.ENABLED = False
    for sol in sols:
        if not sol.residual <= prob.Precision:
            fail(f"residual {sol.residual:.3e} above {prob.Precision:g}")
        if sol.A.shape != (mesh.num_nodes,) or not np.isfinite(sol.A).all():
            fail("A is not a finite per-node vector")
    cg = sum(s.iterations for s in sols)
    state = next(iter(solver._BAND_CACHE.values()))
    if not (type(state["bt"]) is blocktri.BTFactor
            and len(state["band_amg"].levels) == 1):
        fail(f"the planner left the bt-alone regime: plan {state['plan']}")
    print(f"{chain}: launches over both solves: {launches}; CG iterations "
          f"{cg}", flush=True)
    if not (launches["bt_fwd"] == launches["bt_qbwd"] >= cg > 0
            and launches["band_mv"] >= cg):
        fail("a kernel of the main path was launched less than once per "
             "CG iteration")
    dA = float(abs(sols[0].A - sols[1].A).max() / abs(sols[0].A).max())
    print(f"{chain}: cold vs warm solution: max rel diff {dA:.3e}",
          flush=True)
    if not dA <= 1e-5:
        fail("cold and warm solves disagree")
    return sols, launches, state


def host_chain(torch, prob, mesh, loop_sols):
    """The 250k cold and warm solves again on the host Newton chain
    (``XFEMM_TPU_NO_DEVICE_NEWTON=1``, from empty caches), checked as
    the device loop's and against its A. Returns the launch counts."""
    clear_solver_caches(torch)
    os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
    try:
        sols, launches, _state = solve_twice(torch, prob, mesh,
                                             "host chain")
        profile_solve(torch, prob, mesh, "host chain")
    finally:
        del os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"]
        clear_solver_caches(torch)
    ref = loop_sols[0].A
    dA = max(float(abs(s.A - ref).max() / abs(ref).max()) for s in sols)
    print(f"host chain vs device loop solutions: max rel diff {dA:.3e}",
          flush=True)
    if not dA <= 1e-5:
        fail("the host chain and the device loop disagree")
    return launches


def warm_pairs(torch, prob, mesh, pairs: int = 10) -> None:
    """Warm 250k solves in turns, host chain then device loop, on the
    same cached session: wall time of each (host clock ending in a
    synchronize) and the medians."""
    from xfemm_tpu_torch.models import magnetostatics
    times = {"host chain": [], "device loop": []}
    for _ in range(pairs):
        for chain in ("host chain", "device loop"):
            if chain == "host chain":
                os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
            try:
                t0 = time.time()
                magnetostatics.solve(prob, mesh)
                torch.cuda.synchronize()
                times[chain].append(time.time() - t0)
            finally:
                os.environ.pop("XFEMM_TPU_NO_DEVICE_NEWTON", None)
    for chain, ts in times.items():
        print(f"warm 250k solves in turns, {chain}: "
              f"{', '.join(f'{t:.3f}' for t in ts)} s; median "
              f"{statistics.median(ts):.3f} s", flush=True)


def sidecar_cost(torch, band, dn) -> None:
    """What ``newton.run``'s delta sidecar adds to each operator apply
    on the 250k band: its ``index_add`` alone, and K1 with and without
    it (CUDA events, medians)."""
    from xfemm_tpu_torch.ops import band as band_mod
    from xfemm_tpu_torch.ops import kernels
    dev = band.dense.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    x = torch.randn(band.ncols, generator=gen, device=dev)
    m = dn.delta_rows.numel()
    side = band_mod.Sidecar(dn.delta_rows, dn.delta_cols,
                            torch.randn(m, generator=gen, device=dev))
    y = torch.zeros(band.ncols, device=dev)
    t_ia = median_ms(lambda: y.index_add(0, side.rows,
                                         side.vals * x[side.cols]))
    t_k1 = median_ms(lambda: kernels.band_mv(band.dense, x, band.shift0,
                                             band.cchunk, band.ncols))
    t_both = median_ms(lambda: band_mod.band_apply(band, None, x, side))
    print(f"delta sidecar of newton.run: {m} entries, index_add "
          f"{t_ia:.4f} ms per operator apply; K1 {t_k1:.4f} ms alone, "
          f"band_apply with the sidecar {t_both:.4f} ms", flush=True)


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
    vec = 2 * 4 * NB * b            # the vector in and the vector out
    gbytes = bt.G.numel() * bt.G.element_size()
    sbytes = bt.Sinv.numel() * bt.Sinv.element_size()
    for name, fn, plain, mb, flops, lib in (
            ("bt_fwd", lambda: kernels.bt_fwd(bt.G, rs),
             lambda: kernels.bt_fwd_plain(bt.G, rs), gbytes,
             2.0 * (NB - 1) * b * b, None),
            ("bt_qbwd", lambda: kernels.bt_qbwd(bt.Sinv, bt.G, ys),
             lambda: kernels.bt_qbwd_plain(bt.Sinv, bt.G, ys),
             gbytes + sbytes, 2.0 * (2 * NB - 1) * b * b,
             lambda: torch.bmm(bt.Sinv, ys[:, :, None]))):
        k, p = fn(), plain()
        rows.append(dict(
            name=name, err=float((k - p).abs().max()), rel=rel_err(k, p),
            ms=median_ms(fn, reps=7), plain_ms=median_ms(plain, reps=5),
            bound=bound_ms(mb + vec, flops),
            library_ms=None if lib is None else median_ms(lib)))
    print(f"main-path bt_fwd step breakdown (clock cycles): "
          f"{fwd_breakdown(kernels, torch, bt.G, rs)}", flush=True)
    print(f"main-path bt_qbwd step breakdown (clock cycles): "
          f"{qbwd_breakdown(kernels, torch, bt, ys)}", flush=True)
    for r in rows:
        print(f"main-path {r['name']}: max abs err {r['err']:.3e} "
              f"(rel {r['rel']:.3e}), "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
              + ("" if r["library_ms"] is None
                 else f", library {r['library_ms']:.4f} ms") + ")",
              flush=True)
    return rows


def profile_solve(torch, prob, mesh, chain: str = "device loop") -> None:
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
    print(f"profiled warm solve ({chain}): {wall:.3f} s wall, device busy "
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


def hierarchy_cost(torch, mesh) -> None:
    """What the bt-alone regime saves by building the fine band level
    alone (``band.setup_fine_band``) where the JAX package builds the
    whole band-AMG hierarchy, which that regime never applies: one cold
    250k solve each way, from empty caches."""
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import solver
    from xfemm_tpu_torch.utils import profiling

    orig = solver._setup_hierarchy

    def full(session, Ap, coords, dev, fine_only):
        orig(session, Ap, coords, dev, False)

    profiling.ENABLED = True
    try:
        for label, setup in (("fine level only", orig),
                             ("full hierarchy", full)):
            clear_solver_caches(torch)
            solver._setup_hierarchy = setup
            torch.cuda.reset_peak_memory_stats()
            profiling.reset()
            t0 = time.time()
            sol = magnetostatics.solve(benchprob.build(NODES), mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
            st = next(iter(solver._BAND_CACHE.values()))
            build = (profiling.phase_seconds("band setup")
                     + profiling.phase_seconds("band amg setup"))
            print(f"250k cold solve, {label}: {dt:.3f} s (band build "
                  f"{build:.3f} s, {len(st['band_amg'].levels)} level(s)), "
                  f"CG iterations {sol.iterations}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
    finally:
        solver._setup_hierarchy = orig
        profiling.ENABLED = False
        clear_solver_caches(torch)


def small_path(torch):
    """Slice 1's main path (250k, bt-alone) on the device loop and on
    the host chain, and its measurements; returns the kernel rows and
    the launch counts of both paths."""
    launches, band, bt, dn, prob, mesh, sols = main_path(torch, NODES)
    rows = measure_on_main_path(torch, band, bt)
    sidecar_cost(torch, band, dn)
    del band, bt, dn
    profile_solve(torch, prob, mesh)
    warm_pairs(torch, prob, mesh)
    host_launches = host_chain(torch, prob, mesh, sols)
    hierarchy_cost(torch, mesh)
    small_reference(torch, 10_000)
    clear_solver_caches(torch)
    return rows, [launches, host_launches]


def clear_solver_caches(torch) -> None:
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import solver
    solver._BAND_CACHE.clear()
    solver._PATTERN_CACHE.clear()
    magnetostatics._PACK_CACHE.clear()
    torch.cuda.empty_cache()


def large_path(torch, nodes: int):
    """One cold solve of the 4.47M-node problem on the card through the
    planner's own choice; checks the regime, the result and the launch
    counts. Returns (launches, the live fine level, CG iterations)."""
    import numpy as np

    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import blocktri, kernels, solver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    t0 = time.time()
    prob = benchprob.build(nodes)
    mesh = get_mesh(prob, nodes)
    print(f"large mesh: {mesh.num_nodes} nodes, {mesh.num_elements} "
          f"elements ({time.time() - t0:.1f} s incl. cache)", flush=True)
    hbm = solver.device_hbm_bytes("cuda")
    print(f"device memory the planner plans against (mem_get_info total): "
          f"{hbm:.4e} bytes", flush=True)
    profiling.ENABLED = True
    profiling.reset()
    solver.TRACE = True           # one line per band CG pass
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    os.environ["XFEMM_TPU_NEWTON_DEBUG"] = "1"   # one line per iteration
    try:
        with NewtonRecorder(torch) as rec:
            t0 = time.time()
            sol = magnetostatics.solve(prob, mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
    finally:
        del os.environ["XFEMM_TPU_NEWTON_DEBUG"]
    launches = dict(kernels.LAUNCHES)
    profiling.ENABLED = False
    solver.TRACE = False
    peak = torch.cuda.max_memory_allocated()
    print(f"large cold solve: {dt:.3f} s, Newton iterations "
          f"{sol.newton_iterations}, CG iterations {sol.iterations}, "
          f"residual {sol.residual:.3e}, peak device memory "
          f"{peak / 1e9:.2f} GB (38.25 GB on the host chain of the "
          f"same plan, H100 80GB); {rec.summary(profiling)}",
          flush=True)
    print("  device steps (scatter; CG iterations, displacement res, "
          "relax): " + ", ".join(f"({d[2]}, {d[3]:.3e}, {d[4]:.3f})"
                                 for d in rec.dev)
          + f"; host passes: CG iterations {rec.host}", flush=True)
    print(profiling.report(), flush=True)
    cg_s = profiling.phase_seconds("device cg")
    dn_s = profiling.phase_seconds("device newton")
    host_cg = max(sum(rec.host), 1)
    loop_cg = max(sum(d[2] for d in rec.dev), 1)
    print(f"large solve device cg {cg_s:.3f} s over the host passes' "
          f"{sum(rec.host)} CG iterations: {1e3 * cg_s / host_cg:.3f} ms per "
          f"iteration; device newton {dn_s:.3f} s over the loop's "
          f"{loop_cg} CG iterations: {1e3 * dn_s / loop_cg:.3f} ms per "
          f"iteration", flush=True)
    state = next(iter(solver._BAND_CACHE.values()))
    amg, bt = state["band_amg"], state["bt"]
    lv0 = amg.levels[0]
    b, NB = state["bt_shape"]
    for i, lv in enumerate(amg.levels):
        d = lv.A.dense
        print(f"  L{i}: A{tuple(d.shape)} {str(d.dtype)[6:]} "
              f"sym={lv.dvec is not None} sidecar="
              f"{0 if lv.oob is None else lv.oob.rows.numel()} "
              f"P={None if lv.P is None else tuple(lv.P.dense.shape)} "
              f"Abf={lv.Abf is not None}", flush=True)
    print(f"  bottom: "
          + (f"dense inverse {tuple(amg.coarse_inv.shape)}"
             if amg.coarse_inv is not None else "block-tridiagonal"),
          flush=True)
    print(f"regime: partitioned={state['partitioned']}, fine band "
          f"{tuple(lv0.A.dense.shape)} {str(lv0.A.dense.dtype)[6:]} "
          f"triu={lv0.dvec is not None}, sidecar "
          f"{0 if lv0.oob is None else lv0.oob.rows.numel()} entries, "
          f"{type(bt).__name__} b={b} NB={NB} "
          f"{None if bt is None else str(bt.Sinv.dtype)[6:]}", flush=True)
    print(f"large path launches: {launches}", flush=True)
    refresh = rec.refresh_ms()
    band_ptr = lv0.A.dense.data_ptr()
    print(f"in-place band refresh (newton._scatter_refresh) per step: "
          f"median {statistics.median(refresh) if refresh else 0.0:.3f} ms "
          f"over {len(refresh)} steps; fine band storage "
          f"{'unchanged' if set(rec.ptrs) == {band_ptr} else 'MOVED'} "
          f"across the run", flush=True)
    if not ({d[0] for d in rec.dev} == {"run_scatter"}
            and sum(d[1] for d in rec.dev) >= 1):
        fail(f"the large solve did not run the device Newton loop in its "
             f"scatter mode: {rec.dev}")
    if set(rec.ptrs) != {band_ptr}:
        fail("the fine band moved during the device Newton loop (a copy)")
    if not (state["partitioned"] and lv0.dvec is not None
            and lv0.A.dense.dtype == torch.float32
            and isinstance(bt, blocktri.BTSmoother)
            and bt.Sinv.dtype == torch.bfloat16 and len(amg.levels) > 1):
        fail(f"the planner did not choose the partitioned triu f32 + bf16 "
             f"BTSmoother V-cycle regime at {hbm:.4e} bytes: "
             f"plan {state['plan']}")
    if not sol.residual <= prob.Precision:
        fail(f"large residual {sol.residual:.3e} above {prob.Precision:g}")
    if sol.A.shape != (mesh.num_nodes,) or not np.isfinite(sol.A).all():
        fail("large A is not a finite per-node vector")
    cg = sol.iterations
    if not (launches["band_sym"] >= 3 * cg > 0
            and launches["bt_fwd"] == launches["bt_qbwd"] >= 2 * cg
            and launches["band_mv"] > 0):
        fail("a kernel of the large path was launched fewer times than the "
             "V-cycle needs")
    return launches, amg, bt


def check_live_hierarchy(torch, amg, bt) -> None:
    """Every kernel of the large path against its plain version on the
    live tensors of the 4.47M solve: each level's operator band (K5 where
    it is stored triu, else K1), its bf16 smoothing copy and its bf16
    prolongator band (K1), at TOL of max|y|; and the live BTSmoother's
    sweeps (bt_fwd, bt_qbwd), step by step at TOL and chained at
    BF16_CHAIN_TOL."""
    from xfemm_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    for i, lv in enumerate(amg.levels):
        for name, bm in (("A", lv.A), ("Abf", lv.Abf), ("P", lv.P)):
            if bm is None:
                continue
            d = bm.dense
            x = torch.randn(bm.ncols, generator=gen, device="cuda")
            args = (bm.shift0, bm.cchunk, bm.ncols)
            if name != "P" and lv.dvec is not None:
                kern = "K5"
                y = kernels.band_sym(d, lv.dvec, x, *args)
                ref = kernels.band_sym_plain(d, lv.dvec, x, *args)
            else:
                kern = "K1"
                y = kernels.band_mv(d, x, *args)
                ref = kernels.band_mv_plain(d, x, *args)
            err = rel_err(y, ref)
            print(f"live L{i} {name} {kern} {tuple(d.shape)} "
                  f"{str(d.dtype)[6:]} cchunk={bm.cchunk}: max rel err "
                  f"{err:.3e} (tol {TOL:g})", flush=True)
            if not err <= TOL:
                fail(f"{kern} disagrees with its plain version on the live "
                     f"level {i} band {name}")
            del y, ref
    torch.cuda.empty_cache()
    check_sweeps(kernels, torch, gen, bt, "live BTSmoother", BF16_CHAIN_TOL)
    torch.cuda.empty_cache()


def measure_large_cg(torch, amg, bt) -> None:
    """The live BTSmoother's sweeps (bt_fwd and bt_qbwd, one persistent
    launch each) beside their bytes bounds and the one-call
    library yardstick of the q part (torch.bmm in bf16), and a short
    window of V-cycle CG iterations under torch.profiler: device time by
    kernel, the device's busy share and wall ms per iteration."""
    from torch.profiler import ProfilerActivity, profile

    from xfemm_tpu_torch.ops import band, kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    NB, b, _ = bt.Sinv.shape
    rs = torch.randn((NB, b), generator=gen, device="cuda")
    ys = kernels.bt_fwd(bt.G, rs)
    yb = ys.to(bt.Sinv.dtype)[:, :, None]
    t_f = median_ms(lambda: kernels.bt_fwd(bt.G, rs), reps=7, warmup=1)
    t_qb = median_ms(lambda: kernels.bt_qbwd(bt.Sinv, bt.G, ys), reps=5,
                     warmup=1)
    t_lib = median_ms(lambda: torch.bmm(bt.Sinv, yb), reps=5, warmup=1)
    gbytes = bt.G.numel() * bt.G.element_size()
    sbytes = bt.Sinv.numel() * bt.Sinv.element_size()
    vec = 2 * 4 * NB * b
    print(f"large-path sweeps b={b} NB={NB} {str(bt.G.dtype)[6:]}: fwd "
          f"{t_f:.3f} ms (bytes bound "
          f"{(gbytes + vec) / HBM_BYTES_PER_S * 1e3:.3f} ms), bt_qbwd "
          f"{t_qb:.3f} ms (bytes bound "
          f"{(gbytes + sbytes + vec) / HBM_BYTES_PER_S * 1e3:.3f} ms; "
          f"library torch.bmm of the q part {t_lib:.3f} ms); bt_fwd "
          f"{describe_fwd_plan(kernels, torch, b, bt.G.dtype)}; bt_qbwd "
          f"{describe_qbwd_plan(kernels, torch, b, bt.Sinv.dtype)}",
          flush=True)
    print(f"large-path bt_fwd step breakdown (clock cycles): "
          f"{fwd_breakdown(kernels, torch, bt.G, rs)}", flush=True)
    print(f"large-path bt_qbwd step breakdown (clock cycles): "
          f"{qbwd_breakdown(kernels, torch, bt, ys)}", flush=True)
    del yb
    n = amg.n
    rhs = torch.randn(n, generator=gen, device="cuda")
    x0 = torch.zeros(n, device="cuda")
    band.band_pcg(amg, rhs, 1e-30, x0, 1, bt=bt)      # warm-up
    torch.cuda.synchronize()
    iters = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        band.band_pcg(amg, rhs, 1e-30, x0, iters, bt=bt)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e6
    print(f"profiled {iters} large-path CG iterations (+ start and drift "
          f"check): {wall:.3f} s wall ({1e3 * wall / iters:.1f} ms per "
          f"iteration), device busy {busy:.3f} s "
          f"({100.0 * busy / wall:.1f}%)", flush=True)
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:70]}", flush=True)


def measure_band_sym(torch, lv0):
    """K5 and its plain version on the live 4.47M fine level."""
    from xfemm_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    A = lv0.A
    d = A.dense
    NT, R, W = d.shape
    x = torch.randn(A.ncols, generator=gen, device="cuda")
    k = kernels.band_sym(d, lv0.dvec, x, A.shift0, A.cchunk, A.ncols)
    p = kernels.band_sym_plain(d, lv0.dvec, x, A.shift0, A.cchunk, A.ncols)
    row = dict(
        name="band_sym", err=float((k - p).abs().max()), rel=rel_err(k, p),
        ms=median_ms(lambda: kernels.band_sym(d, lv0.dvec, x, A.shift0,
                                              A.cchunk, A.ncols), reps=9),
        plain_ms=median_ms(lambda: kernels.band_sym_plain(
            d, lv0.dvec, x, A.shift0, A.cchunk, A.ncols), reps=5),
        bound=bound_ms(d.numel() * d.element_size() + 3 * 4 * A.ncols,
                       4.0 * NT * R * W),
        library_ms=None)
    print(f"large-path band_sym {tuple(d.shape)}: max abs err {row['err']:.3e}"
          f" (rel {row['rel']:.3e}), {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms by "
          f"{row['bound'][1]})", flush=True)
    if not row["rel"] <= TOL:
        fail("band_sym disagrees with its plain version on the live band")
    return row


def vcycle_asymmetry(torch, amg) -> float:
    """|r2.M r1 - r1.M r2| / |r2.M r1| for the V-cycle M of ``amg`` on two
    random vectors: 0 for a symmetric preconditioner up to rounding."""
    from xfemm_tpu_torch.ops import band
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    r1 = torch.randn(amg.n, generator=gen, device="cuda")
    r2 = torch.randn(amg.n, generator=gen, device="cuda")
    a = float(r2.double() @ band.band_vcycle(amg, r1).double())
    b = float(r1.double() @ band.band_vcycle(amg, r2).double())
    return abs(a - b) / abs(a)


def all_f32(amg):
    """``amg`` with every band in f32 and no bf16 smoothing copies."""
    import dataclasses

    def f32(bm):
        return None if bm is None else dataclasses.replace(
            bm, dense=bm.dense.float())

    return dataclasses.replace(amg, levels=tuple(
        dataclasses.replace(lv, A=f32(lv.A), P=f32(lv.P), Abf=None)
        for lv in amg.levels))


def small_vcycle(torch) -> None:
    """The V-cycle with a triu fine level inside a whole solve, card
    against CPU: Temp.fem at a 1.5e8-byte plan (the JAX package's
    two-grid V-cycle regime), with the port's SYM_MIN_BYTES set to 0 for
    this check only so that its 70 MB band is stored triu; solved twice
    (the second solve refreshes the triu band's values).

    The card may take at most 1.3x the CPU path's CG iterations. There
    is no lower bound: the fine level's bf16 smoothing copy and bf16
    prolongator make this V-cycle non-symmetric (printed: its symmetry
    defect as built and with those bands in f32), so CG stalls near 3e-4
    in each pass, and where a pass ends then turns on the fp32 summation
    order (printed: the CPU path's count at one torch thread). These
    solves run the host Newton chain (``XFEMM_TPU_NO_DEVICE_NEWTON=1``),
    as the bound was set on it; ``small_vcycle_loop`` holds the device
    loop on the same plan."""
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import band, solver

    fx = os.path.join(HERE, "tests", "fixtures")
    old = band.SYM_MIN_BYTES
    band.SYM_MIN_BYTES = 0
    print("small V-cycle check (host chain): band.SYM_MIN_BYTES set to 0 "
          "(triu storage of the 70 MB Temp band)", flush=True)
    threads = torch.get_num_threads()
    os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
    try:
        clear_solver_caches(torch)
        mesh = read_mesh_files(os.path.join(fx, "Temp"))
        sols = {}
        for dev in ("cuda", "cpu"):
            prob = femfile.load(os.path.join(fx, "Temp.fem"))
            sols[dev] = [magnetostatics.solve(prob, mesh, device=dev,
                                              hbm_bytes=1.5e8)
                         for _ in range(2)]
        state = next(v for v in solver._BAND_CACHE.values()
                     if v["band_amg"].levels[0].A.dense.is_cuda)
        amg = state["band_amg"]
        lv0 = amg.levels[0]
        print(f"  card plan: fine band {tuple(lv0.A.dense.shape)} triu="
              f"{lv0.dvec is not None}, levels {len(amg.levels)}, bt "
              f"{state['bt']}", flush=True)
        if lv0.dvec is None or state["bt"] is not None:
            fail("the small V-cycle check did not run a triu V-cycle")
        for k in range(2):
            a, c = sols["cuda"][k], sols["cpu"][k]
            d = float(abs(a.A - c.A).max() / abs(c.A).max())
            print(f"  solve {k + 1}: card vs CPU max rel diff {d:.3e}, CG "
                  f"iterations {a.iterations} / {c.iterations} (ratio "
                  f"{a.iterations / c.iterations:.3f}), residuals "
                  f"{a.residual:.2e} / {c.residual:.2e}", flush=True)
            if not (d <= TOL and a.residual <= 1e-8):
                fail("card and CPU path disagree on the triu V-cycle solve")
            if not a.iterations <= 1.3 * c.iterations:
                fail("the card took more than 1.3x the CPU path's CG "
                     "iterations on the triu V-cycle solve")
        print(f"  V-cycle symmetry defect |r2.M r1 - r1.M r2| / |r2.M r1|: "
              f"{vcycle_asymmetry(torch, amg):.3e} as built, "
              f"{vcycle_asymmetry(torch, all_f32(amg)):.3e} with every band "
              f"f32 and no bf16 copy", flush=True)
        del amg, lv0, state
        clear_solver_caches(torch)
        torch.set_num_threads(1)
        one = magnetostatics.solve(
            femfile.load(os.path.join(fx, "Temp.fem")), mesh, device="cpu",
            hbm_bytes=1.5e8)
        print(f"  CPU path at 1 torch thread (default {threads}): CG "
              f"iterations {one.iterations}, residual {one.residual:.2e}",
              flush=True)
    finally:
        del os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"]
        torch.set_num_threads(threads)
        band.SYM_MIN_BYTES = old
        clear_solver_caches(torch)


def small_vcycle_loop(torch) -> None:
    """The device Newton loop on the triu V-cycle plan of
    ``small_vcycle`` (``newton.run``: the delta sidecar over a triu band,
    inner V-cycle PCG), card against CPU, cold and again: both engage
    the loop, reach the contract residual and agree on A within TOL. The
    CG counts are printed, not bounded: on this non-symmetric V-cycle
    each of the loop's inner solves stalls near its f32 floor, where the
    count follows the rounding (the CPU path itself takes 391 to 570 by
    its thread count; tests/test_torch_newton_solve.py)."""
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import band
    from xfemm_tpu_torch.utils import profiling

    fx = os.path.join(HERE, "tests", "fixtures")
    old = band.SYM_MIN_BYTES
    band.SYM_MIN_BYTES = 0
    os.environ["XFEMM_TPU_NEWTON_DEBUG"] = "1"   # one line per iteration
    try:
        clear_solver_caches(torch)
        mesh = read_mesh_files(os.path.join(fx, "Temp"))
        sols = {}
        for dev in ("cuda", "cpu"):
            prob = femfile.load(os.path.join(fx, "Temp.fem"))
            sols[dev] = []
            for label in ("cold", "again"):
                with NewtonRecorder(torch) as rec:
                    sol = magnetostatics.solve(prob, mesh, device=dev,
                                               hbm_bytes=1.5e8)
                sols[dev].append(sol)
                print(f"small V-cycle, device loop, {dev} {label}: CG "
                      f"iterations {sol.iterations}, residual "
                      f"{sol.residual:.2e}; {rec.summary(profiling)}; per "
                      f"run (steps, CG): {[d[1:3] for d in rec.dev]}",
                      flush=True)
                if not rec.dev or sol.residual > 1e-8:
                    fail("the triu V-cycle solve did not run the device "
                         "loop to the contract residual")
        for k in range(2):
            a, c = sols["cuda"][k], sols["cpu"][k]
            d = float(abs(a.A - c.A).max() / abs(c.A).max())
            print(f"  solve {k + 1}: card vs CPU max rel diff {d:.3e}, CG "
                  f"iterations {a.iterations} / {c.iterations}", flush=True)
            if not d <= TOL:
                fail("card and CPU path disagree on the triu V-cycle solve "
                     "with the device loop")
    finally:
        del os.environ["XFEMM_TPU_NEWTON_DEBUG"]
        band.SYM_MIN_BYTES = old
        clear_solver_caches(torch)


def main() -> None:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--large-only", action="store_true")
    args = ap.parse_args()
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
    if args.kernels_only:
        print("--kernels-only: stopping after the kernel checks", flush=True)
        return
    rows, launches = [], []
    if not args.large_only:
        rows, launches = small_path(torch)
    large_launches, amg, bt = large_path(torch, LARGE_NODES)
    check_live_hierarchy(torch, amg, bt)
    rows.insert(1, measure_band_sym(torch, amg.levels[0]))
    measure_large_cg(torch, amg, bt)
    del amg, bt
    clear_solver_caches(torch)
    small_vcycle(torch)
    small_vcycle_loop(torch)
    if args.large_only:
        print("--large-only: no result line", flush=True)
        return
    out = []
    for r in rows:
        # each main path ran with the counts set to 0 just before it and
        # read just after; a kernel's launches are the sum over them
        n_launch = sum(p[r["name"]] for p in launches) \
            + large_launches[r["name"]]
        out.append({"name": r["name"], "route": "cuda",
                    "source": SOURCES[r["name"]],
                    "replaces": REPLACES[r["name"]],
                    "launches": n_launch,
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    if any(o["launches"] == 0 for o in out):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
