"""Smoke run of the PyTorch port (xfemm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only | --large-only | --heat-elec-only
                           | --dd-only | --dist-only]

Phases (any failure exits non-zero, with no result line):

1. print the card's name and power limit (nvidia-smi) and build the
   hand-written CUDA kernels from ``xfemm_tpu_torch/ops/csrc`` with nvcc
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the band matvec (K1) at (1949, 128, 2176) in f32
   and bf16 and an R=512 band, with two columns on the R=512 band and
   the 250k one, on a bf16 prolongator band (975, 128, 352) at cchunk
   32 with one and two columns, at NT=1 and 2 and with a positive shift0
   (each launch repeated and held bit for bit, each column of a
   two-column launch held bit for bit to the one-column launch, the
   launch plan printed), the block-Thomas apply (the persistent
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
   on the card and on the CPU path and compare, and its weighted-
   stress-tensor force with the mask solved on the card and on the CPU
   path (1e-6 relative);
3b. the other planar regimes (slice 6), each through the normal entry
   points on the card with the kernels' launches counted per path: the
   device memory sizes H0 (no band storage tier) and H1 (bf16 fine
   operator) computed on the host by the port's planner for the 250k
   system and printed; the 250k problem at H0 (ELL-AMG engine, host
   Newton chain) cold and warm; the postprocessor on the 250k default
   solution (``post_250k``): ``MagPostProcessor.make_mask`` on the
   steel, a mask solve without DOF coordinates (element-block Jacobi
   CG; also on the 10k mesh if it runs past 60 s) whose Dirichlet set
   must equal the one built here node for node, then the weighted-
   stress-tensor force and torque, stored energy and area on the steel
   and a coil, ``nodal_B`` and point values, each call's host time
   printed; a 1,750-node problem
   (ELL-AMG, at most 4*ROW_TILE_MIN unknowns) on the card and the CPU
   path; the 250k problem at H1 (bf16 triu fine band, K5; GMRES
   passes, tolerated stalls, any latch-off) cold and warm, with K5
   timed on that band; previous-solution inputs at 250k (an exactly
   linear steel curve solved, written as .ans, chained with PrevType 1
   and 2 and held to the linear twin at 1e-6). Each 250k solve is held
   to the default solve's A at 1e-5 and to the contract residual;
3c. the user surfaces (slice 7) on the card: the TorqueBenchmark
   (``tests/fixtures/TorqueBenchmark.fem``, 5,130 nodes) through the
   pyFEMM verbs at rotor angles 0..90 (each torque against sin(angle)
   within 4.2e-5 and 0.006%; at 40 degrees also the CPU path), a
   femmcli-style Lua script (SUCCESS) and a checkpointed sweep whose
   resumption solves nothing, launches counted per surface; the 250k
   problem written as a .fem and solved by ``python -m xfemm_tpu_torch
   solve`` in a subprocess on its default device, its .ans held to the
   main path's A at 1e-5; the TorqueBenchmark and postprocessing paths
   together must launch K1, K2 and K3+K4;
3d. axisymmetric magnetostatics and AC (slice 8): the JAX package's
   ac125k row (``benchprob.build_ac(125_000)``, 50 Hz eddy currents)
   through ``models.solve`` cold and warm (the regime, engine calls,
   phase timers, peak memory; the residual, no latch-off to Jacobi
   pairs, launches of K1, K2 and K3+K4, and the solution against a
   host ``spsolve`` of the same complex system at 1e-6), K1 on the Ar
   and Ai bands and the shifted levels and the sweeps on the live
   factor against their plain versions (each band also timed against its
   bytes bound), K1's launches per fused GMRES cycle (2(m+1)), the complex
   apply's two two-column K1 launches in turns with four one-column
   launches (bitwise equal) and one ``torch.bmm`` per band over the
   (xr, xi) window;
   AxiSolenoid.fem refined to ~250k nodes cold and warm on the device
   loop (``newton.run`` with ``axi=True``; its cached band and factor
   held against the plain kernels) and on the host chain, within 1e-5;
   the five reference fixtures
   (AxiSolenoid, ACtest, ACwound, ACaxi, ACaxi400) on the card against
   their golden .ans and the CPU path at 1e-6, with ACwound's block
   integrals and ACaxi400's circuit properties against the reference
   femmcli's values; ACtest through the pyFEMM verbs, card against CPU
   path; the main path's K1 also timed as ``torch.bmm`` over its
   windows and against a cuSPARSE CSR SpMV of the same matrix;
3e. heat flow and electrostatics (slice 10), launches counted per path:
   the JAX package's heat230k row (``benchprob.build_heat(230_000)``,
   ~327k nodes, npz mesh cache) cold and warm on the K(T) loop
   (``newton.run_heat``, at least one step each) and on the host chain,
   each with its regime, host passes, loop dispatches (each one's
   steps, CG iterations and seconds), CG iterations, "device heat" /
   "device cg" seconds, ms per CG iteration and peak memory;
   the loop within 1e-5 of max|T| of the host chain, and a fixed point:
   within 1e-6 of a host ``spsolve`` at its own conductivity; ElecTest.fee
   with its label's MaxArea x ELEC_AREA_SCALE (~250k nodes) cold and
   warm within 1e-6 of max|V| of a host ``spsolve`` of the same system,
   conductor voltages and charges printed; each path's live band and
   factor held against the kernels' plain versions; HeatTemp0.feh and
   ElecTest.fee against their golden .anh / .res (1e-6 / 5e-6, ElecTest's
   conductor results as the golden's) and the CPU path (1e-6), the heat
   solve through the loop; both through the pyFEMM verbs, card against
   CPU path; K1, K2 and K3+K4 must launch on heat230k and elec250k
   (``--heat-elec-only`` runs phase 1 and this phase alone);
3f. domain decomposition (slice 11), launches counted per path:
   dd250k, ``magnetostatics.solve(..., devices=4)`` on the 250k problem
   cold and warm (the per-part band (P, NT, R, W) and factor b, NB, the
   host Newton passes, CG per refinement pass, the "dd" phase seconds,
   ms per CG iteration and peak memory printed; the residual, band_dd on
   every linear solve, A within 1e-5 of max|A| of the single-device
   solve, K1, K2 and K3+K4 each launched a multiple of 4 times; the live
   per-part bands and factors of the first and last part held against
   the plain versions and timed against their bytes bound); the 100k
   system of tests/test_band_dd_scaling.py at P = 2, 4, 8, 16 (CG beside
   the JAX package's, 1e-8 of a host spsolve, its(16) <= 3 its(2));
   heat230k cold (1e-5 of the K(T) loop's T), elec250k (1e-6 of the
   single-device V), AxiSolenoid / ACtest / ACwound (golden, 1e-6) and
   ac125k (the f64 complex halo PCG, 1e-6 of a host spsolve) at
   devices=4; the f64 first-generation path (halo PCG with the Schwarz
   AMG) on the 250k system's first linear system (1e-6 of a host
   spsolve); the 250k problem at A5_HBM bytes with and without
   XFEMM_TPU_COARSE_BT_SMOOTH (the levels that take a coarse factor,
   CG, peak memory; A within 1e-5; the live coarse factor's sweeps
   against the plain versions) (``--dd-only`` runs phase 1 and this
   phase alone, with its own single-device 250k reference solve, then
   warm dd250k solves in turns at two loop-driver windows,
   ``window_pairs``);
3g. the domain decomposition over a process group (slice 12), one
   process per part (``parallel/launch.spawn``, four ranks): NCCL with
   a card per rank on a machine with four cards, else gloo with the four
   ranks on the one card (printed). Each rank solves dd250k,
   ``magnetostatics.solve(..., devices=4, device_mesh=group)``, cold
   and warm (its phase seconds, ms per CG iteration and peak memory
   printed; the residual, band_dd on every linear solve, A within 1e-9
   of max|A| of phase 3f's stacked dd250k solve, the same A on every
   rank, each rank's K1, K2 and K3+K4 launched: the path's launches are
   the ranks' sum; each rank's ms per all-gather of a part vector and
   per scalar psum); rank 0 holds its live per-part band and factor
   against the plain versions; the f64 first-generation path on the
   250k first linear system over the ranks (1e-6 of a host spsolve),
   ACwound (the complex-symmetric halo PCG over the ranks) and ACtest
   (its circuit Case-2 DOFs keep the single-device path on every rank)
   against golden (1e-6), each with the same solution on every rank; a
   failing rank fails the script (``--dist-only`` runs phase 1, a
   single-device and the stacked dd250k reference solve, and this
   phase);
4. the large path (slice 2): ``benchprob.build(4_500_000)`` (4,468,229
   nodes), one cold solve on the card at the card's own memory size;
   check the planner's regime (partitioned ordering, f32 triu fine band,
   bf16 BTSmoother, band-AMG V-cycle), the residual, the launch counts,
   that the device Newton loop ran in its scatter mode
   (``newton.run_scatter``) and refreshed the fine band in place (the
   same storage throughout; the refresh timed per step); hold every
   kernel against its plain version on the live
   hierarchy and smoother (each level's K5 or K1 band, bf16 copy and
   prolongator, each timed against its bytes bound; the sweeps step by
   step, chained and repeated); time K5
   on the live fine band and the live smoother's bt_fwd and bt_qbwd
   (with both sweeps' launch plans and clock cycles per phase of a
   step), profile a few CG iterations; then the V-cycle on a small
   problem (Temp.fem at a 1.5e8-byte plan, triu storage forced for this
   check only), card against CPU, cold and again, with its CG iterations
   bounded;
   ``--large-only`` runs phases 1, 2 and 4;
5. print the ``kernels`` JSON line, the nvidia-smi line and, last,
   ``{"ok": true, "device": {...}}``.

Every path that counts launches also prints the loop driver's accounting
(``loop_report``: ``ops/loop.py``'s runs, starts, carried and masked
iterations per engine, and the masked bt_fwd launches) and fails if an
engine launched more than ``loop.IN_FLIGHT`` masked iterations per
driver run; the 250k path also times warm host-chain solves in turns at
the driver's window and at a whole drift-check chunk
(``window_pairs``).

The random inputs of phase 2 come from ``torch.Generator`` seeded with
SEED; the problems of the main paths are deterministic.
"""

from __future__ import annotations

import json
import math
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


def median_ms(fn, reps: int = 15, warmup: int = 2, batch: int = 5) -> float:
    """Median device time of one call of ``fn``: CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``, over ``reps``
    batches. Back to back, the host enqueues a call while the card runs
    the previous one, as in a solve's loop, so a wrapper's host time
    (~20 us for K1) shows only where it exceeds the device time;
    ``batch=1`` times a lone call, host time included. The inputs are
    larger than L2, so every call streams from device memory."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(y, ref) -> float:
    return float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def describe_mv_plan(kernels, dense, C: int) -> str:
    """K1's launch for ``dense`` with C columns on this card: grid,
    residency, items, ring, lanes per row, shared memory."""
    NT, R, W = dense.shape
    p = kernels._mv_plan(NT, R, W, dense.dtype, C,
                         kernels._n_sm(dense.device.index))
    per_sm = kernels.mv_blocks_per_sm(dense.dtype, C, p.smem_bytes)
    return (f"grid {p.blocks} blocks ({per_sm} resident per SM), "
            f"{p.items} items of {p.stage_rows} row(s), ring of {p.stages} "
            f"stages x {p.stage_rows * W * dense.element_size()} B, "
            f"{p.lanes_per_row} lanes per row, {p.smem_bytes} B shared "
            f"memory")


def k1_bound(dense, ncols: int, C: int = 1) -> tuple[float, str]:
    """K1's bound: the band read once, x read and y written once, 2C
    flops per band element."""
    NT, R, W = dense.shape
    return bound_ms(dense.numel() * dense.element_size()
                    + 4 * C * (ncols + NT * R), 2.0 * C * NT * R * W)


def check_band_mv(kernels, torch, gen, NT, R, W, shift0, ncols, dtype,
                  tol, cchunk=None, C=1):
    """K1 against its plain version on a random (NT, R, W) band with C
    columns, at ``tol`` of max|y|; two launches must give the same bits,
    and each column of a two-column launch the bits of the one-column
    launch on it. Prints the error, the median time against the bound and
    the launch plan."""
    cchunk = cchunk or R
    dense = torch.randn((NT, R, W), generator=gen, device="cuda") \
        .to(dtype)
    x = torch.randn((ncols, C) if C > 1 else ncols, generator=gen,
                    device="cuda")
    args = (shift0, cchunk, ncols)
    y = kernels.band_mv(dense, x, *args)
    ref = kernels.band_mv_plain(dense, x, *args)
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    same = torch.equal(y, kernels.band_mv(dense, x, *args))
    cols = C == 1 or all(
        torch.equal(y[:, c], kernels.band_mv(dense, x[:, c].contiguous(),
                                             *args)) for c in range(C))
    ms = median_ms(lambda: kernels.band_mv(dense, x, *args))
    bound, _ = k1_bound(dense, ncols, C)
    print(f"K1 band_mv ({NT},{R},{W}) {str(dtype)[6:]} C={C} "
          f"shift0={shift0} cchunk={cchunk} ncols={ncols}: max rel err "
          f"{err:.3e} (tol {tol:g}), two launches bitwise equal {same}"
          + ("" if C == 1 else f", each column bitwise the one-column "
             f"launch {cols}")
          + f"; median {ms:.4f} ms, bound {bound:.4f} ms "
          f"({100 * bound / ms:.0f}%); {describe_mv_plan(kernels, dense, C)}",
          flush=True)
    if not err <= tol:
        fail(f"band_mv disagrees with its plain version: {err:.3e}")
    if not (same and cols):
        fail(f"band_mv is not bitwise repeatable on ({NT},{R},{W}) C={C}")
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
    plain = {"bt_fwd": kernels.bt_fwd_plain(G, rs),
             "bt_qbwd": kernels.bt_bwd_plain(G, qs)}
    chain = {"bt_fwd": rel_err(ys, plain["bt_fwd"]),
             "bt_qbwd": rel_err(zs, plain["bt_qbwd"])}
    # an f32 factor's chains also in f64 from the same inputs: how far
    # the kernel and the plain version each are from the exact chain
    exact = {}
    if G.dtype == torch.float32:
        f64 = {"bt_fwd": chain64(torch, G, rs, forward=True),
               "bt_qbwd": chain64(torch, G, qs, forward=False)}
        exact = {k: (rel_err(out, f64[k]), rel_err(plain[k], f64[k]))
                 for k, out in (("bt_fwd", ys), ("bt_qbwd", zs))}
    print(f"K2 + bt_qbwd {label} b={b} NB={NB} {str(G.dtype)[6:]}: per-step "
          f"max rel err fwd {step['bt_fwd']:.3e}, qbwd {step['bt_qbwd']:.3e} "
          f"(tol {TOL:g}); chained fwd {chain['bt_fwd']:.3e}, qbwd "
          f"{chain['bt_qbwd']:.3e} (tol {chain_tol:g}); chains vs f64 "
          f"(kernel, plain): "
          f"{ {k: tuple(f'{e:.3e}' for e in v) for k, v in exact.items()} }"
          f"; two calls bitwise equal: fwd {same['bt_fwd']}, qbwd "
          f"{same['bt_qbwd']}", flush=True)
    if not max(step.values()) <= TOL:
        fail(f"a sweep kernel disagrees with its plain step on {label}")
    for name, err in chain.items():
        # a recurrence that amplifies f32 rounding past chain_tol (a long
        # chain of near-unit G_t) separates any two f32 summation
        # orders: the kernel then must be as close to the exact chain as
        # the plain version is (within 2x)
        if not (err <= chain_tol or (
                name in exact and exact[name][0] <= 2.0 * exact[name][1])):
            fail(f"the chained {name} disagrees with its plain version on "
                 f"{label}")
    for name, ok in same.items():
        if not ok:
            fail(f"{name} gave two results on the same inputs on {label}")
    return step


def chain64(torch, G, v, forward: bool):
    """The block-Thomas chain of an f32 factor in f64 on the card: the
    forward sweep y_t = v_t - G_{t-1} y_{t-1}, or the backward sweep
    z_t = v_t - G_t^T z_{t+1} of the Sinv products ``v``."""
    out = v.double().clone()
    NB = v.shape[0]
    for t in (range(1, NB) if forward else range(NB - 2, -1, -1)):
        if forward:
            out[t] -= G[t - 1].double() @ out[t - 1]
        else:
            out[t] -= G[t].double().T @ out[t + 1]
    return out


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
    # two columns (the AC complex apply's (xr, xi)) on the ac125k bands'
    # R and W, and on the 250k band
    check_band_mv(kernels, torch, gen, 488, 512, 2560, -2, 249_600 - 300,
                  torch.float32, TOL, C=2)
    check_band_mv(kernels, torch, gen, 1949, 128, 2176, -8, 249_469,
                  torch.float32, TOL, C=2)
    # a bf16 prolongator band (cchunk 32; ncols not a multiple of R, the
    # last windows past it)
    check_band_mv(kernels, torch, gen, 975, 128, 352, 0, 975 * 32 - 5,
                  torch.bfloat16, TOL, cchunk=32)
    check_band_mv(kernels, torch, gen, 975, 128, 352, 0, 975 * 32 - 5,
                  torch.bfloat16, TOL, cchunk=32, C=2)
    # the shortest bands, a positive shift0, ncols not a multiple of R
    check_band_mv(kernels, torch, gen, 1, 128, 2176, 0, 1000,
                  torch.float32, TOL)
    check_band_mv(kernels, torch, gen, 2, 128, 2176, -1, 300,
                  torch.bfloat16, TOL, C=2)
    check_band_mv(kernels, torch, gen, 3001, 256, 768, 1, 3001 * 256 - 131,
                  torch.float32, TOL, C=2)
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


def get_mesh(prob, nodes):
    """The port's mesh of ``prob``, cached under .bench_cache/ by
    ``nodes`` (the build target, or a name)."""
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
    (``solver.solve``: its CG iterations; with ``keep`` also its system
    and solution, for a host reference), every device Newton or K(T)
    dispatch (``newton.run`` / ``run_scatter`` / ``run_heat``: steps and
    CG iterations from its stats), the fine band's storage address at
    each scatter step, and the device time of each in-place band refresh
    (CUDA events, read after the solve). It wraps the modules' functions
    and restores them on exit; the kernels' launch counts are not
    touched."""

    def __init__(self, torch, keep: bool = False):
        self.torch = torch
        self.keep = keep
        self.host = []          # CG iterations per host pass
        self.systems = []       # (blocks, b, fixed, fixed_vals, x)
        self.dev = []           # (name, steps, CG its, res, relax)
        self.ptrs = []          # fine band data_ptr at each scatter step
        self.axi = []           # the axi switch of each device dispatch
        self.heat_s = []        # host seconds of each run_heat dispatch
        self._events = []       # (start, end) per in-place refresh

    def __enter__(self):
        from xfemm_tpu_torch.ops import newton, solver
        self._saved = [(solver, "solve", solver.solve),
                       (newton, "run", newton.run),
                       (newton, "run_scatter", newton.run_scatter),
                       (newton, "run_heat", newton.run_heat),
                       (newton, "_scatter_refresh", newton._scatter_refresh)]
        torch = self.torch
        real = {name: fn for _m, name, fn in self._saved}

        def solve(*a, **kw):
            out = real["solve"](*a, **kw)
            self.host.append(int(out[2]))
            if self.keep:
                self.systems.append((*a[:4], out[0]))
            return out

        def heat(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = real["run_heat"](*a, **kw)
            res, steps, cg = out[-1].tolist()
            self.heat_s.append(time.time() - t0)
            self.dev.append(("run_heat", int(steps), int(cg), res, None))
            return out

        def loop(name):
            def wrapped(dn, amg, *a, **kw):
                if name == "run_scatter":
                    self.ptrs.append(amg.levels[0].A.dense.data_ptr())
                self.axi.append(bool(kw.get("axi", False)))
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
        newton.run_heat = heat
        newton._scatter_refresh = refresh
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def refresh_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]

    def cg_rates(self, profiling) -> str:
        """"device cg" seconds per CG iteration of the host passes, and the
        loop's seconds ("device newton" or "device heat") per CG
        iteration it carried."""
        host_ms = 1e3 * profiling.phase_seconds("device cg") / max(
            sum(self.host), 1)
        out = f"device cg {host_ms:.3f} ms per host CG iteration"
        loop_cg = sum(d[2] for d in self.dev)
        if loop_cg:
            phase = "device heat" if self.heat_s else "device newton"
            loop_ms = 1e3 * profiling.phase_seconds(phase) / loop_cg
            out += (f", {phase} {loop_ms:.3f} ms per carried loop CG "
                    f"iteration")
        return out

    def summary(self, profiling) -> str:
        steps = sum(d[1] for d in self.dev)
        out = (f"host passes {len(self.host)} ({sum(self.host)} CG "
               f"iterations), device runs {len(self.dev)} "
               f"({', '.join(sorted({d[0] for d in self.dev})) or 'none'}; "
               f"{steps} steps, {sum(d[2] for d in self.dev)} CG "
               f"iterations)")
        if profiling.ENABLED:
            phase = ("device heat" if any(d[0] == "run_heat"
                                          for d in self.dev)
                     else "device newton")
            out += f", {phase} {profiling.phase_seconds(phase):.3f} s"
        return out


def reset_counts() -> None:
    """Set the kernels' launch counts and the loop driver's counts to 0,
    just before a path is driven."""
    from xfemm_tpu_torch.ops import kernels, loop
    kernels.reset_launches()
    loop.reset()


def loop_counts() -> dict:
    """The loop driver's counts since they were set to 0, per engine that
    ran: (driver runs, starts, carried iterations, masked iterations)."""
    from xfemm_tpu_torch.ops import loop
    return {e: (loop.LOOPS[e], loop.STARTS[e], loop.CARRIED[e],
                loop.MASKED[e]) for e in loop.ENGINES if loop.LOOPS[e]}


#: the engines whose preconditioner runs the sweeps: one bt_apply per
#: application (bt_pcg; band_dd per part), or per smoothing (band_pcg
#: with the BTSmoother)
BT_ENGINES = ("bt", "band", "dd-band")


def loop_report(label: str, launches: dict, counts: dict,
                per_prec: int = 1, exact: bool = False) -> None:
    """Print a path's loop accounting from ``loop_counts``: the carried
    CG iterations, the loop starts (preconditioner applications outside
    the driver: each pass's first and each restart), the driver runs and
    masked iterations per engine, and the masked bt_fwd launches,
    launches / ``per_prec`` (bt_fwd launches per preconditioner
    application) - carried - starts over BT_ENGINES. Fails if an engine
    launched more than IN_FLIGHT masked iterations per driver run; with
    ``exact`` also unless the masked bt_fwd launches are the masked
    iterations of BT_ENGINES."""
    from xfemm_tpu_torch.ops import loop
    bt = [counts[e] for e in BT_ENGINES if e in counts]
    carried = sum(c[2] for c in bt)
    starts = sum(c[1] for c in bt)
    masked_its = sum(c[3] for c in bt)
    masked = launches["bt_fwd"] / per_prec - carried - starts
    print(f"{label}: loop driver (IN_FLIGHT {loop.IN_FLIGHT}) per engine "
          f"(runs, starts, carried, masked) {counts}; sweep engines: "
          f"carried CG iterations {carried}, loop starts {starts}, masked "
          f"bt_fwd launches {masked:g} (bt_fwd {launches['bt_fwd']} / "
          f"{per_prec} - carried - starts; masked iterations "
          f"{masked_its})", flush=True)
    for e, (runs, _starts, _carried, m) in counts.items():
        if not 0 <= m <= loop.IN_FLIGHT * runs:
            fail(f"{label}: {e} launched {m} masked iterations over {runs} "
                 f"driver runs, above IN_FLIGHT = {loop.IN_FLIGHT} each")
    if exact and masked != masked_its:
        fail(f"{label}: {masked:g} masked bt_fwd launches, not the "
             f"{masked_its} masked iterations")


def main_path(torch, nodes: int):
    """Two solves of the nonlinear problem on the card (the device
    Newton loop); returns the launch counts and what the checks need."""
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import kernels

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
    dn = extra["dn"][0]
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
    reset_counts()
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
              f"residual {sol.residual:.3e}; {rec.summary(profiling)}; "
              f"{rec.cg_rates(profiling)}", flush=True)
        print(profiling.report(), flush=True)
        names = {d[0] for d in rec.dev}
        if chain == "device loop" and not (
                names == {"run"} and sum(d[1] for d in rec.dev) >= 1):
            fail(f"the {label} solve did not run the device Newton loop "
                 f"(newton.run, no scatter step): {rec.dev}")
        if chain == "host chain" and rec.dev:
            fail(f"the host-chain {label} solve called the device loop")
    launches = dict(kernels.LAUNCHES)
    loop_report(f"250k {chain}", launches, loop_counts(), exact=True)
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


def window_pairs(torch, prob, mesh, pairs: int = 5,
                 devices: int | None = None) -> None:
    """Warm 250k host-chain solves (with ``devices``: dd250k solves) in
    turns with the loop driver's window at IN_FLIGHT and at
    CG_CHECK_EVERY (a whole drift-check chunk in flight): wall time,
    "device cg" ("dd cg") ms per launched CG iteration (carried +
    masked + starts) and per carried one, masked iterations, medians.
    Equal times per launched iteration mean the narrow window keeps the
    card fed."""
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import band, loop
    from xfemm_tpu_torch.utils import profiling
    label, engine, phase = (("250k host chain", "bt", "device cg")
                            if devices is None else
                            ("dd250k", "dd-band", "dd cg"))
    widths = (loop.IN_FLIGHT, band.CG_CHECK_EVERY)
    rows = {w: [] for w in widths}
    os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
    profiling.ENABLED = True
    try:
        for _ in range(pairs):
            for w in widths:
                loop.IN_FLIGHT = w
                loop.reset()
                profiling.reset()
                t0 = time.time()
                magnetostatics.solve(prob, mesh, devices=devices)
                torch.cuda.synchronize()
                wall = time.time() - t0
                _runs, starts, carried, masked = loop_counts()[engine]
                cg_ms = 1e3 * profiling.phase_seconds(phase)
                rows[w].append((wall, cg_ms / (starts + carried + masked),
                                cg_ms / carried, masked))
    finally:
        loop.IN_FLIGHT = widths[0]
        loop.reset()
        profiling.ENABLED = False
        os.environ.pop("XFEMM_TPU_NO_DEVICE_NEWTON", None)
    for w, rs in rows.items():
        wall, per_launch, per_carried, masked = (
            statistics.median(r[i] for r in rs) for i in range(4))
        print(f"warm {label} in turns, window {w}: wall "
              f"{', '.join(f'{r[0]:.3f}' for r in rs)} s (median "
              f"{wall:.3f}); {phase} {per_launch:.4f} ms per launched "
              f"CG iteration, {per_carried:.4f} ms per carried one; "
              f"masked iterations {masked:g} (medians of {len(rs)})",
              flush=True)


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


def band_windows(torch, band, xs):
    """The (NT, W, C) windows of the zero-padded columns ``xs`` (ncols, C)
    that K1's band rows multiply: an ``as_strided`` view whose windows
    start every ``cchunk`` rows (``kernels.band_mv_plain``'s layout)."""
    NT, R, W = band.dense.shape
    cc = band.cchunk
    C = xs.shape[1]
    lpad = max(0, -band.shift0) * cc
    total = (NT + max(0, band.shift0) + W // cc) * cc + lpad
    xpad = torch.zeros((total, C), dtype=torch.float32, device=xs.device)
    xpad[lpad:lpad + band.ncols] = xs[:band.ncols]
    base = (band.shift0 + lpad // cc) * cc
    return xpad.as_strided((NT, W, C), (cc * C, C, 1), base * C)


def csr_spmv(torch, band, x) -> None:
    """A cuSPARSE CSR SpMV (``torch.sparse_csr_tensor @ x``) of the
    band's own matrix (its nonzero entries, in the band ordering) beside
    K1 on the same x: what the dense band format costs on this card."""
    from xfemm_tpu_torch.ops import kernels
    d = band.dense
    NT, R, W = d.shape
    t, r, w = (d != 0).nonzero(as_tuple=True)
    rows = t * R + r
    cols = (t + band.shift0) * band.cchunk + w
    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), d[t, r, w],
                                (NT * R, band.ncols)).coalesce() \
        .to_sparse_csr()
    y = A @ x
    k = kernels.band_mv(d, x, band.shift0, band.cchunk, band.ncols)
    ms = median_ms(lambda: A @ x)
    k_ms = median_ms(lambda: kernels.band_mv(d, x, band.shift0, band.cchunk,
                                             band.ncols))
    nbytes = A._nnz() * 8 + 4 * (NT * R + 1) + 8 * band.ncols
    print(f"main-path cuSPARSE CSR SpMV of the band's matrix: {A._nnz()} "
          f"nonzeros ({nbytes / 1e6:.1f} MB of CSR and vectors, band "
          f"{d.numel() * d.element_size() / 1e9:.3f} GB), median "
          f"{ms:.4f} ms (CSR bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms) vs K1 {k_ms:.4f} ms; rel diff {rel_err(y, k):.3e}",
          flush=True)
    del A, t, r, w, rows, cols
    torch.cuda.empty_cache()


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
    # the one-call library equivalent: torch.bmm over the windows of the
    # zero-padded x (an as_strided view, no copy)
    win = band_windows(torch, band, x[:, None])
    lib_y = torch.bmm(d, win)[:, :, 0].reshape(-1)
    lone = median_ms(lambda: kernels.band_mv(d, x, band.shift0, band.cchunk,
                                             band.ncols), batch=1)
    print(f"main-path K1 library torch.bmm(band, x windows): rel diff to "
          f"K1 {rel_err(lib_y, k):.3e}; K1 lone call (host time included) "
          f"{lone:.4f} ms; K1 {describe_mv_plan(kernels, d, 1)}", flush=True)
    rows.append(dict(
        name="band_mv", err=float((k - p).abs().max()), rel=rel_err(k, p),
        ms=median_ms(lambda: kernels.band_mv(d, x, band.shift0, band.cchunk,
                                             band.ncols)),
        plain_ms=median_ms(lambda: kernels.band_mv_plain(
            d, x, band.shift0, band.cchunk, band.ncols), reps=7),
        bound=bound_ms(d.numel() * d.element_size() + 4 * band.ncols
                       + 4 * NT * R, 2.0 * NT * R * W),
        library_ms=median_ms(lambda: torch.bmm(d, win))))
    csr_spmv(torch, band, x)
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
    small_stress_tensor(torch, prob, mesh, a)


def small_stress_tensor(torch, prob, mesh, sol) -> None:
    """The weighted-stress-tensor force on the steel (block integrals 18
    and 19, the mask solved by ``make_mask``) with the mask solved on the
    card and through the CPU path, on the same A: within 1e-6
    relative."""
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor
    forces = {}
    for dev in ("cuda", "cpu"):
        post = MagPostProcessor(prob, mesh, sol.A, sol.label_case,
                                device=dev)
        forces[dev] = [post.block_integral(k, {1}) for k in (18, 19)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(forces["cuda"],
                                                   forces["cpu"]))
    print(f"small problem weighted-stress-tensor force on the steel: card "
          f"{[f'{f.real:.12e}' for f in forces['cuda']]}, CPU path "
          f"{[f'{f.real:.12e}' for f in forces['cpu']]}, max rel diff "
          f"{rel:.3e} (tol 1e-6)", flush=True)
    if not rel <= 1e-6:
        fail("card and CPU path disagree on the stress-tensor force")


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
    window_pairs(torch, prob, mesh)
    host_launches = host_chain(torch, prob, mesh, sols)
    hierarchy_cost(torch, mesh)
    small_reference(torch, 10_000)
    clear_solver_caches(torch)
    return rows, {"250k device loop": launches,
                  "250k host chain": host_launches}, mesh, sols[0]


class PassRecorder:
    """Records, while active, the engine calls of the linear solves: the
    ELL-AMG and Jacobi PCG passes (``solver._pcg_amg_impl`` /
    ``_pcg_impl``), ``band.band_fgmres`` cycles (split into those inside
    a device Newton run and the host refinement passes), and the
    solver's trace messages (tolerated bf16 stalls, latch-offs). It
    wraps the functions and restores them on exit; the fine level of
    the first GMRES cycle is kept for the kernel timing."""

    def __init__(self):
        self.amg = []           # CG iterations per ELL-AMG pass
        self.jacobi = []        # CG iterations per Jacobi pass
        self.fgmres_loop = 0
        self.fgmres_host = 0
        self.messages = []
        self.lv0 = None
        self._in_loop = 0

    def __enter__(self):
        from xfemm_tpu_torch.ops import band, newton, solver
        self._saved = [(solver, "_pcg_amg_impl", solver._pcg_amg_impl),
                       (solver, "_pcg_impl", solver._pcg_impl),
                       (band, "band_fgmres", band.band_fgmres),
                       (newton, "run", newton.run),
                       (solver, "_trace", solver._trace)]
        real = {name: fn for _m, name, fn in self._saved}

        def pcg(name, rec):
            def wrapped(*a, **kw):
                out = real[name](*a, **kw)
                rec.append(int(out[2]))
                return out
            return wrapped

        def fgmres(amg, *a, **kw):
            if self.lv0 is None:
                self.lv0 = amg.levels[0]
            if self._in_loop:
                self.fgmres_loop += 1
            else:
                self.fgmres_host += 1
            return real["band_fgmres"](amg, *a, **kw)

        def run(*a, **kw):
            self._in_loop += 1
            try:
                return real["run"](*a, **kw)
            finally:
                self._in_loop -= 1

        def trace(msg):
            self.messages.append(msg)
            real["_trace"](msg)

        solver._pcg_amg_impl = pcg("_pcg_amg_impl", self.amg)
        solver._pcg_impl = pcg("_pcg_impl", self.jacobi)
        band.band_fgmres = fgmres
        newton.run = run
        solver._trace = trace
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def count(self, text: str) -> int:
        return sum(text in m for m in self.messages)


def band_tiers(torch, prob, mesh):
    """The device memory sizes at which the port's planner, on this host,
    finds no band storage tier for the 250k system (H0) and picks the
    bf16 fine operator (H1). Below a few GB the ordering is always the
    RCB-partitioned one, so the three storage estimates of that ordering
    (full f32, triu f32, triu bf16; ``plan_band_hierarchy``'s tiers at
    0.375, 0.69 and 0.5 of the memory size) bound both windows; each
    choice is confirmed with the planner itself."""
    import numpy as np

    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import assembly, band, solver

    pk = magnetostatics.pack(prob, mesh)
    geom = assembly.tri_geometry(pk.xy, pk.tris)
    Mx, My, _ = assembly.curl_matrices(geom)
    blocks = magnetostatics._element_blocks(pk, Mx + My)
    At = solver.Session().csr_values(blocks, pk.nreduced, pk.fixed_mask)
    coords = np.zeros((pk.nreduced, 2))
    coords[pk.ridx] = pk.xy

    def plan(hbm):
        perm, part, _g = solver.pick_band_order(At, coords, hbm)
        Ap = At[perm][:, perm].tocsr()
        Ap.sum_duplicates()
        return Ap, part, solver.plan_band_hierarchy(Ap, part, hbm)

    Ap, part, _p = plan(2e9)
    est = [solver._band_bytes_estimate(Ap, band.ROW_TILE, sym, item)
           for sym, item in ((False, 4), (True, 4), (True, 2))]
    hi = min(est[0] / 0.375, est[1] / 0.69)
    h0 = 0.9 * min(hi, est[2] / 0.5)
    h1 = 0.97 * hi
    print(f"band tiers of the 250k system (partitioned={part}): estimates "
          f"full f32 {est[0]:.4e}, triu f32 {est[1]:.4e}, triu bf16 "
          f"{est[2]:.4e} bytes; no tier below {min(hi, est[2] / 0.5):.4e}, "
          f"bf16 in [{est[2] / 0.5:.4e}, {hi:.4e}); H0 = {h0:.4e}, "
          f"H1 = {h1:.4e} bytes", flush=True)
    if not (part and est[2] / 0.5 < h1):
        fail("the 250k system has no bf16 window below 2 GB")
    if plan(h0)[2] is not None:
        fail(f"the planner found a storage tier at H0 = {h0:.4e}")
    p1 = plan(h1)[2]
    if p1 is None or p1["fine_dtype"] != "bf16":
        fail(f"the planner did not pick the bf16 fine operator at H1 = "
             f"{h1:.4e}: {p1}")
    print(f"  plan at H1: {p1}", flush=True)
    return h0, h1


def session_of(device: str):
    from xfemm_tpu_torch.models import magnetostatics
    return next(v[2]["sess"] for k, v in magnetostatics._PACK_CACHE.items()
                if k[1] == device)


def regime_solves(torch, prob, mesh, hbm, label, A_ref):
    """A cold and a warm 250k solve on the card at the memory size
    ``hbm``, launches counted from 0 over both; prints time, Newton and
    CG iterations, ms per host CG iteration, residual and the distance
    to ``A_ref`` (the default solve), and checks residual and distance.
    Returns (launches, the two recorders, session)."""
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    profiling.ENABLED = True
    reset_counts()
    recs = []
    try:
        for phase in ("cold", "warm"):
            profiling.reset()
            with NewtonRecorder(torch) as rec, PassRecorder() as prec:
                t0 = time.time()
                sol = magnetostatics.solve(prob, mesh, hbm_bytes=hbm)
                torch.cuda.synchronize()
                dt = time.time() - t0
            recs.append((rec, prec))
            cg_s = profiling.phase_seconds("device cg")
            host_cg = max(sum(rec.host), 1)
            dA = float(abs(sol.A - A_ref).max() / abs(A_ref).max())
            print(f"{label}, {phase} solve: {dt:.3f} s, Newton iterations "
                  f"{sol.newton_iterations}, CG iterations "
                  f"{sol.iterations}, residual {sol.residual:.3e}; "
                  f"{rec.summary(profiling)}; device cg {cg_s:.3f} s = "
                  f"{1e3 * cg_s / host_cg:.3f} ms per host CG iteration; "
                  f"max|A - A_default| / max|A_default| {dA:.3e}",
                  flush=True)
            print(profiling.report(), flush=True)
            if not sol.residual <= prob.Precision:
                fail(f"{label}: residual {sol.residual:.3e}")
            if not dA <= 1e-5:
                fail(f"{label}: the solution is {dA:.3e} from the default "
                     f"solve's")
    finally:
        profiling.ENABLED = False
    launches = dict(kernels.LAUNCHES)
    print(f"{label}: launches over both solves {launches}", flush=True)
    loop_report(label, launches, loop_counts())
    return launches, recs, session_of("cuda")


def ell_amg_path(torch, prob, mesh, h0, A_ref):
    """Phase: the 250k problem at H0, where no band storage tier fits:
    the ELL-AMG engine on the card through the host Newton chain."""
    launches, recs, sess = regime_solves(torch, prob, mesh, h0,
                                         "ELL-AMG 250k", A_ref)
    amg = sess.amg
    if sess.band_amg is not None or amg is None:
        fail("the ELL-AMG phase did not run the ELL-AMG engine")
    if not (amg.coarse_inv.is_cuda and all(
            lv.ell_vals.is_cuda for lv in amg.levels)):
        fail("the ELL-AMG hierarchy is not on the card")
    for phase, (rec, prec) in zip(("cold", "warm"), recs):
        if rec.dev or prec.jacobi or not prec.amg:
            fail(f"ELL-AMG {phase}: device loop {rec.dev}, Jacobi "
                 f"{prec.jacobi}, ELL-AMG passes {prec.amg}")
        print(f"  ELL-AMG {phase}: passes (CG iterations) {prec.amg}",
              flush=True)
    print(f"  levels {[tuple(lv.ell_vals.shape) for lv in amg.levels]}, "
          f"bottom {tuple(amg.coarse_inv.shape)}", flush=True)
    return launches


def standin_mask_bcs(mesh):
    """The mask's Dirichlet set built here, apart from
    ``post/fpproc.py``: the nodes of the steel label fixed at 1, the
    coils' nodes and the outer boundary at 0 unless already 1."""
    import numpy as np
    N = mesh.num_nodes
    tris = mesh.elements
    lab = mesh.element_labels
    fixed = np.zeros(N, bool)
    vals = np.zeros(N)
    sel = tris[lab == 1].ravel()             # steel (label 1)
    fixed[sel] = True
    vals[sel] = 1.0
    coil = tris[(lab == 2) | (lab == 3)].ravel()
    coil = coil[vals[coil] != 1.0]
    fixed[coil] = True
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    uniq, cnt = np.unique(edges, axis=0, return_counts=True)
    outer = uniq[cnt == 1].ravel()
    outer = outer[vals[outer] != 1.0]
    fixed[outer] = True
    return fixed, vals


class SolveResults:
    """Records, while active, what each ``solver.solve`` call returned
    (relative residual, CG iterations) and its host seconds."""

    def __enter__(self):
        from xfemm_tpu_torch.ops import solver
        self.calls = []
        self._real = real = solver.solve

        def solve(*a, **kw):
            t0 = time.time()
            out = real(*a, **kw)
            self.calls.append((float(out[1]), int(out[2]),
                               time.time() - t0))
            return out

        solver.solve = solve
        return self

    def __exit__(self, *exc):
        from xfemm_tpu_torch.ops import solver
        solver.solve = self._real
        return False


def jacobi_solve(torch, post, label):
    """The weighted-stress-tensor mask of the steel (label 1) through
    ``MagPostProcessor.make_mask`` on the card: a mask solve without DOF
    coordinates (element-block Jacobi CG). Checks its Dirichlet set
    against ``standin_mask_bcs`` node for node, the residual,
    independently on the host, and the maximum principle. Returns
    (seconds, launches, mask)."""
    import numpy as np

    from xfemm_tpu_torch.ops import assembly, kernels, solver
    mesh = post.mesh
    N = mesh.num_nodes
    fixed, vals = post._mask_bcs({1})
    sf, sv = standin_mask_bcs(mesh)
    if not (np.array_equal(fixed, sf) and np.array_equal(vals, sv)):
        fail(f"make_mask's Dirichlet set ({label}) differs from the "
             f"stand-in's")
    t0 = time.time()
    post._mask_bcs({1})
    bcs_s = time.time() - t0
    kernels.reset_launches()
    solver.MASKED["jacobi"] = 0
    with PassRecorder() as prec, SolveResults() as rec:
        t0 = time.time()
        x = post.make_mask({1})
        torch.cuda.synchronize()
        dt = time.time() - t0
    (res, its, solve_s), = rec.calls
    # the solver's metric recomputed from an independent host assembly:
    # free rows r = -(A x), fixed rows exact; res0 over the eliminated
    # right-hand side (free rows -A[:, fixed] vals, fixed rows vals)
    tris = mesh.elements
    Mx, My, _ = assembly.curl_matrices(assembly.tri_geometry(mesh.nodes,
                                                             tris))
    A = solver.blocks_to_csr([solver.ElementBlock(
        idx=tris, sign=np.ones(tris.shape), mat=-(Mx + My))], N)
    free = ~fixed
    r = -(A @ x)[free]
    d = np.asarray(A.diagonal())[free]
    b0 = A[free][:, fixed] @ vals[fixed]
    check = float(np.sqrt(np.dot(r / d, r) / (np.dot(b0 / d, b0)
                                              + np.dot(vals, vals))))
    print(f"Jacobi {label} make_mask ({N} nodes, {int(free.sum())} free; "
          f"Dirichlet set equal to the stand-in's): {dt:.3f} s (of it "
          f"solver.solve {solve_s:.3f} s; the Dirichlet set alone "
          f"{bcs_s:.3f} s), "
          f"CG iterations {its}, refinement passes {len(prec.jacobi)} "
          f"({prec.jacobi}), residual {res:.3e} (host check {check:.3e}), "
          f"masked iterations {solver.MASKED['jacobi']}, x in "
          f"[{x.min():.6f}, {x.max():.6f}]", flush=True)
    if not (res <= 1e-8 and check <= 2e-8 and prec.jacobi
            and not prec.amg):
        fail(f"the Jacobi mask solve ({label}) failed")
    if not (x.min() >= -1e-6 and x.max() <= 1.0 + 1e-6):
        fail("the mask solution leaves [0, 1]")
    return dt, dict(kernels.LAUNCHES), x


def jacobi_path(torch, post):
    """Element-block Jacobi CG at 250k (coords=None) through
    ``make_mask``; the 10k mesh too when the 250k solve runs past 60
    s. Returns (seconds, launches, the mask) of the 250k solve."""
    import numpy as np
    dt, launches, mask = jacobi_solve(torch, post, "250k")
    if dt > 60.0:
        from xfemm_tpu_torch.mesh import mesher
        from xfemm_tpu_torch.models import benchprob
        from xfemm_tpu_torch.post.fpproc import MagPostProcessor
        print(f"the 250k Jacobi mask solve ran {dt:.1f} s (past 60 s): "
              f"the 10k mesh as well", flush=True)
        prob = benchprob.build(10_000)
        mesh = mesher.mesh_problem(prob)
        jacobi_solve(torch, MagPostProcessor(
            prob, mesh, np.zeros(mesh.num_nodes)), "10k")
    return dt, launches, mask


#: points of the 250k postprocessing phase: steel, coil+, air
POST_POINTS = ((0.0, 0.0), (0.575, 0.0), (0.0, 0.9))
#: a line through the air above the steel and coils
POST_LINE = ((-0.5, 0.7), (0.5, 0.7))


def post_250k(torch, prob, mesh, sol):
    """Phase: the postprocessor on the 250k default solution, on the
    card: the steel's mask through ``make_mask`` (Jacobi, checked as
    above), then every block integral type (0-25) on the steel, among
    them the weighted-stress-tensor force (18, 19) and torque (22),
    stored energy (2) and area (5), those five on one coil (its own
    mask), ``nodal_B``, point values at three points and the line
    integrals of B.n (0) and the Maxwell stress force (3) along a line
    in the air; every call's host time printed, every result finite.
    Returns the launches of the phase."""
    import numpy as np

    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor
    times = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.time() - t0
        parts = list(out.values()) if isinstance(out, dict) else (
            list(out) if isinstance(out, tuple) else [out])
        if not parts or not all(np.isfinite(np.asarray(v)).all()
                                for v in parts):
            fail(f"250k postprocessing: {name} gave {out!r:.200}")
        return out

    t0 = time.time()
    post = MagPostProcessor(prob, mesh, sol.A, sol.label_case)
    times["MagPostProcessor()"] = time.time() - t0
    dt, launches, mask = jacobi_path(torch, post)
    times["make_mask (steel)"] = dt
    kernels.reset_launches()
    post._mask = mask
    vals = {}
    for lab, name, types in ((1, "steel", range(26)),
                             (2, "coil+", (18, 19, 22, 2, 5))):
        if lab != 1:
            post._mask = timed(f"make_mask ({name})",
                               lambda: post.make_mask({lab}))
        for k in types:
            vals[(name, k)] = timed(f"block_integral({k}) {name}",
                                    lambda: post.block_integral(k, {lab}))
    nb = timed("nodal_B", post.nodal_B)
    for x, y in POST_POINTS:
        vals[(x, y)] = timed(f"get_point_values({x}, {y})",
                             lambda: post.get_point_values(x, y))
    for k in (0, 3):
        vals[("line", k)] = timed(f"line_integral({k}) {POST_LINE}",
                                  lambda: post.line_integral(k, POST_LINE))
    for k, v in launches.items():
        launches[k] = v + kernels.LAUNCHES[k]
    print("250k postprocessing on the card (host seconds per call):",
          flush=True)
    for name, dt in times.items():
        print(f"  {name}: {dt:.3f} s", flush=True)
    for name in ("steel", "coil+"):
        print(f"  {name}: force ({vals[(name, 18)].real:.9e}, "
              f"{vals[(name, 19)].real:.9e}) N, torque "
              f"{vals[(name, 22)].real:.9e} N m, energy "
              f"{vals[(name, 2)].real:.9e} J, area "
              f"{vals[(name, 5)].real:.9e} m^2", flush=True)
    for x, y in POST_POINTS:
        pv = vals[(x, y)]
        print(f"  point ({x}, {y}): A {complex(pv['A']).real:.9e}, B "
              f"({complex(pv['B1']).real:.9e}, {complex(pv['B2']).real:.9e}) T",
              flush=True)
    print(f"  line {POST_LINE}: B.n flux {vals[('line', 0)]}, Maxwell "
          f"stress force {vals[('line', 3)]}", flush=True)
    print(f"  nodal_B: {len(nb)} arrays of {np.shape(nb[0])}; launches "
          f"{launches}", flush=True)
    return launches


def tiny_path(torch) -> None:
    """Phase: a problem at or below 4*ROW_TILE_MIN unknowns (ELL-AMG) on
    the card and through the CPU path, A compared to TOL of max|A|."""
    from xfemm_tpu_torch.mesh import mesher
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import solver
    mesh = mesher.mesh_problem(benchprob.build(1500))
    sols = {}
    for dev in ("cuda", "cpu"):
        clear_solver_caches(torch)
        with PassRecorder() as prec:
            sols[dev] = magnetostatics.solve(benchprob.build(1500), mesh,
                                             device=dev)
        if not prec.amg or prec.jacobi:
            fail(f"the small problem did not take ELL-AMG on {dev}")
    a, c = sols["cuda"], sols["cpu"]
    d = float(abs(a.A - c.A).max() / abs(c.A).max())
    print(f"small problem ({mesh.num_nodes} nodes; the band engine starts "
          f"above {4 * solver.ROW_TILE_MIN} unknowns): card vs CPU max "
          f"rel diff {d:.3e}, CG iterations {a.iterations} / "
          f"{c.iterations}, residuals {a.residual:.2e} / {c.residual:.2e}",
          flush=True)
    if not (mesh.num_nodes <= 4 * solver.ROW_TILE_MIN and d <= TOL
            and a.residual <= 1e-8):
        fail("card and CPU path disagree on the small problem")
    clear_solver_caches(torch)


def bf16_path(torch, prob, mesh, h1, A_ref):
    """Phase: the 250k problem at H1, the bf16 fine operator (triu band,
    K5): cold and warm; the device loop's GMRES cycles, the host
    ``band_fgmres`` passes, the tolerated stalls and any latch-off; K5
    timed on that band against its plain version and bound."""
    from xfemm_tpu_torch.ops import kernels
    launches, recs, sess = regime_solves(torch, prob, mesh, h1,
                                         "bf16 250k", A_ref)
    if sess.plan is None or sess.plan["fine_dtype"] != "bf16":
        fail(f"the bf16 phase planned {sess.plan}")
    for phase, (rec, prec) in zip(("cold", "warm"), recs):
        steps = sum(d[1] for d in rec.dev)
        print(f"  bf16 {phase}: device runs {len(rec.dev)} ({steps} steps, "
              f"{prec.fgmres_loop} GMRES(24) cycles in the loop), host "
              f"band_fgmres passes {prec.fgmres_host}, tolerated bf16 "
              f"stalls {prec.count('tolerated')}, latch-offs "
              f"{prec.count('latched off')} (then ELL-AMG passes "
              f"{prec.amg}), factor drops {prec.count('dropping')}",
              flush=True)
    lv0 = recs[0][1].lv0
    if lv0 is None or lv0.A.dense.dtype != torch.bfloat16 \
            or lv0.dvec is None:
        fail("the bf16 phase ran no GMRES cycle on a bf16 triu band")
    if launches["band_sym"] == 0:
        fail("K5 was not launched on the bf16 band")
    A = lv0.A
    d = A.dense
    NT, R, W = d.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    x = torch.randn(A.ncols, generator=gen, device="cuda")
    args = (A.shift0, A.cchunk, A.ncols)
    k = kernels.band_sym(d, lv0.dvec, x, *args)
    p = kernels.band_sym_plain(d, lv0.dvec, x, *args)
    err = rel_err(k, p)
    ms = median_ms(lambda: kernels.band_sym(d, lv0.dvec, x, *args))
    plain = median_ms(lambda: kernels.band_sym_plain(d, lv0.dvec, x, *args),
                      reps=7)
    bound = bound_ms(d.numel() * d.element_size() + 3 * 4 * A.ncols,
                     4.0 * NT * R * W)
    print(f"bf16 250k fine band {tuple(d.shape)} K5: max rel err {err:.3e} "
          f"(tol {TOL:g}), {ms:.4f} ms (plain {plain:.4f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]})", flush=True)
    if not err <= TOL:
        fail("K5 disagrees with its plain version on the bf16 band")
    del lv0, A, d, k, p, x, recs, sess
    clear_solver_caches(torch)
    return launches


MUR = 500.0


def linear_steel(prob, twin: bool):
    """The steel of ``prob`` with an exactly linear B-H curve of relative
    permeability MUR (``twin``: the genuinely linear material)."""
    from xfemm_tpu_torch.constants import MU0
    from xfemm_tpu_torch.materials.magnetic import MagneticMaterial
    if twin:
        prob.blockproplist[1] = MagneticMaterial(name="Steel", mu_x=MUR,
                                                 mu_y=MUR)
        return prob
    steel = prob.blockproplist[1]
    steel.Bdata, steel.Hdata, steel.slope = [], [], []
    for b in (0.0, 0.5, 1.0, 1.5, 2.0, 2.5):
        steel.Bdata.append(b)
        steel.Hdata.append(complex(b / (MU0 * MUR)))
    return prob


def prevsoln_path(torch, mesh):
    """Phase: previous-solution inputs at 250k, the static linear-limit
    identity: with an exactly linear B-H curve the incremental (PrevType
    1) and frozen (2) permeabilities about any solution equal MUR, so
    the solves chained from the written .ans match the linear twin."""
    from xfemm_tpu_torch.io import ansfile
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import kernels

    clear_solver_caches(torch)
    reset_counts()
    path = os.path.join(HERE, ".bench_cache", "prevsoln_250k.ans")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.time()
    base = linear_steel(benchprob.build(NODES), twin=False)
    sol = magnetostatics.solve(base, mesh)
    t1 = time.time()
    ansfile.write_ans(ansfile.SolutionFile(
        problem=base, mesh=ansfile.solution_mesh_from_solver(mesh, 1.0),
        values=sol.A, label_case=sol.label_case), path)
    t2 = time.time()
    lin = magnetostatics.solve(linear_steel(benchprob.build(NODES), True),
                               mesh)
    scale = abs(lin.A).max()
    print(f"PrevSoln 250k: base solve {t1 - t0:.3f} s (residual "
          f"{sol.residual:.3e}), .ans written in {t2 - t1:.3f} s "
          f"({os.path.getsize(path) / 1e6:.1f} MB), linear twin residual "
          f"{lin.residual:.3e}", flush=True)
    for ptype in (1, 2):
        q = linear_steel(benchprob.build(NODES), twin=False)
        q.PrevSoln = path
        q.PrevType = ptype
        t0 = time.time()
        inc = magnetostatics.solve(q, mesh)
        dt = time.time() - t0
        d = float(abs(inc.A - lin.A).max() / scale)
        print(f"  PrevType {ptype}: {dt:.3f} s (incl. reading the .ans), "
              f"Newton iterations {inc.newton_iterations}, CG iterations "
              f"{inc.iterations}, residual {inc.residual:.3e}; max|A - "
              f"A_linear| / max|A_linear| {d:.3e} (tol 1e-6)", flush=True)
        if not (d <= 1e-6 and inc.residual <= 1e-8
                and inc.Aprev is not None):
            fail(f"the PrevType {ptype} solve misses the linear twin")
    os.remove(path)
    launches = dict(kernels.LAUNCHES)
    print(f"PrevSoln 250k launches: {launches}", flush=True)
    loop_report("PrevSoln 250k", launches, loop_counts())
    clear_solver_caches(torch)
    return launches


def regime_paths(torch, mesh, sol_ref):
    """The regimes of slice 6 on the card: ELL-AMG at 250k, Jacobi at
    250k (the postprocessor's mask solve, with the rest of the 250k
    postprocessing), a small problem, the bf16 fine operator at 250k and
    previous-solution inputs at 250k. Returns the launch counts per
    path."""
    from xfemm_tpu_torch.models import benchprob
    prob = benchprob.build(NODES)
    A_ref = sol_ref.A
    h0, h1 = band_tiers(torch, prob, mesh)
    out = {"250k ELL-AMG": ell_amg_path(torch, prob, mesh, h0, A_ref)}
    out["250k post"] = post_250k(torch, prob, mesh, sol_ref)
    tiny_path(torch)
    out["250k bf16"] = bf16_path(torch, prob, mesh, h1, A_ref)
    out["250k PrevSoln"] = prevsoln_path(torch, mesh)
    return out


TORQUE_FEM = os.path.join(HERE, "tests", "fixtures", "TorqueBenchmark.fem")

#: the femmcli-style torque script (the reference's
#: femmcli_TorqueBenchmark.lua shape) at two rotor angles
TORQUE_LUA = """
function check(value, expected, marginAbs)
    if abs(value - expected) > marginAbs then
        return 1
    end
    return 0
end
open("@FEM@")
failed = 0
for deg = 0, 30, 30 do
    mi_modifyboundprop("AGE", 10, deg)
    mi_modifyboundprop("AGE", 11, 0)
    mi_analyze()
    mi_loadsolution()
    tq = mo_gapintegral("AGE", 0)
    print(tq)
    failed = failed + check(tq, sin(deg), 0.000042)
end
assert(failed == 0)
write("SUCCESS\\n")
"""


def torque_ok(tq: float, deg: float) -> bool:
    """The reference's TorqueBenchmark contract: sin(angle) within
    4.2e-5 absolute and 0.006% relative (femmcli_TorqueBenchmark.lua)."""
    ref = math.sin(math.radians(deg))
    return abs(tq - ref) <= 4.2e-5 and (
        ref == 0 or abs(100 * (tq - ref) / ref) <= 0.006)


def femm_torque(femm, deg: float, **open_kw):
    femm.opendocument(TORQUE_FEM, **open_kw)
    femm.mi_modifyboundprop("AGE", 10, deg)
    femm.mi_modifyboundprop("AGE", 11, 0)
    femm.mi_createmesh()
    femm.mi_analyze()
    femm.mi_loadsolution()
    return femm.mo_gapintegral("AGE", 0)


def surfaces_torque(torch):
    """Phase: the TorqueBenchmark through the port's user surfaces on the
    card, each path's launches counted from 0: the pyFEMM verbs at rotor
    angles 0..90 (torque, solve time, CG iterations and launches per
    angle; at 40 degrees also the port's CPU path), the Lua interpreter
    with the femmcli-style script (angles 0 and 30; SUCCESS), and a
    checkpointed ``utils/sweep`` over three angles that a resumed sweep
    must not re-solve. Returns the launches per path."""
    import tempfile

    from xfemm_tpu_torch import femm_compat as femm
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh import mesher
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor
    from xfemm_tpu_torch.scripting import lua
    from xfemm_tpu_torch.utils import sweep

    clear_solver_caches(torch)
    os.makedirs(os.path.join(HERE, ".bench_cache"), exist_ok=True)
    out = {}
    reset_counts()
    tq40 = None
    for deg in range(0, 100, 10):
        before = sum(kernels.LAUNCHES.values())
        t0 = time.time()
        tq = femm_torque(femm, deg)
        torch.cuda.synchronize()
        dt = time.time() - t0
        raw = femm._s().raw
        print(f"TorqueBenchmark verbs {deg:2d} deg ({raw.mesh.num_nodes} "
              f"nodes): torque {tq:.12f}, - sin {tq - math.sin(math.radians(deg)):.3e}; "
              f"open + mesh + solve + post {dt:.3f} s, CG iterations "
              f"{raw.iterations}, residual {raw.residual:.2e}, launches "
              f"{sum(kernels.LAUNCHES.values()) - before}", flush=True)
        if not torque_ok(tq, deg):
            fail(f"TorqueBenchmark torque at {deg} deg misses sin(angle)")
        if deg == 40:
            tq40 = tq
    out["TorqueBenchmark verbs"] = dict(kernels.LAUNCHES)
    loop_report("TorqueBenchmark verbs", out["TorqueBenchmark verbs"],
                loop_counts())
    cpu = femm_torque(femm, 40, device="cpu",
                      hbm_bytes=torch.cuda.mem_get_info()[1])
    print(f"TorqueBenchmark 40 deg: |card - CPU path| torque "
          f"{abs(tq40 - cpu):.3e}; launches {out['TorqueBenchmark verbs']}",
          flush=True)

    kernels.reset_launches()
    lines = []
    t0 = time.time()
    lua.run_string(TORQUE_LUA.replace("@FEM@", TORQUE_FEM),
                   output=lines.append)
    print(f"TorqueBenchmark Lua script: {time.time() - t0:.3f} s, printed "
          f"{lines}", flush=True)
    if not lines or lines[-1] != "SUCCESS":
        fail("the Lua TorqueBenchmark script did not print SUCCESS")
    out["TorqueBenchmark Lua"] = dict(kernels.LAUNCHES)

    def build(deg):
        p = femfile.load(TORQUE_FEM)
        for bp in p.lineproplist:
            if bp.is_airgap():
                bp.InnerAngle = deg
        return p, mesher.mesh_problem(p)

    def torque(sol):
        return MagPostProcessor(sol.problem, sol.mesh, sol.A,
                                sol.label_case).gap_dc_torque("AGE")

    solves = []
    real = magnetostatics.solve

    def counted(*a, **kw):
        solves.append(kw)
        return real(*a, **kw)

    kernels.reset_launches()
    angles = [0.0, 10.0, 20.0]
    magnetostatics.solve = counted
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(
                HERE, ".bench_cache")) as ck:
            t0 = time.time()
            first = sweep.sweep(angles, build, torque, checkpoint=ck)
            t1 = time.time()
            n_first = len(solves)
            again = sweep.sweep(angles, build, torque, checkpoint=ck)
            t2 = time.time()
    finally:
        magnetostatics.solve = real
    print(f"TorqueBenchmark sweep {angles}: {n_first} solves in "
          f"{t1 - t0:.3f} s (warm-started), torques "
          f"{[float(first[a]) for a in angles]}; resumed: "
          f"{len(solves) - n_first} solves in {t2 - t1:.3f} s", flush=True)
    if not (n_first == 3 and len(solves) == 3 and all(
            float(again[a]) == float(first[a]) and torque_ok(float(first[a]), a)
            for a in angles)):
        fail("the checkpointed sweep re-solved or missed sin(angle)")
    out["TorqueBenchmark sweep"] = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)
    return out


def cli_250k(torch, mesh, A_ref) -> None:
    """Phase: the 250k problem written as a .fem (``femfile.dump``) and
    solved by ``python -m xfemm_tpu_torch solve`` in a subprocess on its
    default device (no ``--device``); the .ans read back with
    ``io/ansfile.read_ans`` lies on the main path's mesh, with A within
    1e-5 of max|A| of the main path's in-process solve. The kernels run
    in the subprocess, so their launches are not counted here; its
    phase timers (``XFEMM_TPU_PROFILE=1``, printed at its exit) are."""
    import tempfile

    import numpy as np

    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.io import ansfile
    from xfemm_tpu_torch.models import benchprob

    clear_solver_caches(torch)
    os.makedirs(os.path.join(HERE, ".bench_cache"), exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["XFEMM_TPU_PROFILE"] = "1"
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, ".bench_cache")) \
            as d:
        fem = os.path.join(d, "bench250k.fem")
        femfile.dump(benchprob.build(NODES), fem)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "xfemm_tpu_torch", "solve", fem],
            cwd=d, env=env, capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        if proc.returncode != 0:
            fail(f"the 250k CLI solve exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        solved = [ln for ln in proc.stdout.splitlines()
                  if ln.startswith("solved in")]
        print(f"250k CLI subprocess output:\n{proc.stdout.strip()}",
              flush=True)
        g = ansfile.read_ans(os.path.join(d, "bench250k.ans"))
        size = os.path.getsize(os.path.join(d, "bench250k.ans"))
    # what a fresh process pays before its first solve: interpreter,
    # imports of the solve path and the CUDA context
    t0 = time.time()
    subprocess.run([sys.executable, "-c", "import torch; "
                    "import xfemm_tpu_torch.models.magnetostatics; "
                    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
                   env=env, check=True, timeout=300)
    start = time.time() - t0
    print(f"250k CLI: a fresh process's start (imports of the solve path "
          f"and the CUDA context) {start:.3f} s wall", flush=True)
    dx = float(np.abs(g.mesh.nodes - mesh.nodes).max()) \
        if g.mesh.nodes.shape == mesh.nodes.shape else float("inf")
    dA = float(np.abs(np.real(g.values) - A_ref).max()
               / np.abs(A_ref).max()) if dx < 1e-9 else float("inf")
    print(f"250k CLI solve (python -m xfemm_tpu_torch solve, default "
          f"device): {wall:.3f} s wall for the subprocess; {solved}; .ans "
          f"{size / 1e6:.1f} MB, {g.mesh.num_nodes} nodes (max node offset "
          f"{dx:.1e}), max|A - A_main| / max|A_main| {dA:.3e} (tol 1e-5)",
          flush=True)
    if not (solved and dA <= 1e-5):
        fail("the 250k CLI solve misses the main path's solution")


AC_NODES = 125_000        # benchprob.build_ac target (perf/measure.py ac125k)
AXI_AREA_SCALE = 0.0151   # AxiSolenoid.fem's label MaxArea x this: ~250k nodes
FIXTURES = os.path.join(HERE, "tests", "fixtures")
AC_FIXTURES = ("AxiSolenoid", "ACtest", "ACwound", "ACaxi", "ACaxi400")
#: the reference femmcli's postprocessor values on the golden solutions
#: (tests/test_harmonic.py, tests/test_harmonicaxi.py)
REF_ACWOUND = {2: 1.273529694319e-04, 17: 1.273529694319e-04,
               4: 1.097620254739e+00,
               0: 4.848451777805e-03 - 5.719153002085e-04j, 7: 1e3}
REF_ACAXI400 = {"amps": 100 + 30j,
                "volts": -0.000240362959638525 + 0.005195904737962252j,
                "flux": 1.963352852159631e-06 + 4.47608640949693e-07j}


class ACRecorder:
    """Records, while active, what the AC solves did: every fused GMRES
    call (``band.band_csym_fgmres_fused``: restart length, factor or
    V-cycle, iterations), every Jacobi-pairs pass
    (``solver._pcg_csym_pairs``), the host refinement passes and, with
    ``keep``, each ``solver.solve_complex`` call's system and solution
    (for the host reference), and the solver's trace messages (a dropped
    factor, a latch-off). It wraps the functions and restores them."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.gmres = []         # (m, with factor, iterations)
        self.pairs = []         # iterations per Jacobi-pairs pass
        self.systems = []       # (blocks, b, fixed, fixed_vals, x)
        self.messages = []

    def __enter__(self):
        from xfemm_tpu_torch.ops import band, solver
        self._saved = [(band, "band_csym_fgmres_fused",
                        band.band_csym_fgmres_fused),
                       (solver, "_pcg_csym_pairs", solver._pcg_csym_pairs),
                       (solver, "solve_complex", solver.solve_complex),
                       (solver, "_trace", solver._trace)]
        real = {name: fn for _m, name, fn in self._saved}

        def fused(*a, m=24, bt=None, **kw):
            out = real["band_csym_fgmres_fused"](*a, m=m, bt=bt, **kw)
            self.gmres.append((m, bt is not None, int(out[3])))
            return out

        def pairs(*a, **kw):
            out = real["_pcg_csym_pairs"](*a, **kw)
            self.pairs.append(int(out[3]))
            return out

        def solve_complex(blocks, b, fixed_mask, fixed_vals, tol, **kw):
            out = real["solve_complex"](blocks, b, fixed_mask, fixed_vals,
                                        tol, **kw)
            if self.keep:
                self.systems.append((blocks, b, fixed_mask, fixed_vals,
                                     out[0]))
            return out

        def trace(msg):
            self.messages.append(msg)
            real["_trace"](msg)

        band.band_csym_fgmres_fused = fused
        solver._pcg_csym_pairs = pairs
        solver.solve_complex = solve_complex
        solver._trace = trace
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def engines(self) -> list:
        out = sorted({f"band GMRES({m})" + (" + factor" if f else
                                            " + V-cycle")
                      for m, f, _ in self.gmres})
        return out + (["Jacobi pairs"] if self.pairs else [])

    def summary(self) -> str:
        its = sum(g[2] for g in self.gmres)
        cycles = sum(g[2] // g[0] for g in self.gmres)
        return (f"engines {self.engines()}, GMRES iterations {its} in "
                f"{cycles} cycles over {len(self.gmres)} host refinement "
                f"passes, Jacobi-pairs passes {self.pairs}, "
                f"dropped factor {sum('dropping' in m for m in self.messages)}"
                f", latch-offs {sum('latched off' in m for m in self.messages)}")


def ac_entry():
    from xfemm_tpu_torch.ops import solver
    (ent,) = solver._CBAND_CACHE.values()
    return ent


def ac_host_reference(system):
    """The AC system solved on the host by ``scipy.sparse.linalg.spsolve``
    from the complex CSR assembled from the same blocks (Dirichlet rows
    as identity rows, ``b - A g`` for nonzero fixed values). Returns
    (relative distance of the solve's x, seconds)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from xfemm_tpu_torch.ops import solver
    blocks, b, fixed_mask, fixed_vals, x = system
    fixed = np.asarray(fixed_mask, bool)
    fv = np.asarray(fixed_vals, complex)
    n = len(b)
    t0 = time.time()
    At = solver._ac_csr(blocks, n, fixed)
    g = np.where(fixed, fv, 0.0)
    Ag = np.zeros(n, complex)
    for blk in blocks:
        idx = np.asarray(blk.idx)
        sgn = np.asarray(blk.sign, float)
        ye = np.einsum("ekl,el->ek", np.asarray(blk.mat, complex),
                       sgn * g[idx])
        np.add.at(Ag, idx.reshape(-1), (sgn * ye).reshape(-1))
    rhs = np.where(fixed, fv, np.asarray(b, complex) - Ag)
    ref = spla.spsolve(At.tocsc(), rhs)
    dt = time.time() - t0
    return float(np.abs(x - ref).max() / np.abs(ref).max()), dt


def ac_apply_cost(torch, ent) -> None:
    """The complex operator apply of the AC engine on its live Ar and Ai
    bands, timed in turns: the apply as it runs (``band._complex_op``:
    two two-column K1 launches, each band streamed once), the same apply
    as four one-column K1 launches (its earlier shape), one ``torch.bmm``
    per band over the two-column (xr, xi) window (the library
    yardstick), the apply again, beside the bound of one pass over both
    bands. Fails unless the apply is bitwise the four one-column launches
    and within TOL of the bmm pair."""
    from xfemm_tpu_torch.ops import band as band_mod
    from xfemm_tpu_torch.ops import kernels
    Aop, Ai = ent["Aop"], ent["Ai"]
    n = Aop.ncols
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    xr = torch.randn(n, generator=gen, device="cuda")
    xi = torch.randn(n, generator=gen, device="cuda")
    opc = band_mod._complex_op(Aop, Ai, n)
    args = (Aop.shift0, Aop.cchunk, Aop.ncols)

    def four():
        ar_xr = kernels.band_mv(Aop.dense, xr, *args)[:n]
        ar_xi = kernels.band_mv(Aop.dense, xi, *args)[:n]
        ai_xr = kernels.band_mv(Ai.dense, xr, *args)[:n]
        ai_xi = kernels.band_mv(Ai.dense, xi, *args)[:n]
        return ar_xr - ai_xi, ar_xi + ai_xr

    win = band_windows(torch, Aop, torch.stack([xr, xi], dim=1))

    def two_bmm():
        return torch.bmm(Aop.dense, win), torch.bmm(Ai.dense, win)

    before = dict(kernels.LAUNCHES)
    yr, yi = opc(xr, xi)
    fr, fi = four()
    bitwise = torch.equal(yr, fr) and torch.equal(yi, fi)
    pr, pi = two_bmm()
    pr = pr.reshape(-1, 2)[:n]
    pi = pi.reshape(-1, 2)[:n]
    err = max(rel_err(pr[:, 0] - pi[:, 1], yr), rel_err(pr[:, 1] + pi[:, 0],
                                                        yi))
    t2a = median_ms(lambda: opc(xr, xi))
    t4 = median_ms(four)
    tb = median_ms(two_bmm)
    t2b = median_ms(lambda: opc(xr, xi))
    t1 = median_ms(lambda: kernels.band_mv(Aop.dense, xr, *args))
    kernels.LAUNCHES.update(before)
    d = Aop.dense
    nbytes = d.numel() * d.element_size()
    one = nbytes / HBM_BYTES_PER_S * 1e3
    bound = 2 * one
    print(f"ac125k complex apply on the Ar/Ai bands {tuple(d.shape)} "
          f"(2 x {nbytes / 1e9:.3f} GB), in turns: two two-column K1 "
          f"launches {t2a:.4f} / {t2b:.4f} ms ({100 * bound / t2a:.0f}% / "
          f"{100 * bound / t2b:.0f}% of the one-pass bound {bound:.4f} ms); "
          f"four one-column launches {t4:.4f} ms (one alone {t1:.4f} ms, "
          f"bound {one:.4f} ms); one torch.bmm per band over the (xr, xi) "
          f"window {tb:.4f} ms; apply bitwise the four launches {bitwise}; "
          f"rel diff to the bmm pair {err:.3e} (tol {TOL:g}); plan "
          f"{describe_mv_plan(kernels, d, 2)}", flush=True)
    if not bitwise:
        fail("the two-column complex apply differs from four one-column "
             "K1 launches")
    if not err <= TOL:
        fail("the complex apply disagrees with torch.bmm")


def ac_125k(torch) -> dict:
    """Phase: the JAX package's ac125k row (``benchprob.build_ac(125_000)``,
    50 Hz, linear conductive steel, Precision 1e-8) through
    ``models.solve`` on the card, cold then warm, launches counted from 0
    over both. Prints the regime (the two operator bands, the shifted
    hierarchy's levels, the factor's b and NB, the restart length), the
    engine calls, phase timers and peak memory; holds the cold solution
    against a host ``spsolve`` of the same complex system at 1e-6;
    holds K1 on the Ar and Ai bands and every shifted level, and the
    sweeps on the live factor, against their plain versions; fails on a
    residual above Precision, a latch-off to Jacobi pairs, a kernel of
    K1, K2, K3+K4 never launched or a kernel check. Returns the
    launches."""
    import numpy as np

    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.models import benchprob
    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    t0 = time.time()
    prob = benchprob.build_ac(AC_NODES)
    mesh = get_mesh(prob, AC_NODES)
    print(f"ac125k mesh: {mesh.num_nodes} nodes, {mesh.num_elements} "
          f"elements ({time.time() - t0:.1f} s incl. cache)", flush=True)
    profiling.ENABLED = True
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sols, recs = [], []
    for label in ("cold", "warm"):
        profiling.reset()
        with ACRecorder(keep=label == "cold") as rec:
            t0 = time.time()
            sol = models.solve(prob, mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
        sols.append(sol)
        recs.append(rec)
        print(f"ac125k {label} solve: {dt:.3f} s, residual "
              f"{sol.residual:.3e}, iterations {sol.iterations}; "
              f"{rec.summary()}", flush=True)
        print(profiling.report(), flush=True)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    profiling.ENABLED = False
    ent = ac_entry()
    if ent is None or any(r.pairs for r in recs):
        fail("the ac125k solve latched off to Jacobi pairs")
    amg = ent["amg"]
    levels = [tuple(lv.A.dense.shape) for lv in amg.levels]
    triu = [lv.dvec is not None for lv in amg.levels]
    bottom = (f"dense inverse {tuple(amg.coarse_inv.shape)}"
              if amg.bt_coarse is None else f"block-tridiagonal "
              f"{tuple(amg.bt_coarse.factor.Sinv.shape)}")
    print(f"ac125k regime: operator bands Ar {tuple(ent['Aop'].dense.shape)} "
          f"and Ai {tuple(ent['Ai'].dense.shape)} (R=cchunk="
          f"{ent['Aop'].cchunk}); shifted hierarchy levels {levels} (triu "
          f"{triu}), bottom {bottom}; factor (b, NB) "
          f"{ent.get('bt_shape')} "
          f"{'kept' if ent['bt'] is not None else 'DROPPED'}; GMRES m "
          f"{sorted({g[0] for r in recs for g in r.gmres})}; peak device "
          f"memory {peak / 1e9:.2f} GB; launches over both solves "
          f"{launches}", flush=True)
    for sol in sols:
        if not sol.residual <= prob.Precision:
            fail(f"ac125k residual {sol.residual:.3e} above "
                 f"{prob.Precision:g}")
        if sol.A.shape != (mesh.num_nodes,) or not np.isfinite(sol.A).all():
            fail("ac125k A is not a finite per-node vector")
    for name in ("band_mv", "bt_fwd", "bt_qbwd"):
        if not launches[name]:
            fail(f"the ac125k solves never launched {name}")
    # with the factor each fused cycle applies the operator m + 1 times,
    # two K1 launches each, and nothing else launches K1
    cycles = sum(its // m for r in recs for m, _f, its in r.gmres)
    expect = sum(2 * (m + 1) * (its // m) for r in recs
                 for m, _f, its in r.gmres)
    print(f"ac125k K1 launches {launches['band_mv']} over {cycles} fused "
          f"cycles (2(m+1) per cycle: {expect})", flush=True)
    if (all(f for r in recs for _m, f, _i in r.gmres)
            and launches["band_mv"] != expect):
        fail(f"the ac125k solves launched K1 {launches['band_mv']} times, "
             f"not 2(m+1) per fused cycle ({expect})")
    err, sec = ac_host_reference(recs[0].systems[0])
    dA = float(np.abs(sols[0].A - sols[1].A).max() / np.abs(sols[0].A).max())
    print(f"ac125k cold solve vs host spsolve of the same complex system: "
          f"max rel diff {err:.3e} (tol 1e-6; spsolve {sec:.1f} s); cold vs "
          f"warm {dA:.3e}", flush=True)
    if not (err <= 1e-6 and dA <= 1e-6):
        fail("the ac125k solve misses the host reference")
    check_live_hierarchy(torch, "ac125k", amg, ent["bt"],
                         (("Ar", ent["Aop"]), ("Ai", ent["Ai"])))
    ac_apply_cost(torch, ent)
    clear_solver_caches(torch)
    return launches


def axi_problem(scale: float):
    from xfemm_tpu_torch.geometry import femfile
    p = femfile.load(os.path.join(FIXTURES, "AxiSolenoid.fem"))
    for lab in p.labellist:
        lab.MaxArea *= scale
    return p


def axi_250k(torch) -> tuple:
    """Phase: AxiSolenoid.fem (a nonlinear steel rod on the axis inside a
    coil) with every block label's MaxArea scaled by AXI_AREA_SCALE, so
    the port's mesher gives ~250k nodes: a cold and a warm solve on the
    default path, which must run the device loop (``newton.run`` with
    ``axi=True``), then the same solve on the host Newton chain
    (``XFEMM_TPU_NO_DEVICE_NEWTON=1``), within 1e-5 of max|A| of the
    loop's. The loop's cached band hierarchy and factor are held against
    the kernels' plain versions between the two chains. Returns the
    launches of the loop's two solves and of the host chain's."""
    import numpy as np

    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.mesh import mesher
    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    prob = axi_problem(AXI_AREA_SCALE)
    t0 = time.time()
    mesh = mesher.mesh_problem(prob)
    print(f"axi250k: AxiSolenoid.fem, label MaxArea x {AXI_AREA_SCALE}: "
          f"{mesh.num_nodes} nodes, {mesh.num_elements} elements (meshed "
          f"in {time.time() - t0:.1f} s)", flush=True)
    profiling.ENABLED = True
    out = {}
    sols = {}
    for chain in ("device loop", "host chain"):
        if chain == "host chain":
            clear_solver_caches(torch)
            os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
        kernels.reset_launches()
        try:
            for label in (("cold", "warm") if chain == "device loop"
                          else ("cold",)):
                profiling.reset()
                with NewtonRecorder(torch) as rec:
                    t0 = time.time()
                    sol = models.solve(prob, mesh)
                    torch.cuda.synchronize()
                    dt = time.time() - t0
                sols.setdefault(chain, []).append(sol)
                print(f"axi250k {chain}, {label} solve: {dt:.3f} s, "
                      f"residual {sol.residual:.3e}, Newton iterations "
                      f"{sol.newton_iterations}, CG iterations "
                      f"{sol.iterations}; {rec.summary(profiling)}",
                      flush=True)
                print(profiling.report(), flush=True)
                if chain == "device loop" and not (
                        rec.dev and all(rec.axi)
                        and {d[0] for d in rec.dev} == {"run"}):
                    fail(f"the axi250k {label} solve did not run the device "
                         f"loop with axi=True: {rec.dev} {rec.axi}")
                if chain == "host chain" and rec.dev:
                    fail("the axi250k host-chain solve called the loop")
                if not (sol.residual <= prob.Precision
                        and np.isfinite(sol.A).all()):
                    fail(f"axi250k residual {sol.residual:.3e}")
        finally:
            os.environ.pop("XFEMM_TPU_NO_DEVICE_NEWTON", None)
        out[f"axi250k {chain}"] = dict(kernels.LAUNCHES)
        print(f"axi250k {chain} launches: {out[f'axi250k {chain}']}",
              flush=True)
        if chain == "device loop":
            (ent,) = solver._BAND_CACHE.values()
            check_live_hierarchy(torch, "axi250k", ent["band_amg"],
                                 ent["bt"])
    profiling.ENABLED = False
    ref = sols["device loop"][0].A
    dA = max(float(np.abs(s.A - ref).max() / np.abs(ref).max())
             for s in sols["device loop"][1:] + sols["host chain"])
    print(f"axi250k: device loop vs host chain and cold vs warm: max rel "
          f"diff {dA:.3e} (tol 1e-5)", flush=True)
    if not dA <= 1e-5:
        fail("the axi250k device loop and host chain disagree")
    clear_solver_caches(torch)
    return out


def golden_distance(stem, mesh, sol) -> tuple:
    """(max |A - A_golden| / max |A_golden|, label cases match)."""
    import numpy as np
    from scipy.spatial import cKDTree

    from xfemm_tpu_torch.io import ansfile
    g = ansfile.read_ans(os.path.join(FIXTURES, f"{stem}.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    if d.max() > 1e-12:
        fail(f"{stem}: the fixture mesh is not the golden's")
    err = float(np.abs(sol.A[idx] - g.values).max() / np.abs(g.values).max())
    lc = bool(np.allclose(sol.label_case, g.label_case, rtol=1e-6,
                          atol=1e-12))
    return err, lc


def fixtures_ac_axi(torch) -> dict:
    """Phase: the five axisymmetric and AC reference fixtures (premeshed)
    through ``models.solve`` on the card and through the port's CPU
    path: each within 1e-6 of max|A| of its golden .ans and of the CPU
    path, label cases as the golden's; the engine of each printed;
    ACwound's block integrals and ACaxi400's circuit properties through
    ``MagPostProcessor`` against the reference femmcli's values. Returns
    the launches over the five card solves."""
    import numpy as np

    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor

    clear_solver_caches(torch)
    hbm = torch.cuda.mem_get_info()[1]
    kernels.reset_launches()
    for stem in AC_FIXTURES:
        fem = os.path.join(FIXTURES, f"{stem}.fem")
        mesh = read_mesh_files(os.path.join(FIXTURES, stem))
        p = femfile.load(fem)
        before = dict(kernels.LAUNCHES)
        with ACRecorder() as rec, NewtonRecorder(torch) as nrec:
            t0 = time.time()
            sol = models.solve(p, mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
        cpu = models.solve(femfile.load(fem), mesh, device="cpu",
                           hbm_bytes=hbm)
        err, lc = golden_distance(stem, mesh, sol)
        dc = float(np.abs(sol.A - cpu.A).max() / np.abs(cpu.A).max())
        engine = rec.engines() if rec.gmres or rec.pairs else (
            f"Newton: {rec_chain(nrec)}")
        print(f"{stem} ({mesh.num_nodes} nodes) on the card: {dt:.3f} s, "
              f"residual {sol.residual:.2e}, iterations {sol.iterations}, "
              f"engine {engine}; vs golden {err:.3e}, label cases "
              f"{'match' if lc else 'DIFFER'}; card vs CPU path {dc:.3e}; "
              f"launches "
              f"{ {k: v - before[k] for k, v in kernels.LAUNCHES.items()} }",
              flush=True)
        if not (sol.residual <= p.Precision and err <= 1e-6 and lc
                and dc <= 1e-6):
            fail(f"{stem} misses its golden solution or the CPU path")
        post = MagPostProcessor(p, mesh, sol.A, sol.label_case)
        if stem == "ACwound":
            coil = {k for k, lab in enumerate(post.labels)
                    if abs(lab.x) < 1e-9 and abs(lab.y) < 1e-9}
            got = {k: complex(post.block_integral(k, coil)) for k in REF_ACWOUND}
            rel = {k: abs((got[k] if k == 0 else got[k].real) - v) / abs(v)
                   for k, v in REF_ACWOUND.items()}
            print(f"ACwound coil block integrals {got}; rel to femmcli "
                  f"{rel}", flush=True)
            if max(rel.values()) > 2e-4:
                fail("ACwound block integrals miss the reference's")
        if stem == "ACaxi400":
            got = dict(zip(("amps", "volts", "flux"),
                           map(complex, post.circuit_properties("I1"))))
            rel = {k: abs(got[k] - v) / abs(v)
                   for k, v in REF_ACAXI400.items()}
            print(f"ACaxi400 circuit I1 {got}; rel to femmcli {rel}",
                  flush=True)
            if max(rel.values()) > 1e-5:
                fail("ACaxi400 circuit properties miss the reference's")
    out = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)
    return out


def rec_chain(nrec) -> str:
    names = sorted({d[0] for d in nrec.dev})
    return (f"device loop {names}, axi {sorted(set(nrec.axi))}"
            if nrec.dev else "host chain")


def ac_verbs(torch) -> dict:
    """Phase: ACtest.fem through the pyFEMM verbs on the card (open,
    ``mi_createmesh``, ``mi_analyze``, ``mi_loadsolution``, the steel's
    resistive losses by ``mo_blockintegral(4)``, the copper's circuit
    properties) and on the CPU path: within 1e-6 relative. Returns the
    card round trip's launches."""
    from xfemm_tpu_torch import femm_compat as femm
    from xfemm_tpu_torch.ops import kernels

    clear_solver_caches(torch)
    out = {}
    for dev in ("cuda", "cpu"):
        kw = {} if dev == "cuda" else dict(
            device="cpu", hbm_bytes=torch.cuda.mem_get_info()[1])
        kernels.reset_launches()
        t0 = time.time()
        femm.opendocument(os.path.join(FIXTURES, "ACtest.fem"), **kw)
        femm.mi_createmesh()
        femm.mi_analyze()
        femm.mi_loadsolution()
        femm.mo_selectblock(3.5, 0.0)
        loss = complex(femm.mo_blockintegral(4))
        femm.mo_clearblock()
        props = tuple(map(complex, femm.mo_getcircuitproperties("I1")))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        out[dev] = (loss, *props)
        print(f"ACtest verbs ({dev}): {time.time() - t0:.3f} s for open + "
              f"mesh ({femm._s().raw.mesh.num_nodes} nodes) + solve + post;"
              f" steel losses {loss:.9e} W, I1 (amps, volts, flux) {props}",
              flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"], out["cpu"]))
    print(f"ACtest verbs: card vs CPU path max rel diff {rel:.3e} (tol "
          f"1e-6); launches {launches}", flush=True)
    if not (rel <= 1e-6 and out["cuda"][0].real > 0):
        fail("the ACtest verb round trip misses the CPU path")
    clear_solver_caches(torch)
    return launches


def ac_axi_paths(torch) -> dict:
    """Slice 8's paths, each with its launches counted from 0: the 125k
    eddy-current solve, the ~250k axisymmetric solve (device loop and
    host chain), the five reference fixtures and the AC verb round
    trip. Reports K5's launches on them (the shifted hierarchy plans no
    triu level unless its levels print one)."""
    paths = {"ac125k": ac_125k(torch)}
    paths.update(axi_250k(torch))
    paths["AC/axi fixtures"] = fixtures_ac_axi(torch)
    paths["ACtest verbs"] = ac_verbs(torch)
    print(f"K5 (band_sym) launches on the AC and axisymmetric paths: "
          f"{ {k: v['band_sym'] for k, v in paths.items()} }", flush=True)
    return paths


HEAT_NODES = 230_000      # benchprob.build_heat target (perf/measure.py heat230k)
ELEC_AREA_SCALE = 0.0108  # ElecTest.fee's label MaxArea x this: ~250k nodes


def host_reference(system):
    """A real system of ``solver.solve`` solved on the host by
    ``scipy.sparse.linalg.spsolve``: the CSR assembled from the same
    blocks with the Dirichlet rows and columns eliminated (identity
    rows, ``b - A g`` for the fixed values). Returns (x, seconds)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from xfemm_tpu_torch.ops import solver
    blocks, b, fixed_mask, fixed_vals = system[:4]
    fixed = np.asarray(fixed_mask, bool)
    g = np.where(fixed, np.asarray(fixed_vals, float), 0.0)
    t0 = time.time()
    A = solver.blocks_to_csr(blocks, len(b))
    keep = sp.diags((~fixed).astype(float))
    Ae = keep @ A @ keep + sp.diags(fixed.astype(float))
    rhs = np.where(fixed, g, np.asarray(b, float) - A @ g)
    x = spla.spsolve(Ae.tocsc(), rhs)
    return x, time.time() - t0


def band_regime(ent) -> str:
    """The band engine state of a solver band-cache entry, in words."""
    amg = ent["band_amg"]
    levels = [(tuple(lv.A.dense.shape), str(lv.A.dense.dtype)[6:])
              for lv in amg.levels]
    triu = [lv.dvec is not None for lv in amg.levels]
    bt = ent["bt"]
    fac = ("no factor" if bt is None else
           f"{type(bt).__name__} (b, NB) {ent['bt_shape']} "
           f"{str(bt.G.dtype)[6:]}")
    return (f"band levels {levels} (triu {triu}, fine shift0 "
            f"{amg.levels[0].A.shift0}, cchunk {amg.levels[0].A.cchunk}), "
            f"{fac}")


def heat_elec_solve(torch, prob, mesh, name, label, keep=False):
    """One solve of a heat or electrostatic path on the card, recorded
    and printed: time, residual, iterations, the band regime, host
    passes, K(T) loop dispatches and steps, CG iterations, the "device
    heat" and "device cg" seconds and the peak device memory. Returns
    (solution, recorder)."""
    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.ops import solver
    from xfemm_tpu_torch.utils import profiling
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    with NewtonRecorder(torch, keep=keep) as rec:
        t0 = time.time()
        sol = models.solve(prob, mesh)
        torch.cuda.synchronize()
        dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    heat = [d for d in rec.dev if d[0] == "run_heat"]
    (ent,) = solver._BAND_CACHE.values()
    print(f"{name} {label} solve: {dt:.3f} s, residual {sol.residual:.3e}, "
          f"CG iterations {sol.iterations}; host passes {len(rec.host)} "
          f"({sum(rec.host)} CG iterations), run_heat dispatches "
          f"{len(heat)} ({sum(d[1] for d in heat)} steps, "
          f"{sum(d[2] for d in heat)} CG iterations; each (steps, CG, s) "
          f"{[(d[1], d[2], round(t, 3)) for d, t in zip(heat, rec.heat_s)]}"
          f"); {rec.cg_rates(profiling)}; device heat "
          f"{profiling.phase_seconds('device heat'):.3f} s, device cg "
          f"{profiling.phase_seconds('device cg'):.3f} s; peak device "
          f"memory {peak / 1e9:.2f} GB; regime: {band_regime(ent)}",
          flush=True)
    print(profiling.report(), flush=True)
    if not (sol.residual <= prob.Precision):
        fail(f"{name} {label}: residual {sol.residual:.3e} above "
             f"{prob.Precision:g}")
    if {d[0] for d in rec.dev} - {"run_heat"}:
        fail(f"{name} {label}: a Newton loop ran in a heat/elec solve")
    return sol, rec


def heat_230k(torch) -> dict:
    """Phase: the JAX package's heat230k row (``benchprob.build_heat(
    230_000)``: a heated cylinder with a 5-point K(T) curve in a box at
    300 K, Precision 1e-8), meshed by the port's mesher (npz cache), a
    cold and a warm solve on the default path, which must run the K(T)
    loop (``newton.run_heat``, at least one step each), and a cold and
    a warm solve on the host chain (``XFEMM_TPU_NO_DEVICE_NEWTON=1``). The
    loop's T within 1e-5 of max|T| of the host chain's, and a fixed point:
    within 1e-6 of max|T| of a host ``spsolve`` of the system assembled
    at its own conductivity (``heatflow.system``). The loop's cached band
    hierarchy and factor held against the kernels' plain versions.
    Returns the launches of the loop's two solves and of the host
    chain's."""
    import numpy as np

    from xfemm_tpu_torch.models import benchprob, heatflow
    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    t0 = time.time()
    prob = benchprob.build_heat(HEAT_NODES)
    mesh = get_mesh(prob, HEAT_NODES)
    print(f"heat230k mesh: {mesh.num_nodes} nodes, {mesh.num_elements} "
          f"elements ({time.time() - t0:.1f} s incl. cache)", flush=True)
    profiling.ENABLED = True
    out, sols = {}, {}
    try:
        for chain in ("device loop", "host chain"):
            if chain == "host chain":
                clear_solver_caches(torch)
                os.environ["XFEMM_TPU_NO_DEVICE_NEWTON"] = "1"
            reset_counts()
            for label in ("cold", "warm"):
                sol, rec = heat_elec_solve(torch, prob, mesh,
                                           f"heat230k {chain}", label)
                sols.setdefault(chain, []).append(sol)
                steps = sum(d[1] for d in rec.dev)
                if chain == "device loop" and steps < 1:
                    fail(f"the heat230k {label} solve ran no run_heat step")
                if chain == "host chain" and rec.dev:
                    fail("the heat230k host-chain solve called the loop")
            key = "heat230k" if chain == "device loop" \
                else "heat230k host chain"
            out[key] = dict(kernels.LAUNCHES)
            print(f"{key} launches: {out[key]}", flush=True)
            loop_report(key, out[key], loop_counts(), exact=True)
            if chain == "device loop":
                (ent,) = solver._BAND_CACHE.values()
                check_live_hierarchy(torch, "heat230k", ent["band_amg"],
                                     ent["bt"])
                del ent
                # the system at the loop's own final conductivity, for
                # the fixed-point check (host arrays only: the setup's
                # Session must not outlive the caches it is cleared from)
                su = next(iter(heatflow._HEAT_SETUP_CACHE.values()))[1]
                T = sols["device loop"][0].T
                ref = (*heatflow.system(prob, su, T, np.zeros(T.shape)),
                       su.fixed_mask, su.fixed_vals, su.ridx, su.rsign)
                del su
    finally:
        os.environ.pop("XFEMM_TPU_NO_DEVICE_NEWTON", None)
        profiling.ENABLED = False
    scale = float(np.abs(T).max())
    dT = max(float(np.abs(s.T - T).max())
             for s in sols["device loop"][1:] + sols["host chain"]) / scale
    x, sec = host_reference(ref)
    dref = float(np.abs(x[ref[4]] * ref[5] - T).max()) / scale
    print(f"heat230k: loop vs host chain and cold vs warm max rel diff "
          f"{dT:.3e} (tol 1e-5); loop T vs host spsolve at its own "
          f"conductivity {dref:.3e} (tol 1e-6; spsolve {sec:.1f} s); T in "
          f"[{T.min():.3f}, {T.max():.3f}]", flush=True)
    if not (np.isfinite(T).all() and T.shape == (mesh.num_nodes,)):
        fail("heat230k T is not a finite per-node vector")
    if not dT <= 1e-5:
        fail("the heat230k loop and host chain disagree")
    if not dref <= 1e-6:
        fail("the heat230k T is not a fixed point of its own conductivity")
    REFERENCES["heat230k"] = T
    clear_solver_caches(torch)
    return out


def elec_problem(scale: float):
    from xfemm_tpu_torch.geometry import femfile
    p = femfile.load(os.path.join(FIXTURES, "ElecTest.fee"))
    for lab in p.labellist:
        lab.MaxArea *= scale
    return p


def elec_250k(torch) -> dict:
    """Phase: ElecTest.fee (an axisymmetric capacitor, two fixed-voltage
    conductors) with its block label's MaxArea scaled by
    ELEC_AREA_SCALE, so the port's mesher gives ~250k nodes: a cold and
    a warm solve on the card, V within 1e-6 of max|V| of a host
    ``spsolve`` of the same system, conductor voltages and charges
    printed, the cached band hierarchy and factor held against the
    kernels' plain versions. Returns the launches of both solves."""
    import numpy as np

    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    prob = elec_problem(ELEC_AREA_SCALE)
    t0 = time.time()
    mesh = get_mesh(prob, "elec250k")
    print(f"elec250k: ElecTest.fee, label MaxArea x {ELEC_AREA_SCALE}: "
          f"{mesh.num_nodes} nodes, {mesh.num_elements} elements (meshed "
          f"in {time.time() - t0:.1f} s incl. cache)", flush=True)
    profiling.ENABLED = True
    reset_counts()
    sols, recs = [], []
    try:
        for label in ("cold", "warm"):
            sol, rec = heat_elec_solve(torch, prob, mesh, "elec250k", label,
                                       keep=label == "cold")
            sols.append(sol)
            recs.append(rec)
            print(f"elec250k {label}: conductor V {sol.conductor_V.tolist()}"
                  f", charge {sol.conductor_q.tolist()} C", flush=True)
    finally:
        profiling.ENABLED = False
    launches = dict(kernels.LAUNCHES)
    print(f"elec250k launches: {launches}", flush=True)
    loop_report("elec250k", launches, loop_counts(), exact=True)
    (ent,) = solver._BAND_CACHE.values()
    check_live_hierarchy(torch, "elec250k", ent["band_amg"], ent["bt"])
    (system,) = recs[0].systems
    x, sec = host_reference(system)
    V = sols[0].V
    scale = float(np.abs(V).max())
    dref = float(np.abs(system[4] - x).max()) / float(np.abs(x).max())
    dV = float(np.abs(sols[1].V - V).max()) / scale
    print(f"elec250k: solve vs host spsolve of the same system max rel "
          f"diff {dref:.3e} (tol 1e-6; spsolve {sec:.1f} s); cold vs warm "
          f"{dV:.3e}", flush=True)
    if not (np.isfinite(V).all() and V.shape == (mesh.num_nodes,)):
        fail("elec250k V is not a finite per-node vector")
    if not (dref <= 1e-6 and dV <= 1e-6):
        fail("the elec250k solve misses the host reference")
    REFERENCES["elec250k"] = V
    clear_solver_caches(torch)
    return {"elec250k": launches}


HEAT_ELEC_FIXTURES = (("HeatTemp0", ".feh", ".anh", 1e-6),
                      ("ElecTest", ".fee", ".res", 5e-6))


def fixtures_heat_elec(torch) -> dict:
    """Phase: HeatTemp0.feh (planar, convection walls, an 18-point K(T)
    curve) and ElecTest.fee (premeshed) through ``models.solve`` on the
    card and then, the same problem object, on the CPU path (the heat
    setup cache is keyed by device): within 1e-6 (heat) or 5e-6
    (electrostatics) of max|.| of their golden .anh / .res, card and CPU
    within 1e-6, the heat solve through the K(T) loop on the card, and
    ElecTest's conductor voltages and charges as the golden's (1e-6).
    Returns the launches of the two card solves."""
    import numpy as np
    from scipy.spatial import cKDTree

    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.io import ansfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.ops import kernels

    clear_solver_caches(torch)
    hbm = torch.cuda.mem_get_info()[1]
    kernels.reset_launches()
    for stem, ext, gext, tol in HEAT_ELEC_FIXTURES:
        path = os.path.join(FIXTURES, f"{stem}{ext}")
        mesh = read_mesh_files(os.path.join(FIXTURES, stem))
        p = femfile.load(path)
        before = dict(kernels.LAUNCHES)
        with NewtonRecorder(torch) as rec:
            t0 = time.time()
            sol = models.solve(p, mesh)
            torch.cuda.synchronize()
            dt = time.time() - t0
        # the same problem object on the CPU path: its cached setup (a
        # Session with tensors on the card) must not serve this solve
        cpu = models.solve(p, mesh, device="cpu", hbm_bytes=hbm)
        x, xc = (sol.T, cpu.T) if ext == ".feh" else (sol.V, cpu.V)
        g = ansfile.read_ans(os.path.join(FIXTURES, f"{stem}{gext}.golden"))
        d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
        if d.max() > 1e-12:
            fail(f"{stem}: the fixture mesh is not the golden's")
        gv = np.real(g.values)
        err = float(np.abs(x[idx] - gv).max() / np.abs(gv).max())
        dc = float(np.abs(x - xc).max() / np.abs(xc).max())
        steps = sum(d_[1] for d_ in rec.dev)
        cond = [(float(v), float(q), float(ov), float(oq))
                for (v, q), ov, oq in zip(g.conductor_results,
                                          sol.conductor_V, sol.conductor_q)]
        print(f"{stem} ({mesh.num_nodes} nodes) on the card: {dt:.3f} s, "
              f"residual {sol.residual:.2e}, iterations {sol.iterations}, "
              f"run_heat steps {steps}; vs golden {err:.3e} (tol {tol:g}); "
              f"card vs CPU path {dc:.3e}; conductors (golden V, q, solved "
              f"V, q) {cond}; launches "
              f"{ {k: v - before[k] for k, v in kernels.LAUNCHES.items()} }",
              flush=True)
        if not (sol.residual <= p.Precision and err <= tol and dc <= 1e-6):
            fail(f"{stem} misses its golden solution or the CPU path")
        if ext == ".feh" and steps < 1:
            fail("HeatTemp0 did not run the K(T) loop on the card")
        if ext == ".fee" and not (len(cond) == 2 and all(
                abs(ov - v) <= 1e-6 * max(1.0, abs(v))
                and abs(oq - q) <= 1e-6 * max(abs(q), 1e-12)
                for v, q, ov, oq in cond)):
            fail("ElecTest's conductor results miss the golden's")
    out = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)
    return out


def heat_elec_verbs(torch) -> dict:
    """Phase: HeatTemp0.feh and ElecTest.fee through the pyFEMM verbs on
    the card (open, ``hi_analyze`` / ``ei_analyze``, which mesh,
    ``*_loadsolution``, a point value; ElecTest's 50 V conductor's
    properties) and on the CPU path: T and V within 1e-6 relative.
    Returns the card round trips' launches."""
    from xfemm_tpu_torch import femm_compat as femm
    from xfemm_tpu_torch.ops import kernels

    clear_solver_caches(torch)
    out = {}
    launches = {}
    for dev in ("cuda", "cpu"):
        kw = {} if dev == "cuda" else dict(
            device="cpu", hbm_bytes=torch.cuda.mem_get_info()[1])
        kernels.reset_launches()
        t0 = time.time()
        femm.opendocument(os.path.join(FIXTURES, "HeatTemp0.feh"), **kw)
        femm.hi_analyze()
        femm.hi_loadsolution()
        ht = femm.ho_getpointvalues(0.5, 0.5)
        femm.opendocument(os.path.join(FIXTURES, "ElecTest.fee"), **kw)
        femm.ei_analyze()
        femm.ei_loadsolution()
        ev = femm.eo_getpointvalues(0.1, 0.0)
        cp = femm.eo_getconductorproperties("m1t")
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        out[dev] = (float(ht[0]), float(ev[0]))
        print(f"heat/elec verbs ({dev}): {time.time() - t0:.3f} s for two "
              f"open + mesh + solve + point value round trips; HeatTemp0 T"
              f"(0.5, 0.5) {ht[0]:.9f} K, ElecTest V(0.1, 0.0) "
              f"{ev[0]:.9f} V, conductor m1t (V, q) {tuple(cp)}", flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"], out["cpu"]))
    print(f"heat/elec verbs: card vs CPU path max rel diff {rel:.3e} (tol "
          f"1e-6); launches {launches}", flush=True)
    if not (rel <= 1e-6 and out["cuda"][0] > 0 and out["cuda"][1] > 0):
        fail("the heat/elec verb round trips miss the CPU path")
    clear_solver_caches(torch)
    return launches


def heat_elec_paths(torch) -> dict:
    """Slice 10's paths, each with its launches counted from 0: heat230k
    (the loop's cold and warm solves, and the host chain's), elec250k,
    the two fixtures and the verb round trips. Fails unless K1, K2 and
    K3+K4 launched on heat230k and elec250k; reports K5's launches
    (nonzero only where a printed regime stores a level triu)."""
    paths = heat_230k(torch)
    paths.update(elec_250k(torch))
    paths["heat/elec fixtures"] = fixtures_heat_elec(torch)
    paths["heat/elec verbs"] = heat_elec_verbs(torch)
    for key in ("heat230k", "elec250k"):
        for name in ("band_mv", "bt_fwd", "bt_qbwd"):
            if not paths[key][name]:
                fail(f"the {key} solves never launched {name}")
    print(f"K5 (band_sym) launches on the heat and electrostatic paths: "
          f"{ {k: v['band_sym'] for k, v in paths.items()} }", flush=True)
    return paths


DD_PARTS = 4              # devices=N of the slice's main path (dd250k)
DD_SWEEP_NODES = 100_000  # tests/test_band_dd_scaling.py's system
#: the JAX package's CG counts of that system on 2-16 virtual devices
#: (PARITY.md, "Multi-chip scaling")
JAX_SWEEP_ITS = {2: 145, 4: 197, 8: 260, 16: 301}
DD_PHASES = ("dd csr assembly", "dd band setup", "dd band refresh",
             "dd bt factor", "dd cg")
#: the device memory size at which the 250k problem's band hierarchy has
#: a split coarse level that is not stored triu and takes a
#: block-tridiagonal smoother with XFEMM_TPU_COARSE_BT_SMOOTH set
A5_HBM = 7.5928e9
#: solutions of the heat and electrostatic paths, kept for the domain
#: decomposition's checks
REFERENCES: dict = {}


class DDRecorder:
    """Records, while active, every ``DistributedSession.solve`` and
    ``solve_complex`` call: the engine that served it ("band_dd" or the
    element-block "halo" PCG), its CG iterations, each band_dd call's CG
    per refinement pass, and the sessions; with ``keep`` also each call's
    system and solution. It wraps the class's methods and restores them
    on exit."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.calls = []         # (engine, CG iterations)
        self.passes = []        # CG per refinement pass of band_dd calls
        self.sessions = []
        self.systems = []       # (blocks, b, fixed_mask, fixed_vals, x)
        self.coords = []        # each kept call's DOF coordinates
        self._served = False

    def __enter__(self):
        from xfemm_tpu_torch.parallel import driver
        cls = driver.DistributedSession
        self._saved = {name: getattr(cls, name)
                       for name in ("solve", "solve_complex",
                                    "_solve_band_dd")}
        real = self._saved

        def band_dd(sess, *a, **kw):
            out = real["_solve_band_dd"](sess, *a, **kw)
            self._served = out is not None
            if out is not None:
                self.passes.append(list(sess.pass_iters))
            return out

        def wrap(name):
            def solve(sess, *a, **kw):
                self._served = False
                out = real[name](sess, *a, **kw)
                self.calls.append(("band_dd" if self._served else "halo",
                                   int(out[2])))
                if not any(s is sess for s in self.sessions):
                    self.sessions.append(sess)
                if self.keep:
                    self.systems.append((*a[:4], out[0]))
                    self.coords.append(kw.get("coords"))
                return out
            return solve

        cls.solve = wrap("solve")
        cls.solve_complex = wrap("solve_complex")
        cls._solve_band_dd = band_dd
        return self

    def __exit__(self, *exc):
        from xfemm_tpu_torch.parallel import driver
        for name, fn in self._saved.items():
            setattr(driver.DistributedSession, name, fn)
        return False

    def engines(self) -> str:
        eng = [c[0] for c in self.calls]
        return ", ".join(f"{e} x{eng.count(e)}" for e in sorted(set(eng)))


def dd_phase_seconds(profiling) -> str:
    return ", ".join(f"{name} {profiling.phase_seconds(name):.3f} s"
                     for name in DD_PHASES)


def dd_geometry(sess) -> str:
    st = sess._bdd
    if st is None:
        return "no band_dd state"
    return (f"per-part band (P, NT, R, W) = ({st.ndev}, {st.NT}, 128, "
            f"{st.W}), shift0 {st.shift0}, nloc {st.nloc}; factor b={st.b} "
            f"NB={st.NB}")


def check_dd_live(torch, label: str, sess) -> None:
    """K1 on the session's live per-part bands (the first and the last
    part it holds: all four stacked, or a rank's own) and the sweeps (K2,
    K3+K4) on their live factors against the plain versions
    (check_live_hierarchy: K1 at TOL, the sweeps step by step at TOL and
    chained, each timed against its bytes bound). These launches are
    checks, not the path's."""
    from types import SimpleNamespace

    from xfemm_tpu_torch.ops.band import BandMatrix
    from xfemm_tpu_torch.parallel import band_dd
    st = sess._bdd
    dense, _oob, _invd = band_dd.device_values(st, st.Ap_pattern)
    for p in sorted({0, st.nl - 1}):
        band = BandMatrix(dense[p], st.shift0, band_dd.CCHUNK, st.nloc)
        check_live_hierarchy(torch, f"{label} part {st.lo + p}",
                             SimpleNamespace(levels=()),
                             band_dd.part_factor(sess._bdd_bt, p),
                             ((f"band {st.lo + p}", band),))
    del dense
    torch.cuda.empty_cache()


def dd_250k(torch, prob, mesh, A_ref):
    """Phase: the slice's main path, ``magnetostatics.solve(...,
    devices=4)`` on the 250k problem, cold and warm on the card (a fresh
    session each, as each solve makes one): the Newton chain on the host,
    every linear solve on the sharded band engine (K1 per part's band,
    K2 and K3+K4 per part's factor). Prints the per-part geometry, the
    host Newton passes, CG per refinement pass, the "dd" phase seconds,
    ms per CG iteration and peak memory; checks the residual, band_dd on
    every solve, A within 1e-5 of max|A_ref| (the single-device solve)
    and K1, K2, K3+K4 launched a multiple of 4 times; holds the live
    per-part bands and factors against the plain versions. Returns the
    launches and the first linear system of the cold solve."""
    import numpy as np

    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    profiling.ENABLED = True
    reset_counts()
    first = None
    try:
        for label in ("cold", "warm"):
            profiling.reset()
            torch.cuda.reset_peak_memory_stats()
            with DDRecorder(keep=label == "cold") as rec:
                t0 = time.time()
                sol = magnetostatics.solve(prob, mesh, devices=DD_PARTS)
                torch.cuda.synchronize()
                dt = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            (sess,) = rec.sessions
            cg = sum(c[1] for c in rec.calls)
            cg_s = profiling.phase_seconds("dd cg")
            dA = float(np.abs(sol.A - A_ref).max() / np.abs(A_ref).max())
            print(f"dd250k {label} solve (devices={DD_PARTS}): {dt:.3f} s, "
                  f"residual {sol.residual:.3e}, Newton iterations "
                  f"{sol.newton_iterations} (host passes "
                  f"{len(rec.calls)}), CG iterations {cg}, per "
                  f"refinement pass {rec.passes}; engines "
                  f"{rec.engines()}; {dd_geometry(sess)}; "
                  f"{dd_phase_seconds(profiling)}; "
                  f"{1e3 * cg_s / max(cg, 1):.3f} ms per CG iteration; peak "
                  f"device memory {peak / 1e9:.2f} GB; max|A - A_ref| / "
                  f"max|A_ref| {dA:.3e}", flush=True)
            print(profiling.report(), flush=True)
            if not sol.residual <= prob.Precision:
                fail(f"dd250k {label}: residual {sol.residual:.3e}")
            if sess._bdd_disabled or {c[0] for c in rec.calls} != {"band_dd"}:
                fail(f"dd250k {label}: band_dd did not serve every linear "
                     f"solve ({rec.engines()})")
            if not dA <= 1e-5:
                fail(f"dd250k {label}: A is {dA:.3e} from the single-device "
                     f"solve's")
            REFERENCES[f"dd250k {label}"] = sol.A
            if first is None:
                first = (rec.systems[0], rec.coords[0])
    finally:
        profiling.ENABLED = False
    launches = dict(kernels.LAUNCHES)
    print(f"dd250k launches over both solves {launches}", flush=True)
    loop_report("dd250k", launches, loop_counts(), per_prec=DD_PARTS,
                exact=True)
    for name in ("band_mv", "bt_fwd", "bt_qbwd"):
        if not (launches[name] > 0 and launches[name] % DD_PARTS == 0):
            fail(f"dd250k launched {name} {launches[name]} times, not a "
                 f"positive multiple of {DD_PARTS}")
    check_dd_live(torch, "dd250k", sess)
    del sess
    clear_solver_caches(torch)
    return launches, first


def dd_system(prob, mesh):
    """tests/test_band_dd_scaling.py's system (mu = 1000 in the steel):
    element blocks, right-hand side, Dirichlet set, DOF coordinates and
    its host ``spsolve`` solution."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import assembly, solver

    pk = magnetostatics.pack(prob, mesh)
    geom = assembly.tri_geometry(pk.xy, pk.tris)
    Mx, My, _ = assembly.curl_matrices(geom)
    mu = np.where(pk.nonlinear, 1000.0, pk.mu_x)
    Me = Mx / mu[:, None, None] + My / mu[:, None, None]
    idx = pk.ridx[pk.tris]
    sign = pk.rsign[pk.tris]
    blocks = [solver.ElementBlock(idx=idx, sign=sign, mat=-Me)]
    b = np.zeros(pk.nreduced)
    np.add.at(b, idx.reshape(-1),
              -(sign * (-(pk.Jre * geom.area / 3.0)[:, None]
                        * np.ones((1, 3)))).reshape(-1))
    coords = np.zeros((pk.nreduced, 2))
    coords[pk.ridx] = pk.xy
    fixed = np.asarray(pk.fixed_mask, bool)
    At = solver.Session().csr_values(blocks, pk.nreduced, fixed)
    x_ref = spla.spsolve(At.tocsc(),
                         np.where(fixed, pk.fixed_vals, b))
    return blocks, b, fixed, pk.fixed_vals, coords, x_ref


def dd_scaling(torch) -> dict:
    """Phase: iteration growth with the part count. The 100k system of
    tests/test_band_dd_scaling.py, one linear solve to 1e-10 on the
    sharded band engine at P = 2, 4, 8 and 16 on the card; CG counts
    beside the JAX package's (PARITY.md); each solution within 1e-8 of
    max|x| of the host spsolve, and its(16) <= 3 x its(2), the bound
    the JAX test asserts. Returns the launches over the four solves."""
    import numpy as np

    from xfemm_tpu_torch.models import benchprob
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.parallel import driver
    from xfemm_tpu_torch.utils import profiling

    clear_solver_caches(torch)
    prob = benchprob.build(DD_SWEEP_NODES)
    mesh = get_mesh(prob, DD_SWEEP_NODES)
    t0 = time.time()
    blocks, b, fixed, fv, coords, x_ref = dd_system(prob, mesh)
    print(f"dd100k: {mesh.num_nodes} nodes, {len(b)} unknowns; system and "
          f"host spsolve in {time.time() - t0:.1f} s", flush=True)
    kernels.reset_launches()
    profiling.ENABLED = True
    its = {}
    try:
        for P in sorted(JAX_SWEEP_ITS):
            profiling.reset()
            sess = driver.DistributedSession(P)
            t0 = time.time()
            x, res, it = sess.solve(blocks, b, fixed, fv, 1e-10,
                                    coords=coords)
            torch.cuda.synchronize()
            dt = time.time() - t0
            err = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
            its[P] = it
            cg_s = profiling.phase_seconds("dd cg")
            print(f"dd100k P={P}: {it} CG iterations (per pass "
                  f"{sess.pass_iters}; JAX package {JAX_SWEEP_ITS[P]}), "
                  f"residual {res:.3e}, max rel err vs spsolve {err:.3e}, "
                  f"{dt:.3f} s ({1e3 * cg_s / max(it, 1):.3f} ms per CG "
                  f"iteration); {dd_geometry(sess)}; "
                  f"{dd_phase_seconds(profiling)}", flush=True)
            if sess._bdd is None or sess._bdd_disabled:
                fail(f"dd100k P={P}: the band engine did not serve")
            if not (res <= 1e-10 and err <= 1e-8):
                fail(f"dd100k P={P}: the solution misses the reference")
            del sess
    finally:
        profiling.ENABLED = False
    print(f"dd100k CG counts {its}; its(16) / its(2) = "
          f"{its[16] / its[2]:.3f} (bound 3)", flush=True)
    if not its[16] <= 3 * its[2]:
        fail("dd100k: CG iterations grow faster than 3x from P=2 to 16")
    clear_solver_caches(torch)
    return dict(kernels.LAUNCHES)


def dd_solve(torch, label, solve, attr, ref, tol):
    """One ``devices=4`` solve of another family on the card (``solve()``
    returns the solution): time, residual, engines, CG iterations and
    peak memory printed; its ``attr`` within ``tol`` of max|ref|."""
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    with DDRecorder() as rec:
        t0 = time.time()
        sol = solve()
        torch.cuda.synchronize()
        dt = time.time() - t0
    got = getattr(sol, attr)
    d = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{label} (devices={DD_PARTS}): {dt:.3f} s, residual "
          f"{sol.residual:.3e}, CG iterations {sol.iterations} over "
          f"{len(rec.calls)} linear solves, engines {rec.engines()}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"max rel diff to the reference {d:.3e} (tol {tol:g})",
          flush=True)
    if not (sol.residual <= sol.problem.Precision and d <= tol):
        fail(f"{label}: the domain decomposition misses its reference")


def dd_families(torch) -> dict:
    """Phase: the other families with ``devices=4`` on the card:
    heat230k cold against the K(T) loop's T (1e-5 of max|T|), elec250k
    against its single-device V (1e-6), the AxiSolenoid, ACtest and
    ACwound fixtures against their golden files (1e-6), and ac125k once
    (the f64 complex halo PCG) against a host spsolve (1e-6). Returns the
    launches per family."""
    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.models import benchprob
    from xfemm_tpu_torch.ops import kernels

    out = {}
    clear_solver_caches(torch)
    prob = benchprob.build_heat(HEAT_NODES)
    mesh = get_mesh(prob, HEAT_NODES)
    if "heat230k" not in REFERENCES:
        REFERENCES["heat230k"] = models.solve(prob, mesh).T
    kernels.reset_launches()
    dd_solve(torch, "heat230k cold",
             lambda: models.solve(prob, mesh, devices=DD_PARTS), "T",
             REFERENCES["heat230k"], 1e-5)
    out["dd heat230k"] = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)

    prob = elec_problem(ELEC_AREA_SCALE)
    mesh = get_mesh(prob, "elec250k")
    if "elec250k" not in REFERENCES:
        REFERENCES["elec250k"] = models.solve(prob, mesh).V
    kernels.reset_launches()
    dd_solve(torch, "elec250k",
             lambda: models.solve(prob, mesh, devices=DD_PARTS), "V",
             REFERENCES["elec250k"], 1e-6)
    out["dd elec250k"] = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)

    kernels.reset_launches()
    for stem in ("AxiSolenoid", "ACtest", "ACwound"):
        p = femfile.load(os.path.join(FIXTURES, f"{stem}.fem"))
        fmesh = read_mesh_files(os.path.join(FIXTURES, stem))
        t0 = time.time()
        with DDRecorder() as rec:
            sol = models.solve(p, fmesh, devices=DD_PARTS)
            torch.cuda.synchronize()
        err, lc = golden_distance(stem, fmesh, sol)
        print(f"{stem} (devices={DD_PARTS}, {fmesh.num_nodes} nodes): "
              f"{time.time() - t0:.3f} s, residual {sol.residual:.2e}, "
              f"iterations {sol.iterations}, engines "
              f"{rec.engines() or 'single device (circuit Case-2 DOFs)'}; "
              f"vs golden {err:.3e} (tol 1e-6), label cases "
              f"{'match' if lc else 'DIFFER'}", flush=True)
        if not (sol.residual <= p.Precision and err <= 1e-6 and lc):
            fail(f"{stem} with devices={DD_PARTS} misses its golden file")
    out["dd fixtures"] = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)

    prob = benchprob.build_ac(AC_NODES)
    mesh = get_mesh(prob, AC_NODES)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with DDRecorder(keep=True) as rec:
        t0 = time.time()
        sol = models.solve(prob, mesh, devices=DD_PARTS)
        torch.cuda.synchronize()
        dt = time.time() - t0
    err, sec = ac_host_reference(rec.systems[0])
    print(f"ac125k (devices={DD_PARTS}, f64 complex halo PCG): {dt:.3f} s"
          f"{' (past 120 s)' if dt > 120 else ''}, residual "
          f"{sol.residual:.3e}, CG iterations {sol.iterations} "
          f"({dt * 1e3 / max(sol.iterations, 1):.3f} ms per iteration), "
          f"engines {rec.engines()}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; vs host "
          f"spsolve {err:.3e} (tol 1e-6; spsolve {sec:.1f} s)", flush=True)
    if not (sol.residual <= prob.Precision and err <= 1e-6):
        fail("ac125k with devices=4 misses the host reference")
    out["dd ac125k"] = dict(kernels.LAUNCHES)
    clear_solver_caches(torch)
    return out


def dd_first_generation(torch, first) -> dict:
    """Phase: the first-generation real path on the card, the engine a
    session falls back to once the band engine latches off: a
    ``DistributedSession(4)`` latched off the band engine solves the 250k
    system's first linear system to 1e-10 (the f64 element-block PCG
    with the additive-Schwarz AMG and the global coarse solve, one ring
    halo per product; the partition bisects the DOF coordinates, so they
    are passed, as the models do); iterations, ms per iteration and any
    latch-off to Jacobi printed; the solution within 1e-6 of max|x| of a
    host spsolve. Returns the launches (none: the path has no kernel)."""
    import numpy as np

    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.parallel import driver

    system, coords = first
    blocks, b, fixed_mask, fixed_vals = system[:4]
    x_ref, sec = host_reference(system)
    kernels.reset_launches()
    for k in solver.MASKED:
        solver.MASKED[k] = 0
    sess = driver.DistributedSession(DD_PARTS)
    sess._bdd_disabled = True
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    x, rel, it = sess.solve(blocks, b, fixed_mask, fixed_vals, 1e-10,
                            coords=coords)
    torch.cuda.synchronize()
    dt = time.time() - t0
    err = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
    print(f"dd250k first-generation path (halo PCG, f64, Schwarz "
          f"{'latched off to Jacobi' if not sess.schwarz else 'kept'}): "
          f"{dt:.3f} s, {it} iterations ({1e3 * dt / max(it, 1):.3f} ms per "
          f"iteration incl. the Schwarz build), relres {rel:.3e}, masked "
          f"iterations {solver.MASKED['dd-halo']}; partition nmax "
          f"{sess.ps.nmax}, hmax {sess.ps.hmax}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; vs host "
          f"spsolve {err:.3e} (tol 1e-6; spsolve {sec:.1f} s)", flush=True)
    if not (rel <= 1e-10 and err <= 1e-6):
        fail("the first-generation path misses the host reference")
    return dict(kernels.LAUNCHES)


def a5_path(torch, prob, mesh, A_ref) -> dict:
    """Phase: the coarse-level block-tridiagonal smoothers. The 250k
    problem at A5_HBM, where the band hierarchy has a split coarse level
    that is not stored triu, solved cold on the card with
    XFEMM_TPU_COARSE_BT_SMOOTH unset and set: the levels that take a
    factor, CG iterations, peak memory and residual printed; A within
    1e-5 of max|A_ref| both ways; with the switch at least one level
    takes a factor, and its live sweeps are held against the plain
    versions (step by step at TOL, chained at BF16_CHAIN_TOL). Returns
    the launches of the solve with the switch."""
    import numpy as np
    from types import SimpleNamespace

    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.ops import kernels
    from xfemm_tpu_torch.utils import profiling

    out = {}
    try:
        for switch in (None, "1"):
            clear_solver_caches(torch)
            if switch:
                os.environ["XFEMM_TPU_COARSE_BT_SMOOTH"] = switch
            kernels.reset_launches()
            profiling.reset()
            torch.cuda.reset_peak_memory_stats()
            with NewtonRecorder(torch) as rec:
                t0 = time.time()
                sol = magnetostatics.solve(prob, mesh, hbm_bytes=A5_HBM)
                torch.cuda.synchronize()
                dt = time.time() - t0
            amg = session_of("cuda").band_amg
            levels = [(i, lv.A.ncols, lv.oob is not None,
                       lv.dvec is not None,
                       None if lv.bts is None
                       else tuple(lv.bts.Sinv.shape))
                      for i, lv in enumerate(amg.levels)]
            dA = float(np.abs(sol.A - A_ref).max() / np.abs(A_ref).max())
            print(f"A.5 250k at {A5_HBM:.4e} bytes, switch "
                  f"{'set' if switch else 'unset'}: {dt:.3f} s, residual "
                  f"{sol.residual:.3e}, CG iterations {sol.iterations}; "
                  f"{rec.summary(profiling)}; levels (index, n, split, "
                  f"triu, coarse factor (NB, b, b)) {levels}; peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
                  f" max|A - A_ref| / max|A_ref| {dA:.3e}", flush=True)
            if not (sol.residual <= prob.Precision and dA <= 1e-5):
                fail("the A.5 solve misses the single-device solution")
            taken = [lv for lv in amg.levels if lv.bts is not None]
            if bool(taken) != bool(switch):
                fail(f"A.5: coarse factors {'missing' if switch else 'built'}"
                     f" with the switch {'set' if switch else 'unset'}")
            if switch:
                out["250k A.5"] = dict(kernels.LAUNCHES)
                for i, lv in enumerate(amg.levels):
                    if lv.bts is not None:
                        check_live_hierarchy(torch, f"A.5 L{i} coarse",
                                             SimpleNamespace(levels=()),
                                             lv.bts)
            del amg
    finally:
        os.environ.pop("XFEMM_TPU_COARSE_BT_SMOOTH", None)
        clear_solver_caches(torch)
    return out


def dd_paths(torch, mesh, A_ref) -> dict:
    """Slice 11's paths (phase 3f), launches counted from 0 per path:
    dd250k (the main path), the P sweep, the other families, the
    first-generation path, and the coarse-level smoothers (A.5)."""
    from xfemm_tpu_torch.models import benchprob
    prob = benchprob.build(NODES)
    launches, first = dd_250k(torch, prob, mesh, A_ref)
    paths = {"dd250k": launches}
    paths["dd100k sweep"] = dd_scaling(torch)
    paths.update(dd_families(torch))
    paths["dd250k first generation"] = dd_first_generation(torch, first)
    paths.update(a5_path(torch, prob, mesh, A_ref))
    return paths


#: seconds the dist phase's ranks may take, all three paths together
DIST_WALL = 300.0


def digest(x) -> str:
    import hashlib

    import numpy as np
    return hashlib.blake2b(np.ascontiguousarray(x).tobytes(),
                           digest_size=8).hexdigest()


def comm_costs(torch, group, comm, nloc: int, device, reps: int = 50):
    """The communicator's cost per call on this rank, ms (host clock
    around ``reps`` calls ending in a synchronize, after one warm-up and
    a barrier): the all-gather of a (1, nloc) f32 part vector (the band
    operator's, once per CG iteration) and the sum of one f32 scalar
    (``psum``, three per CG iteration)."""
    import torch.distributed as dist

    x = torch.ones((1, nloc), dtype=torch.float32, device=device)
    s = torch.ones((1,), dtype=torch.float32, device=device)
    out = {}
    for name, fn in (("all_gather", lambda: comm.all_gather(x)),
                     ("psum", lambda: comm.psum(s))):
        fn()
        torch.cuda.synchronize()
        dist.barrier(group)
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.time() - t0) / reps
    return out


def dist_rank(group, device, A_dd):
    """Body of each rank of the dist phase (a process of its own, one
    part, ``launch.spawn``): dd250k, ``magnetostatics.solve(...,
    devices=4, device_mesh=group)`` on the 250k problem cold and warm
    (the kernels' launches counted from 0 over both, A against the
    stacked dd250k solve of the same label, ``A_dd[label]``); rank 0
    then holds its live band and factor against the plain versions
    (``check_dd_live``); each rank times its communicator
    (``comm_costs``); the f64 first-generation path on the cold solve's
    first linear system (rank 0 against a host spsolve); ACwound (the complex-symmetric halo PCG
    over the ranks) and ACtest (circuit Case-2 DOFs: the single-device
    path on every rank) against their golden files. Returns what the
    parent prints and checks, with digests of every solution."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.models import benchprob, magnetostatics
    from xfemm_tpu_torch.ops import kernels, solver
    from xfemm_tpu_torch.parallel import driver
    from xfemm_tpu_torch.utils import profiling

    rank = dist.get_rank(group)
    prob = benchprob.build(NODES)
    mesh = get_mesh(prob, NODES)
    out = {"rank": rank, "device": str(device), "solves": []}
    profiling.ENABLED = True
    reset_counts()
    first = sess = None
    for label in ("cold", "warm"):
        profiling.reset()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group)
        with DDRecorder(keep=label == "cold") as rec:
            t0 = time.time()
            sol = magnetostatics.solve(prob, mesh, devices=DD_PARTS,
                                       device_mesh=group)
            torch.cuda.synchronize()
            dt = time.time() - t0
        (sess,) = rec.sessions
        cg = sum(c[1] for c in rec.calls)
        out["solves"].append(dict(
            label=label, seconds=dt, residual=sol.residual,
            ok=sol.residual <= prob.Precision,
            newton=sol.newton_iterations, passes=rec.passes, cg=cg,
            band_dd=(not sess._bdd_disabled
                     and {c[0] for c in rec.calls} == {"band_dd"}),
            engines=rec.engines(), phases=dd_phase_seconds(profiling),
            ms_per_cg=1e3 * profiling.phase_seconds("dd cg") / max(cg, 1),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            dA=float(np.abs(sol.A - A_dd[label]).max()
                     / np.abs(A_dd[label]).max()),
            digest=digest(sol.A), geometry=dd_geometry(sess)))
        if first is None:
            first = (rec.systems[0], rec.coords[0])
    profiling.ENABLED = False
    out["launches"] = dict(kernels.LAUNCHES)
    out["loops"] = loop_counts()
    if rank == 0:
        check_dd_live(torch, f"dist250k rank {rank}", sess)
    out["comm_ms"] = comm_costs(torch, group, sess.comm, sess._bdd.nloc,
                                device)
    del sess, sol
    torch.cuda.empty_cache()

    system, coords = first
    blocks, b, fixed_mask, fixed_vals = system[:4]
    fsess = driver.DistributedSession(DD_PARTS, mesh=group)
    fsess._bdd_disabled = True
    torch.cuda.reset_peak_memory_stats()
    dist.barrier(group)
    t0 = time.time()
    x, rel, it = fsess.solve(blocks, b, fixed_mask, fixed_vals, 1e-10,
                             coords=coords)
    torch.cuda.synchronize()
    fg = dict(seconds=time.time() - t0, iterations=it, relres=rel,
              schwarz=fsess.schwarz, digest=digest(x),
              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
              masked=solver.MASKED["dd-halo"], err=None, spsolve_s=None)
    if rank == 0:
        x_ref, fg["spsolve_s"] = host_reference(system)
        fg["err"] = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
    out["first_gen"] = fg
    del fsess

    out["fixtures"] = {}
    for stem in ("ACwound", "ACtest"):
        p = femfile.load(os.path.join(FIXTURES, f"{stem}.fem"))
        fmesh = read_mesh_files(os.path.join(FIXTURES, stem))
        dist.barrier(group)
        with DDRecorder() as rec:
            t0 = time.time()
            sol = models.solve(p, fmesh, devices=DD_PARTS, device_mesh=group)
            torch.cuda.synchronize()
        err, lc = golden_distance(stem, fmesh, sol)
        out["fixtures"][stem] = dict(
            seconds=time.time() - t0, nodes=fmesh.num_nodes,
            residual=sol.residual, ok=sol.residual <= p.Precision,
            iterations=sol.iterations, err=err, label_cases=lc,
            engines=rec.engines() or "single device (circuit Case-2 DOFs)",
            digest=digest(sol.A))
    return out


def dist_path(torch) -> dict:
    """Phase: the domain decomposition over a process group, one process
    per part (``parallel/launch.spawn``, four ranks): NCCL with one card
    per rank where the machine has four cards, else gloo with the four
    ranks on the one card (their contexts time-slice it: a correctness
    run, not a speed run). Each rank runs ``dist_rank``; the parent
    prints every rank's phase seconds, ms per CG iteration and peak
    memory, and checks: the residual, band_dd on every dd250k linear
    solve, A within 1e-9 of max|A| of the stacked dd250k solve, the
    same solution on every rank (digests) for every path, each rank's
    K1, K2 and K3+K4 launched, the first-generation path within 1e-6 of
    the host spsolve, ACwound and ACtest within 1e-6 of golden. Returns
    the dd250k launches summed over the ranks."""
    from xfemm_tpu_torch.parallel import launch

    backend = launch.backend_for("cuda", DD_PARTS)
    where = ("one card per rank" if backend == "nccl" else
             f"the {DD_PARTS} ranks on one card")
    print(f"dist250k: {DD_PARTS} ranks over {backend}, {where} "
          f"({torch.cuda.device_count()} card(s) visible)", flush=True)
    clear_solver_caches(torch)
    t0 = time.time()
    try:
        res = launch.spawn(dist_rank, DD_PARTS, backend, "cuda",
                           args=({k: REFERENCES[f"dd250k {k}"]
                                  for k in ("cold", "warm")},),
                           wall=DIST_WALL)
    except RuntimeError as exc:
        fail(f"dist250k: {exc}")
    print(f"dist250k: the ranks ran in {time.time() - t0:.1f} s "
          f"(devices {[r['device'] for r in res]})", flush=True)

    def same(get, what):
        if len({get(r) for r in res}) != 1:
            fail(f"dist250k: the ranks' {what} differ")

    for i, label in enumerate(("cold", "warm")):
        for r in res:
            v = r["solves"][i]
            print(f"dist250k {label} solve, rank {r['rank']}: "
                  f"{v['seconds']:.3f} s, residual {v['residual']:.3e}, "
                  f"Newton iterations {v['newton']}, CG iterations "
                  f"{v['cg']}, per refinement pass {v['passes']}; engines "
                  f"{v['engines']}; {v['geometry']}; {v['phases']}; "
                  f"{v['ms_per_cg']:.3f} ms per CG iteration; peak device "
                  f"memory {v['peak_gb']:.2f} GB; max|A - A_dd| / "
                  f"max|A_dd| {v['dA']:.3e}", flush=True)
            if not v["ok"]:
                fail(f"dist250k {label} rank {r['rank']}: residual "
                     f"{v['residual']:.3e}")
            if not v["band_dd"]:
                fail(f"dist250k {label}: band_dd did not serve every "
                     f"linear solve ({v['engines']})")
            if not v["dA"] <= 1e-9:
                fail(f"dist250k {label}: A is {v['dA']:.3e} from the "
                     f"stacked dd250k solve's")
        same(lambda r: r["solves"][i]["digest"], f"{label} A")
        same(lambda r: r["solves"][i]["cg"], f"{label} CG counts")
    for r in res:
        print(f"dist250k rank {r['rank']} launches over both solves "
              f"{r['launches']}; communicator ms per call: all_gather of a "
              f"part vector {r['comm_ms']['all_gather']:.4f}, psum of a "
              f"scalar {r['comm_ms']['psum']:.4f}", flush=True)
        loop_report(f"dist250k rank {r['rank']}", r["launches"],
                    r["loops"], exact=True)
        for name in ("band_mv", "bt_fwd", "bt_qbwd"):
            if not r["launches"][name] > 0:
                fail(f"dist250k: rank {r['rank']} never launched {name}")
    same(lambda r: repr(r["loops"]), "loop driver counts (the window "
         "stops every rank at the same iteration)")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}

    fg = res[0]["first_gen"]
    print(f"dist250k first-generation path (halo PCG, f64, Schwarz "
          f"{'kept' if fg['schwarz'] else 'latched off to Jacobi'}) over "
          f"the ranks: {fg['seconds']:.3f} s, {fg['iterations']} "
          f"iterations ({1e3 * fg['seconds'] / max(fg['iterations'], 1):.3f}"
          f" ms per iteration incl. the Schwarz build), relres "
          f"{fg['relres']:.3e}, masked iterations {fg['masked']}; peak "
          f"device memory per rank "
          f"{[round(r['first_gen']['peak_gb'], 2) for r in res]} GB; vs "
          f"host spsolve {fg['err']:.3e} (tol 1e-6; spsolve "
          f"{fg['spsolve_s']:.1f} s)", flush=True)
    if not (fg["relres"] <= 1e-10 and fg["err"] <= 1e-6):
        fail("dist250k: the first-generation path misses the host "
             "reference")
    same(lambda r: r["first_gen"]["digest"], "first-generation x")
    for stem in ("ACwound", "ACtest"):
        f = res[0]["fixtures"][stem]
        print(f"{stem} over the ranks ({f['nodes']} nodes): "
              f"{f['seconds']:.3f} s, residual {f['residual']:.2e}, "
              f"iterations {f['iterations']}, engines {f['engines']}; vs "
              f"golden {f['err']:.3e} (tol 1e-6), label cases "
              f"{'match' if f['label_cases'] else 'DIFFER'}", flush=True)
        if not (f["ok"] and f["err"] <= 1e-6 and f["label_cases"]):
            fail(f"{stem} over the ranks misses its golden file")
        same(lambda r: r["fixtures"][stem]["digest"], f"{stem} A")
    return {"dist250k": launches}


def clear_solver_caches(torch) -> None:
    from xfemm_tpu_torch.models import heatflow, magnetostatics
    from xfemm_tpu_torch.ops import solver
    solver._BAND_CACHE.clear()
    solver._PATTERN_CACHE.clear()
    solver._CBAND_CACHE.clear()
    magnetostatics._PACK_CACHE.clear()
    heatflow._HEAT_SETUP_CACHE.clear()
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
    reset_counts()
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
              f"Abf={lv.Abf is not None} coarse factor="
              f"{None if lv.bts is None else tuple(lv.bts.Sinv.shape)}",
              flush=True)
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
    # the BTSmoother runs before and after the fine level's coarse
    # correction: two bt_apply per V-cycle
    loop_report("4.47M", launches, loop_counts(), per_prec=2)
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


def check_live_hierarchy(torch, label: str, amg, bt, extra=()) -> None:
    """Every kernel of a path against its plain version on the path's
    live tensors: the bands in ``extra`` ((name, band) pairs, K1) and
    each level of ``amg``: its operator band (K5 where it is stored
    triu, else K1), its bf16 smoothing copy and its prolongator band
    (K1), at TOL of max|y|, each also timed (median) beside its bytes
    bound; and the sweeps of the factor or smoother
    ``bt`` (bt_fwd, bt_qbwd), step by step at TOL and chained at TOL
    (BF16_CHAIN_TOL for a bf16 factor)."""
    from xfemm_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    bands = [(name, bm, None) for name, bm in extra]
    for i, lv in enumerate(amg.levels):
        for name, bm in (("A", lv.A), ("Abf", lv.Abf), ("P", lv.P)):
            if bm is not None:
                bands.append((f"L{i} {name}", bm,
                              lv.dvec if name != "P" else None))
    for name, bm, dvec in bands:
        d = bm.dense
        x = torch.randn(bm.ncols, generator=gen, device="cuda")
        args = (bm.shift0, bm.cchunk, bm.ncols)
        NT, R, W = d.shape
        if dvec is not None:
            kern = "K5"

            def fn():
                return kernels.band_sym(d, dvec, x, *args)
            ref = kernels.band_sym_plain(d, dvec, x, *args)
            bound, _ = bound_ms(d.numel() * d.element_size()
                                + 3 * 4 * bm.ncols, 4.0 * NT * R * W)
        else:
            kern = "K1"

            def fn():
                return kernels.band_mv(d, x, *args)
            ref = kernels.band_mv_plain(d, x, *args)
            bound, _ = k1_bound(d, bm.ncols)
        y = fn()
        err = rel_err(y, ref)
        ms = median_ms(fn, reps=9)
        print(f"{label} {name} {kern} {tuple(d.shape)} {str(d.dtype)[6:]} "
              f"cchunk={bm.cchunk}: max rel err {err:.3e} (tol {TOL:g}); "
              f"median {ms:.4f} ms, bytes bound {bound:.4f} ms "
              f"({100 * bound / ms:.0f}%)", flush=True)
        if not err <= TOL:
            fail(f"{kern} disagrees with its plain version on the {label} "
                 f"band {name}")
        del y, ref
    torch.cuda.empty_cache()
    if bt is None:
        print(f"{label}: no factor kept, no sweeps to check", flush=True)
        return
    chain_tol = BF16_CHAIN_TOL if bt.G.dtype == torch.bfloat16 else TOL
    check_sweeps(kernels, torch, gen, bt, f"{label} {type(bt).__name__}",
                 chain_tol)
    NB, b, _ = bt.Sinv.shape
    rs = torch.randn((NB, b), generator=gen, device="cuda")
    ys = kernels.bt_fwd(bt.G, rs)
    vec = 2 * 4 * NB * b
    gbytes = bt.G.numel() * bt.G.element_size()
    sbytes = bt.Sinv.numel() * bt.Sinv.element_size()
    for name, fn, nbytes in (
            ("bt_fwd", lambda: kernels.bt_fwd(bt.G, rs), gbytes + vec),
            ("bt_qbwd", lambda: kernels.bt_qbwd(bt.Sinv, bt.G, ys),
             gbytes + sbytes + vec)):
        ms = median_ms(fn, reps=7)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{label} {name} ({NB}, {b}, {b}) {str(bt.G.dtype)[6:]}: median "
              f"{ms:.4f} ms, bytes bound {bound:.4f} ms "
              f"({100 * bound / ms:.0f}%)", flush=True)
    del rs, ys
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
    ap.add_argument("--heat-elec-only", action="store_true")
    ap.add_argument("--dd-only", action="store_true")
    ap.add_argument("--dist-only", action="store_true")
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

    if args.heat_elec_only:
        heat_elec_paths(torch)
        print("--heat-elec-only: no result line", flush=True)
        return
    if args.dd_only or args.dist_only:
        from xfemm_tpu_torch.models import benchprob, magnetostatics
        prob = benchprob.build(NODES)
        mesh = get_mesh(prob, NODES)
        t0 = time.time()
        A_ref = magnetostatics.solve(prob, mesh).A
        print(f"250k single-device reference solve {time.time() - t0:.3f} s",
              flush=True)
        clear_solver_caches(torch)
        if args.dd_only:
            dd_paths(torch, mesh, A_ref)
            window_pairs(torch, prob, mesh, devices=DD_PARTS)
        else:
            dd_250k(torch, prob, mesh, A_ref)
            dist_path(torch)
        print(f"--{'dd' if args.dd_only else 'dist'}-only: no result line",
              flush=True)
        return
    kernel_phase(torch, SEED)
    if args.kernels_only:
        print("--kernels-only: stopping after the kernel checks", flush=True)
        return
    rows, paths = [], {}
    if not args.large_only:
        rows, paths, mesh, sol_default = small_path(torch)
        paths.update(regime_paths(torch, mesh, sol_default))
        paths.update(surfaces_torque(torch))
        cli_250k(torch, mesh, sol_default.A)
        new = [v for k, v in paths.items()
               if k.startswith("TorqueBenchmark") or k == "250k post"]
        for name in ("band_mv", "bt_fwd", "bt_qbwd"):
            if not any(v[name] for v in new):
                fail(f"the surface and postprocessing paths never "
                     f"launched {name}")
        paths.update(ac_axi_paths(torch))
        paths.update(heat_elec_paths(torch))
        paths.update(dd_paths(torch, mesh, sol_default.A))
        paths.update(dist_path(torch))
        del mesh, sol_default
    large_launches, amg, bt = large_path(torch, LARGE_NODES)
    paths["4.47M"] = large_launches
    check_live_hierarchy(torch, "live", amg, bt)
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
        by_path = {k: v[r["name"]] for k, v in paths.items()
                   if v[r["name"]]}
        out.append({"name": r["name"], "route": "cuda",
                    "source": SOURCES[r["name"]],
                    "replaces": REPLACES[r["name"]],
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
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
