"""Design measurements of K1 (csrc/band_mv.cu) on one CUDA card: the
kernel against variants of its own source and against other launch
plans, timed in turns on the port's K1 operand shapes.

    python3 -m xfemm_tpu_torch.ops.k1_variants

Variants (text patches of the current source, built with nvcc under the
package's ``_build/k1_variants/``; the script stops if a patch no longer
applies):

- ``base``: the source as it is;
- ``noconsume``: the consumers release each stage without reading it,
  so only the TMA ring streams: the ceiling of the stream itself;
- ``nostage``: the x window is staged for a block's first tile only
  (wrong results): what restaging the window at each tile change costs;
- ``noevict``: the band's bulk copies without the L2 evict-first policy;
- ``inter8``: blocks take chunks of an eighth of a tile in turn
  (block k: chunks k, k + blocks, ...) instead of one contiguous range.

Each is timed with the kernel's own plan (``kernels._mv_plan``); ``base``
also with every other (blocks per SM, stage rows) that fits, and with 32
lanes per row where the plan takes fewer. Beside them: the wrapper ``kernels.band_mv`` in batches and as a
lone call, its host time per call, ``torch.sum`` over the band (a read
of the same bytes) and, for f32 bands, ``torch.bmm`` over the windows.
Times are medians of CUDA-event batches of back-to-back calls; the bound
is the band read once plus x and y, at 3.35 TB/s.
"""

import ctypes
import statistics
import subprocess
import time

import torch

from . import kernels

CSRC = kernels._CSRC
OUT = kernels.BUILD_DIR / "k1_variants"
HBM_BYTES_PER_S = 3.35e12



def patch(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"k1_variants: the source no longer holds {old!r}")
    return s.replace(old, new)


def variant(name: str) -> str:
    s = (CSRC / "band_mv.cu").read_text()
    if name == "noconsume":
        s = patch(s, "if (rr < nr) {", "if (false && rr < nr) {")
    elif name == "nostage":
        s = patch(s, "win[c * W + w] = to_storage<T>(",
                  "if (t == t0) win[c * W + w] = to_storage<T>(")
    elif name == "noevict":
        s = patch(s, "persist::ring_copy_once(", "persist::ring_copy(")
    elif name == "inter8":
        s = patch(s, "if (i0 >= i1) return;",
                  "const long long GRP = max(1, spt / 8);\n"
                  "  if ((long long)blockIdx.x * GRP >= items) return;")
        s = patch(s, "      for (long long i = i0; i < i1; ++i) {",
                  "      for (long long ch = blockIdx.x; ch * GRP < items;"
                  " ch += gridDim.x)\n      for (long long i = ch * GRP; "
                  "i < min(items, (ch + 1) * GRP); ++i) {")
        s = patch(s, "  for (long long t = t0; t <= t1; ++t) {",
                  "  long long jb = 0;\n  int nch = 0;\n"
                  "  for (long long ch = blockIdx.x; ch * GRP < items; "
                  "ch += gridDim.x, ++nch) {\n"
                  "    const long long ci0 = ch * GRP, "
                  "ci1 = min(items, (ch + 1) * GRP);\n"
                  "    const long long t = ci0 / spt;")
        s = patch(s, "if (t > t0) asm", "if (nch) asm")
        s = patch(s, "const long long a = max(i0, t * spt) - i0, "
                     "b = min(i1, (t + 1) * spt) - i0;",
                  "const long long a = jb, b = jb + (ci1 - ci0);")
        s = patch(s, "const int r0 = (int)(i0 + j - t * spt) * srows;",
                  "const int r0 = (int)(ci0 + (j - jb) - t * spt) * srows;")
        s = patch(s, "ring_arrive(empty + slot);\n    }\n  }\n}",
                  "ring_arrive(empty + slot);\n    }\n    jb = b;\n  }\n}")
    return s


NAMES = ("base", "noconsume", "nostage", "noevict", "inter8")


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for name in NAMES:
        src = OUT / f"band_mv_{name}.cu"
        src.write_text(variant(name))
        lib = OUT / f"libband_mv_{name}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k1_variants: nvcc failed on {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for suffix in ("f32", "bf16"):
            fn = getattr(cdll, f"band_mv_{suffix}")
            fn.argtypes = kernels._SIGS["band_mv"]
            fn.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def median_ms(fn, reps: int = 9, batch: int = 10) -> float:
    for _ in range(2):
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


def launcher(lib, dense, x, y, args, C, plan):
    NT, R, W = dense.shape
    fn = getattr(lib, "band_mv_" + kernels._SUFFIX[dense.dtype])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        rc = fn(dense.data_ptr(), x.data_ptr(), y.data_ptr(), NT, R, W,
                *args, C, plan.stage_rows, plan.stages, plan.lanes_per_row,
                plan.blocks, plan.smem_bytes, stream)
        if rc:
            raise SystemExit(f"k1_variants: launch failed with {rc}")
    return go


def plans(NT, R, W, dtype, C, n_sm):
    """The kernel's plan first, then every other (blocks per SM, stage
    rows) whose ring of at least 8 stages fits, and the plan with 32
    lanes per row where it has fewer."""
    own = kernels._mv_plan(NT, R, W, dtype, C, n_sm)
    out = [own]
    item = torch.empty((), dtype=dtype).element_size()
    for sr in (own.stage_rows, 2 * own.stage_rows):
        if sr > R:
            continue
        for bps in (1, 2):
            budget = min(kernels.SMEM_LIMIT,
                         kernels.SM_SMEM // bps - kernels.SMEM_RESERVED)
            base = kernels._mv_smem(W, item, C, sr, 0)
            st = min(32, max(0, budget - base) // (sr * W * item) // 8 * 8)
            if st < 8:
                continue
            items = NT * -(-R // sr)
            p = own._replace(blocks=min(items, n_sm * bps), blocks_per_sm=bps,
                             items=items, stage_rows=sr, stages=st,
                             smem_bytes=kernels._mv_smem(W, item, C, sr, st))
            if p != own:
                out.append(p)
    if own.lanes_per_row < 32:
        out.append(own._replace(lanes_per_row=32))
    return out


#: (label, (NT, R, W), dtype, shift0, cchunk, ncols, C): the 250k band in
#: f32 (one and two columns) and bf16, an ac125k operator band with two
#: columns, a bf16 prolongator band
CASES = [
    ("250k", (1949, 128, 2176), torch.float32, -8, 128, 249_469, 1),
    ("250k C=2", (1949, 128, 2176), torch.float32, -8, 128, 249_469, 2),
    ("ac125k Ar C=2", (244, 512, 2560), torch.float32, -2, 512, 124_712, 2),
    ("250k bf16", (1949, 128, 2176), torch.bfloat16, -8, 128, 249_469, 1),
    ("P bf16", (975, 128, 352), torch.bfloat16, 0, 32, 31_195, 1),
]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, shape, dtype, shift0, cc, ncols, C in CASES:
        NT, R, W = shape
        dense = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x = torch.randn((ncols, C) if C > 1 else ncols, generator=gen,
                        device="cuda")
        y = torch.empty((NT * R, C) if C > 1 else NT * R, device="cuda")
        args = (cc, shift0, ncols)
        ref = kernels.band_mv_plain(dense, x, shift0, cc, ncols)
        bound = (dense.numel() * dense.element_size()
                 + 4 * C * (ncols + NT * R)) / HBM_BYTES_PER_S * 1e3
        rows = []
        all_plans = plans(NT, R, W, dtype, C, n_sm)
        for name in NAMES:
            for p in all_plans if name == "base" else all_plans[:1]:
                go = launcher(libs[name], dense, x, y, args, C, p)
                go()
                torch.cuda.synchronize()
                err = float((y - ref).abs().max() / ref.abs().max())
                rows.append((name, p, median_ms(go), err))
        again = median_ms(launcher(libs["base"], dense, x, y, args, C,
                                   all_plans[0]))
        wrap = lambda: kernels.band_mv(dense, x, shift0, cc, ncols)  # noqa
        t_wrap, t_lone = median_ms(wrap), median_ms(wrap, 15, 1)
        t_sum = median_ms(lambda: dense.sum(dtype=torch.float32))
        tiny, xt = dense[:1].contiguous(), x[:ncols // 8].contiguous()
        for _ in range(20):
            kernels.band_mv(tiny, xt, 0, cc, ncols // 8)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(500):
            kernels.band_mv(tiny, xt, 0, cc, ncols // 8)
        host = (time.perf_counter() - h0) / 500 * 1e3
        torch.cuda.synchronize()
        print(f"== {label} {shape} {str(dtype)[6:]} C={C}: bound "
              f"{bound:.4f} ms; torch.sum {t_sum:.4f} ms "
              f"({100 * bound / t_sum:.1f}%); wrapper {t_wrap:.4f} ms, lone "
              f"call {t_lone:.4f} ms, host time per call {host:.4f} ms",
              flush=True)
        if dtype == torch.float32:
            xs = x if C > 1 else x[:, None]
            lpad = max(0, -shift0) * cc
            total = (NT + max(0, shift0) + W // cc) * cc + lpad
            xpad = torch.zeros((total, C), device="cuda")
            xpad[lpad:lpad + ncols] = xs[:ncols]
            win = xpad.as_strided((NT, W, C), (cc * C, C, 1),
                                  (shift0 + lpad // cc) * cc * C)
            t_bmm = median_ms(lambda: torch.bmm(dense, win))
            print(f"   torch.bmm over the windows {t_bmm:.4f} ms "
                  f"({100 * bound / t_bmm:.1f}%)", flush=True)
        for name, p, ms, err in rows:
            print(f"   {name:9s} {p.blocks_per_sm} block(s)/SM, "
                  f"{p.stages} stages x {p.stage_rows} row(s), "
                  f"{p.lanes_per_row} lanes per row: {ms:.4f} ms "
                  f"({100 * bound / ms:.1f}%), err {err:.2e}", flush=True)
        print(f"   base again (own plan): {again:.4f} ms "
              f"({100 * bound / again:.1f}%)", flush=True)
        del dense, x, y, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
