"""Hand-written Hopper kernels of the band engine, and their plain
PyTorch versions.

Four CUDA kernels carry every CG iteration of the band engine
(``ops/csrc``):

=========  ==========================  =====================================
wrapper    source                      replaces (TPU kernel of the JAX package)
=========  ==========================  =====================================
band_mv    csrc/band_mv.cu             pallas_band.py::_band_mv_call
band_sym   csrc/band_sym.cu            pallas_band.py::_band_sym_call
bt_fwd     csrc/bt_fwd.cu              blocktri.py::_bt_apply_pallas fwd_kernel
bt_qbwd    csrc/bt_qbwd.cu             blocktri.py::_bt_apply_pallas q_kernel
                                       and bwd_kernel
=========  ==========================  =====================================

The forward sweep, and the Sinv product with the backward sweep, each
run as ONE persistent cooperative launch with one exchange of flagged
words between its blocks per block step (``csrc/persist.cuh``): an
all-gather of y_{t-1} in the forward sweep, a reduce of G^T z partials
in the backward one. Their row splits and shared-memory rings are
planned in Python (``_fwd_plan``, ``_qbwd_plan``). Each source is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface under the package's ``_build/`` directory (first use; keyed
by a hash of the source, the shared headers and the flags) and bound
with ``ctypes``. Kernels launch
on PyTorch's current stream and allocate nothing; the wrappers allocate
the outputs and scratch.

A wrapper given CPU tensors runs the plain version (the CPU tests and
the CPU solve path); given CUDA tensors it launches its kernel or
raises -- it never falls back. ``LAUNCHES`` counts the wrapper calls
that launched a kernel (band_sym's two passes count once).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

_CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = {"band_mv": "band_mv.cu", "band_sym": "band_sym.cu",
           "bt_fwd": "bt_fwd.cu", "bt_qbwd": "bt_qbwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: kernel launches through the wrappers, by kernel name
LAUNCHES = {"band_mv": 0, "band_sym": 0, "bt_fwd": 0, "bt_qbwd": 0}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: ptxas resource report of the last build, by source
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc for sm_90a)")
    return found


def _lib_path(name: str) -> pathlib.Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build() -> dict[str, pathlib.Path]:
    """Compile every kernel source that is not built yet, all ``nvcc``
    processes started together; raise with the compiler's output on any
    failure. Returns {source name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    nvcc = None
    for name, out in paths.items():
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGS = {
    "band_mv": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR],
    "band_sym": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                 _INT, _INT, _PTR],
    "bt_fwd": [_PTR] * 4 + [_INT] * 9 + [_PTR, _PTR],
    "bt_fwd_occupancy": [_INT],
    "bt_qbwd": [_PTR] * 5 + [_INT] * 8 + [_PTR, _PTR],
    "bt_qbwd_occupancy": [_INT, _INT],
}


def _lib(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        if source not in _LIBS:
            path = build()[source]
            lib = ctypes.CDLL(str(path))
            for fn, sig in _SIGS.items():
                for suffix in ("f32", "bf16"):
                    f = getattr(lib, f"{fn}_{suffix}", None)
                    if f is not None:
                        f.argtypes = sig
                        f.restype = _INT
            _LIBS[source] = lib
    return _LIBS[source]


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _fn(source: str, name: str, dtype: torch.dtype):
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: storage dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    return getattr(_lib(source), f"{name}_{_SUFFIX[dtype]}")


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def fp32_matmul():
    """True IEEE fp32 matrix products (no TF32) inside the block, as the
    JAX package's ``default_matmul_precision("float32")``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


# ---------------------------------------------------------------------- #
# K1: banded-dense matvec                                                #
# ---------------------------------------------------------------------- #

def band_mv_plain(dense: torch.Tensor, x: torch.Tensor, shift0: int,
                  cchunk: int, ncols: int) -> torch.Tensor:
    """Plain version of K1 (the JAX package's XLA lowering,
    band.py:120-134): K shifted chunk views of the zero-padded x form
    the per-tile windows, then one batched contraction in fp32. x is
    rounded to the band's storage dtype first."""
    NT, R, W = dense.shape
    K = W // cchunk
    xs = x.to(dense.dtype).float()
    lpad = max(0, -shift0) * cchunk
    total = (NT + max(0, shift0) + K) * cchunk + lpad
    xpad = torch.zeros(total, dtype=torch.float32, device=x.device)
    xpad[lpad:lpad + ncols] = xs[:ncols]
    xc = xpad.view(-1, cchunk)
    base = shift0 + lpad // cchunk
    wins = torch.cat([xc[base + s: base + s + NT] for s in range(K)], dim=1)
    with fp32_matmul():
        y = torch.bmm(dense.float(), wins[:, :, None])[:, :, 0]
    return y.reshape(-1)


def band_mv(dense: torch.Tensor, x: torch.Tensor, shift0: int, cchunk: int,
            ncols: int) -> torch.Tensor:
    """y (NT*R,) = band (NT, R, W) times the logical (ncols,) vector x,
    accumulated in fp32 for f32 and bf16 bands."""
    if not x.is_cuda:
        return band_mv_plain(dense, x, shift0, cchunk, ncols)
    NT, R, W = dense.shape
    if x.dtype != torch.float32 or x.numel() < ncols:
        raise ValueError("band_mv: x must be float32 with ncols entries")
    _check("band_mv", dense, x)
    y = torch.empty(NT * R, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn("band_mv", "band_mv", dense.dtype)(
            dense.data_ptr(), x.data_ptr(), y.data_ptr(), NT, R, W, cchunk,
            shift0, ncols, _stream(x))
    _raise_on(rc, "band_mv")
    LAUNCHES["band_mv"] += 1
    return y


# ---------------------------------------------------------------------- #
# K5: fused symmetric (triu) band apply                                  #
# ---------------------------------------------------------------------- #

def band_rmatvec_plain(dense: torch.Tensor, y: torch.Tensor, shift0: int,
                       cchunk: int, ncols: int) -> torch.Tensor:
    """x (ncols,) = A^T y from the SAME (NT, R, W) band as K1 (the JAX
    package's ``band.band_rmatvec``, band.py:137): one batched
    contraction gives each tile's (W,) column sums, then K static
    shifted adds place the overlapping window slices. y is rounded to
    the band's storage dtype first."""
    NT, R, W = dense.shape
    K = W // cchunk
    n = min(y.shape[0], NT * R)
    yt = torch.zeros(NT * R, dtype=torch.float32, device=y.device)
    yt[:n] = y[:n].to(dense.dtype).float()
    with fp32_matmul():
        contrib = torch.bmm(yt.view(NT, 1, R), dense.float())[:, 0, :]
    contrib = contrib.view(NT, K, cchunk)
    lpad = max(0, -shift0) * cchunk
    total = (NT + max(0, shift0) + K) * cchunk + lpad
    z = torch.zeros((total // cchunk, cchunk), dtype=torch.float32,
                    device=y.device)
    base = shift0 + lpad // cchunk
    for s in range(K):
        z[base + s: base + s + NT] += contrib[:, s]
    return z.view(-1)[lpad:lpad + ncols]


def band_sym_plain(dense: torch.Tensor, dvec: torch.Tensor, x: torch.Tensor,
                   shift0: int, cchunk: int, ncols: int) -> torch.Tensor:
    """Plain version of K5: the JAX package's XLA two-pass
    ``band_matvec + band_rmatvec - dvec * x`` (band.py:528) over the
    triu band; returns the (ncols,) product."""
    xf = x[:ncols].float()
    return (band_mv_plain(dense, xf, shift0, cchunk, ncols)[:ncols]
            + band_rmatvec_plain(dense, xf, shift0, cchunk, ncols)
            - dvec[:ncols] * xf)


#: window columns one K5 block streams (csrc/band_sym.cu TW)
_SYM_SLICE = 512


def band_sym(dense: torch.Tensor, dvec: torch.Tensor, x: torch.Tensor,
             shift0: int, cchunk: int, ncols: int) -> torch.Tensor:
    """y (ncols,) = U x + U^T x - dvec * x for a square level stored as
    its upper triangle U in the (NT, R, W) band, in one stream of the
    band (K5); fp32 accumulation for f32 and bf16 bands."""
    if not x.is_cuda:
        return band_sym_plain(dense, dvec, x, shift0, cchunk, ncols)
    NT, R, W = dense.shape
    if x.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise ValueError("band_sym: x and dvec must be float32")
    if x.numel() < ncols or dvec.numel() < ncols or ncols > NT * R:
        raise ValueError("band_sym: x and dvec need ncols <= NT*R entries")
    if W % cchunk != 0:
        raise ValueError("band_sym: W must be a multiple of cchunk")
    _check("band_sym", dense, dvec, x)
    slices = -(-W // _SYM_SLICE)
    y = torch.empty(ncols, dtype=torch.float32, device=x.device)
    rowpart = torch.empty(slices * NT * R, dtype=torch.float32,
                          device=x.device)
    colpart = torch.empty(NT * W, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn("band_sym", "band_sym", dense.dtype)(
            dense.data_ptr(), dvec.data_ptr(), x.data_ptr(), y.data_ptr(),
            rowpart.data_ptr(), colpart.data_ptr(), NT, R, W, cchunk, shift0,
            ncols, _stream(x))
    _raise_on(rc, "band_sym")
    LAUNCHES["band_sym"] += 1
    return y


# ---------------------------------------------------------------------- #
# K2-K4: block-Thomas sweeps                                             #
# ---------------------------------------------------------------------- #

def _as_factor_dtype(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The carried vector rounded to the factor's storage type, in fp32."""
    return v if dtype == torch.float32 else v.to(dtype).float()


def bt_fwd_plain(G: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y_0 = r_0, y_t = r_t - G_{t-1} y_{t-1} (the scan lowering,
    blocktri.py:523-529). r is (NB, b)."""
    y = torch.empty_like(r)
    y[0] = r[0]
    with fp32_matmul():
        for t in range(1, r.shape[0]):
            y[t] = r[t] - G[t - 1].float() @ _as_factor_dtype(y[t - 1],
                                                              G.dtype)
    return y


def bt_q_plain(Sinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """q_t = Sinv_t y_t for every block t."""
    with fp32_matmul():
        return torch.bmm(Sinv.float(),
                         _as_factor_dtype(y, Sinv.dtype)[:, :, None])[:, :, 0]


def bt_bwd_plain(G: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """z_{NB-1} = q_{NB-1}, z_t = q_t - G_t^T z_{t+1} (the reverse scan,
    blocktri.py:531-539, with the Sinv product already in q)."""
    z = torch.empty_like(q)
    NB = q.shape[0]
    z[NB - 1] = q[NB - 1]
    with fp32_matmul():
        for t in range(NB - 2, -1, -1):
            z[t] = q[t] - G[t].float().T @ _as_factor_dtype(z[t + 1], G.dtype)
    return z


def bt_qbwd_plain(Sinv: torch.Tensor, G: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Plain version of bt_qbwd: the Sinv products, then the backward
    sweep."""
    return bt_bwd_plain(G, bt_q_plain(Sinv, y))


#: the persistent sweeps' (csrc/bt_fwd.cu, csrc/bt_qbwd.cu) compute
#: threads, columns or polled words per compute thread, rows per warp,
#: grid and ring limits, and their mbarrier area (THREADS, 8 / MAXW,
#: MAXR, MAX_BLOCKS, MAX_STAGES, BAR_BYTES)
_PK_THREADS = 256
_PK_MAX_COLS = 8
_PK_MAX_ROWS = 2
_PK_MAX_BLOCKS = 160
_PK_MAX_STAGES = 32
_PK_BAR_BYTES = 1024
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: the ring takes the largest stage that still leaves this many stages
_PK_MIN_STAGES = 4


class SweepPlan(NamedTuple):
    """Grid and shared-memory ring of one bt_fwd or bt_qbwd launch."""
    blocks: int       # grid size, at most one block per SM
    rows: int         # rows of every G_t (and Sinv_t) a block owns (the
                      # last block: what is left, at least one)
    stage_rows: int   # rows one ring stage holds
    chunks: int       # chunks a block's rows of one matrix stream in
    stages: int       # ring stages
    smem_bytes: int   # dynamic shared memory of one block


def _sweep_plan(name: str, b: int, n_sm: int, smem) -> SweepPlan:
    """Row split and ring of a persistent sweep for block size ``b`` on a
    card of ``n_sm`` SMs: the fewest rows per block that spread b rows
    over at most n_sm blocks, then the fewest chunks per matrix and block
    step that leave _PK_MIN_STAGES stages. ``smem(rows, blocks,
    stage_rows, stages)`` is the kernel's shared memory per block."""
    if b <= 0 or b % 8 or b > _PK_THREADS * _PK_MAX_COLS:
        raise ValueError(f"{name}: block size {b} must be a multiple of 8 "
                         f"up to {_PK_THREADS * _PK_MAX_COLS}")
    rows = -(-b // n_sm)
    blocks = -(-b // rows)
    if rows > _PK_THREADS // 32 * _PK_MAX_ROWS or blocks > _PK_MAX_BLOCKS:
        raise ValueError(f"{name}: b={b} does not split over {n_sm} SMs")
    for chunks in range(1, rows + 1):
        stage_rows = -(-rows // chunks)
        base = smem(rows, blocks, stage_rows, 0)
        per_stage = smem(rows, blocks, stage_rows, 1) - base
        stages = min(_PK_MAX_STAGES, (SMEM_LIMIT - base) // per_stage)
        if stages >= _PK_MIN_STAGES or stage_rows == 1:
            break
    if stages < max(2, chunks):
        raise ValueError(f"{name}: b={b} leaves no room for a ring")
    return SweepPlan(blocks=blocks, rows=rows, stage_rows=stage_rows,
                     chunks=chunks, stages=stages,
                     smem_bytes=smem(rows, blocks, stage_rows, stages))


def _fwd_smem(b: int, item: int, stage_rows: int, stages: int) -> int:
    """Shared memory of one bt_fwd block (csrc/bt_fwd.cu smem_need):
    mbarriers, the ring (each stage: stage_rows rows of G_t), and y^ in
    two buffers."""
    return _PK_BAR_BYTES + stages * stage_rows * b * item + 2 * 4 * b


def _fwd_plan(b: int, dtype: torch.dtype, n_sm: int) -> SweepPlan:
    """Row split and ring plan of bt_fwd: the row split of bt_qbwd, one
    matrix streamed per step (at b=2048 in f32 a block's 16 rows, 128
    KB, stream in 3 chunks)."""
    item = torch.empty((), dtype=dtype).element_size()
    return _sweep_plan("bt_fwd", b, n_sm,
                       lambda rows, blocks, sr, st: _fwd_smem(b, item, sr,
                                                              st))


#: copies of bt_fwd's exchange scratch: every row is published to all of
#: them, block k polls copy k % _FWD_COPIES
_FWD_COPIES = 4


def fwd_blocks_per_sm(dtype: torch.dtype, smem_bytes: int) -> int:
    """Blocks of bt_fwd resident on one SM at ``smem_bytes`` of shared
    memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = _fn("bt_fwd", "bt_fwd_occupancy", dtype)(smem_bytes)
    _raise_on(max(0, -n), "bt_fwd occupancy")
    return n


#: the points of a step bt_fwd's trace records, in order (clock64 of the
#: first thread of the first and the last block; "own words in": that
#: thread's share of the step's polled words; the named barrier after it
#: defers its wait past the "all words in" clock, so the wait for the rest
#: of the block's words shows up before the next step's "start")
FWD_TRACE_POINTS = ("start", "G stage in", "row published", "own words in",
                    "all words in")


def bt_fwd(G: torch.Tensor, r: torch.Tensor,
           trace: torch.Tensor | None = None) -> torch.Tensor:
    """Forward block-Thomas sweep (K2) over (NB, b) blocks: y_0 = r_0,
    y_t = r_t - G_{t-1} y^_{t-1}, in one persistent cooperative launch.
    Raises if the card refuses the launch (every block must be resident).
    ``trace``, an int64 (2, NB, 5) CUDA tensor, receives the clock at
    FWD_TRACE_POINTS of every step in the first and the last block."""
    if not r.is_cuda:
        return bt_fwd_plain(G, r)
    NB, b = r.shape
    if r.dtype != torch.float32:
        raise ValueError("bt_fwd: vector must be float32")
    if G.shape != (NB - 1, b, b):
        raise ValueError(f"bt_fwd: G {tuple(G.shape)} does not hold the "
                         f"NB-1 blocks of r ({NB}, {b})")
    _check("bt_fwd", G, r, *(() if trace is None else (trace,)))
    if any(t.data_ptr() % 16 for t in (G, r)):
        raise ValueError("bt_fwd: tensors must be 16-byte aligned")
    npts = len(FWD_TRACE_POINTS)
    if trace is not None and (trace.dtype != torch.int64
                              or trace.shape != (2, NB, npts)):
        raise ValueError(f"bt_fwd: trace must be an int64 (2, NB, {npts}) "
                         "tensor")
    plan = _fwd_plan(b, G.dtype, torch.cuda.get_device_properties(r.device)
                     .multi_processor_count)
    y = torch.empty_like(r)
    # the exchange: 2 step slots x _FWD_COPIES copies of b 8-byte words
    work = torch.empty(2 * _FWD_COPIES * 2 * b, dtype=torch.float32,
                       device=r.device)
    with torch.cuda.device(r.device):
        rc = _fn("bt_fwd", "bt_fwd", G.dtype)(
            G.data_ptr(), r.data_ptr(), y.data_ptr(), work.data_ptr(), NB,
            b, plan.rows, plan.stage_rows, plan.chunks, plan.stages,
            _FWD_COPIES, plan.blocks, plan.smem_bytes,
            0 if trace is None else trace.data_ptr(), _stream(r))
    _raise_on(rc, "bt_fwd")
    LAUNCHES["bt_fwd"] += 1
    return y


def _qbwd_smem(b: int, item: int, rows: int, blocks: int, stage_rows: int,
               stages: int) -> int:
    """Shared memory of one block (csrc/bt_qbwd.cu smem_need): mbarriers,
    the ring (each stage: stage_rows rows of one matrix, and y_t), the
    block's z^ for two steps, and one step's partials of its rows from
    every block."""
    return (_PK_BAR_BYTES + stages * (stage_rows * b * item + 4 * b)
            + 4 * (2 * rows + blocks * rows))


def _qbwd_plan(b: int, dtype: torch.dtype, n_sm: int) -> SweepPlan:
    """Row split and ring plan of bt_qbwd: two matrices (Sinv_t with y_t,
    G_{t-1}) streamed per step (at b=2048 in f32 a block's 16 rows of
    one matrix, 128 KB, stream in 4 chunks)."""
    item = torch.empty((), dtype=dtype).element_size()
    return _sweep_plan("bt_qbwd", b, n_sm,
                       lambda rows, blocks, sr, st: _qbwd_smem(
                           b, item, rows, blocks, sr, st))


def qbwd_blocks_per_sm(b: int, dtype: torch.dtype, smem_bytes: int) -> int:
    """Blocks of bt_qbwd for block size ``b`` resident on one SM at
    ``smem_bytes`` of shared memory
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = _fn("bt_qbwd", "bt_qbwd_occupancy", dtype)(b, smem_bytes)
    _raise_on(max(0, -n), "bt_qbwd occupancy")
    return n


#: the points of a step bt_qbwd's trace records, in order (clock64 of the
#: first thread of the first and the last block)
QBWD_TRACE_POINTS = ("start", "q done", "partials in", "z done",
                     "readers synced", "G stage in", "G product done",
                     "partials published")


def bt_qbwd(Sinv: torch.Tensor, G: torch.Tensor, y: torch.Tensor,
            trace: torch.Tensor | None = None) -> torch.Tensor:
    """z = the Sinv products and backward block-Thomas sweep (K3 + K4)
    over (NB, b) blocks: z_{NB-1} = Sinv_{NB-1} y_{NB-1}, z_t = Sinv_t
    y_t - G_t^T z_{t+1}, in one persistent cooperative launch. Raises if
    the card refuses the launch (every block must be resident).
    ``trace``, an int64 (2, NB, 8) CUDA tensor, receives the clock at
    QBWD_TRACE_POINTS of every step in the first and the last block."""
    if not y.is_cuda:
        return bt_qbwd_plain(Sinv, G, y)
    NB, b = y.shape
    if y.dtype != torch.float32:
        raise ValueError("bt_qbwd: y must be float32")
    if Sinv.shape != (NB, b, b) or G.shape != (NB - 1, b, b):
        raise ValueError(f"bt_qbwd: Sinv {tuple(Sinv.shape)} and G "
                         f"{tuple(G.shape)} do not match y ({NB}, {b})")
    if G.dtype != Sinv.dtype:
        raise ValueError("bt_qbwd: Sinv and G must share a storage dtype")
    _check("bt_qbwd", Sinv, G, y, *(() if trace is None else (trace,)))
    if any(t.data_ptr() % 16 for t in (Sinv, G, y)):
        raise ValueError("bt_qbwd: tensors must be 16-byte aligned")
    if trace is not None and (trace.dtype != torch.int64
                              or trace.shape != (2, NB, 8)):
        raise ValueError("bt_qbwd: trace must be an int64 (2, NB, 8) "
                         "tensor")
    plan = _qbwd_plan(b, Sinv.dtype,
                      torch.cuda.get_device_properties(y.device)
                      .multi_processor_count)
    z = torch.empty_like(y)
    # the exchange: 3 step slots of (blocks, blocks, rows) 8-byte words
    work = torch.empty(6 * plan.blocks * plan.blocks * plan.rows,
                       dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = _fn("bt_qbwd", "bt_qbwd", Sinv.dtype)(
            Sinv.data_ptr(), G.data_ptr(), y.data_ptr(), z.data_ptr(),
            work.data_ptr(), NB, b, plan.rows, plan.stage_rows, plan.chunks,
            plan.stages, plan.blocks, plan.smem_bytes,
            0 if trace is None else trace.data_ptr(), _stream(y))
    _raise_on(rc, "bt_qbwd")
    LAUNCHES["bt_qbwd"] += 1
    return z
