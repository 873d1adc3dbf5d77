"""Hand-written Hopper kernels of the band engine, and their plain
PyTorch versions.

Five CUDA kernels carry every CG iteration of the band engine
(``ops/csrc``):

=========  ==========================  =====================================
wrapper    source                      replaces (TPU kernel of the JAX package)
=========  ==========================  =====================================
band_mv    csrc/band_mv.cu             pallas_band.py::_band_mv_call
band_sym   csrc/band_sym.cu            pallas_band.py::_band_sym_call
bt_fwd     csrc/bt_sweep.cu            blocktri.py::_bt_apply_pallas fwd_kernel
bt_q       csrc/bt_sweep.cu            blocktri.py::_bt_apply_pallas q_kernel
bt_bwd     csrc/bt_sweep.cu            blocktri.py::_bt_apply_pallas bwd_kernel
=========  ==========================  =====================================

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under the package's ``_build/`` directory
(first use; keyed by a hash of the source and flags) and bound with
``ctypes``. Kernels launch on PyTorch's current stream and allocate
nothing; the wrappers allocate the outputs.

A wrapper given CPU tensors runs the plain version (the CPU tests and
the CPU solve path); given CUDA tensors it launches its kernel or
raises -- it never falls back. ``LAUNCHES`` counts the wrapper calls
that launched a kernel (a sweep call enqueues NB-1 step grids and counts
once; band_sym's two passes count once).
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

import torch

_CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = {"band_mv": "band_mv.cu", "band_sym": "band_sym.cu",
           "bt_sweep": "bt_sweep.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: kernel launches through the wrappers, by kernel name
LAUNCHES = {"band_mv": 0, "band_sym": 0, "bt_fwd": 0, "bt_q": 0,
            "bt_bwd": 0}

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
    "bt_fwd": [_PTR, _PTR, _PTR, _INT, _INT, _PTR],
    "bt_q": [_PTR, _PTR, _PTR, _INT, _INT, _PTR],
    "bt_bwd": [_PTR, _PTR, _PTR, _INT, _INT, _PTR],
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


def _sweep(name: str, mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    NB, b = v.shape
    if v.dtype != torch.float32:
        raise ValueError(f"{name}: vector must be float32")
    if mat.shape[1:] != (b, b):
        raise ValueError(f"{name}: factor blocks {tuple(mat.shape)} do not "
                         f"match vector blocks ({NB}, {b})")
    _check(name, mat, v)
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        rc = _fn("bt_sweep", name, mat.dtype)(
            mat.data_ptr(), v.data_ptr(), out.data_ptr(), NB, b, _stream(v))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def bt_fwd(G: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Forward block-Thomas sweep (K2) over (NB, b) blocks."""
    if not r.is_cuda:
        return bt_fwd_plain(G, r)
    if G.shape[0] != r.shape[0] - 1 and r.shape[0] > 1:
        raise ValueError("bt_fwd: G must hold NB-1 blocks")
    return _sweep("bt_fwd", G, r)


def bt_q(Sinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched block products q_t = Sinv_t y_t (K3)."""
    if not y.is_cuda:
        return bt_q_plain(Sinv, y)
    if Sinv.shape[0] != y.shape[0]:
        raise ValueError("bt_q: Sinv must hold NB blocks")
    return _sweep("bt_q", Sinv, y)


def bt_bwd(G: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Backward block-Thomas sweep (K4) over (NB, b) blocks."""
    if not q.is_cuda:
        return bt_bwd_plain(G, q)
    if G.shape[0] != q.shape[0] - 1 and q.shape[0] > 1:
        raise ValueError("bt_bwd: G must hold NB-1 blocks")
    return _sweep("bt_bwd", G, q)
