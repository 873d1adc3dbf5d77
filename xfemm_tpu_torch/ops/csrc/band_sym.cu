// Fused symmetric band apply of the band engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel xfemm_tpu/ops/pallas_band.py::_band_sym_call
// (reached through band_apply_sym_pallas). A level stored as its upper
// triangle U (diagonal included) in the (NT, R, W) band layout of
// band_mv.cu is applied as
//
//   y = U x + U^T x - d * x
//
// in ONE stream of the band. Row tile t of U covers rows t*R .. t*R+R-1
// and the column window starting at (t + shift0) * cchunk.
//
// The TPU kernel walks the row tiles in order and returns, per tile, the
// row products (1, R) and the column partial sums x_rows(t)^T U_t (1, W);
// an XLA epilogue adds the K = W / cchunk overlapping window slices of
// the column sums. Blocks on Hopper run in no order, so this file does
// the same in two launches, deterministically and without atomics:
//
//   pass A (band_sym_rows): one block per (row tile, 512-column slice of
//     the window). It streams its part of U_t once. Each warp owns rows
//     warp, warp+8, ...; each lane owns 16 columns of the slice for every
//     row, so the lane keeps both its window values and its column
//     partial sums in registers. Row products are warp-reduced and
//     written per slice to rowpart (slices, NT*R); column partial sums
//     are reduced over the 8 warps in shared memory in a fixed order and
//     written to colpart (NT, W).
//   pass B (band_sym_cols): one thread per output i sums the row
//     products of its row over the slices, the K column partial sums of
//     its column in window order k = 0..K-1 (the epilogue's order), and
//     subtracts d_i x_i.
//
// Bound: bytes. The band is read once (18.30 GB in f32 at the 4.47M-node
// fine level (34908, 128, 1024)) with 4 flops per element; colpart is
// NT*W*4 bytes (143 MB there) written once and read once. Offsets into
// the band are 64-bit (that band holds 4.57e9 elements). Products
// accumulate in fp32 FMA (never TF32); for a bf16 band the window and the
// row values of x are rounded to bf16 first, as the TPU kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TW = 512;              // window columns per block
constexpr int PER_LANE = TW / 32;    // columns each lane owns

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one 16-byte vector of band values, as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __bfloat162float(h[k]);
  }
};

// slice column of a lane's k-th value: vectors of V adjacent columns,
// 32 lanes side by side (VEC), or one column per lane (scalar path)
template <typename T, bool VEC>
__device__ __forceinline__ int lane_col(int lane, int k) {
  constexpr int V = Vec<T>::V;
  return VEC ? (k / V) * (32 * V) + lane * V + (k % V) : k * 32 + lane;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
band_sym_rows(const T* __restrict__ dense, const float* __restrict__ x,
              float* __restrict__ rowpart, float* __restrict__ colpart,
              int NT, int R, int W, int cchunk, int shift0, int ncols,
              int slices) {
  constexpr int V = Vec<T>::V;
  __shared__ float red[WARPS][TW];
  const int t = blockIdx.x / slices;
  const int s = blockIdx.x % slices;
  const int c0 = s * TW;
  const int tw = min(TW, W - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the lane's window values: x at columns (t + shift0) * cchunk + c0 + c
  const long long xcol0 = (long long)(t + shift0) * cchunk + c0;
  float xv[PER_LANE];
  float ca[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int c = lane_col<T, VEC>(lane, k);
    const long long g = xcol0 + c;
    xv[k] = (c < tw && g >= 0 && g < ncols) ? round_to<T>(__ldg(x + g)) : 0.f;
    ca[k] = 0.f;
  }

  const long long NTR = (long long)NT * R;
  const T* tile = dense + (size_t)t * R * W + c0;
#pragma unroll 2
  for (int r = warp; r < R; r += WARPS) {
    const T* row = tile + (size_t)r * W;
    float u[PER_LANE];
    if (VEC) {
#pragma unroll
      for (int i = 0; i < PER_LANE / V; ++i) {
        const int c = i * 32 * V + lane * V;
        if (c < tw) {
          Vec<T>::load(row + c, u + i * V);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) u[i * V + e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int c = k * 32 + lane;
        u[k] = c < tw ? to_f(row[c]) : 0.f;
      }
    }
    const long long gi = (long long)t * R + r;
    const float xr = gi < ncols ? round_to<T>(__ldg(x + gi)) : 0.f;
    float rp = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      rp = fmaf(u[k], xv[k], rp);
      ca[k] = fmaf(xr, u[k], ca[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rp += __shfl_xor_sync(0xffffffffu, rp, o);
    if (lane == 0) rowpart[(size_t)s * NTR + gi] = rp;
  }

#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) red[warp][lane_col<T, VEC>(lane, k)] = ca[k];
  __syncthreads();
  for (int i = threadIdx.x; i < tw; i += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red[w][i];
    colpart[(size_t)t * W + c0 + i] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
band_sym_cols(const float* __restrict__ rowpart,
              const float* __restrict__ colpart,
              const float* __restrict__ dvec, const float* __restrict__ x,
              float* __restrict__ y, int NT, int R, int W, int cchunk,
              int shift0, int ncols, int slices) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= ncols) return;
  const long long NTR = (long long)NT * R;
  float rp = 0.f;
  for (int s = 0; s < slices; ++s) rp += rowpart[(size_t)s * NTR + i];
  const long long q = i / cchunk;
  const long long j = i - q * cchunk;
  const int K = W / cchunk;
  float z = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long tt = q - shift0 - k;
    if (tt >= 0 && tt < NT) z += colpart[tt * W + (long long)k * cchunk + j];
  }
  y[i] = (rp + z) - dvec[i] * x[i];
}

template <typename T>
int launch(const void* dense, const void* dvec, const void* x, void* y,
           void* rowpart, void* colpart, int NT, int R, int W, int cchunk,
           int shift0, int ncols, void* stream) {
  if (NT <= 0 || R <= 0 || W <= 0 || ncols <= 0) return 0;
  if (cchunk <= 0 || W % cchunk != 0) return (int)cudaErrorInvalidValue;
  const int slices = (W + TW - 1) / TW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int V = Vec<T>::V;
  const bool vec = (W % V == 0) &&
                   (reinterpret_cast<uintptr_t>(dense) % 16 == 0);
  const dim3 grid_a((unsigned)((long long)NT * slices));
  if (vec)
    band_sym_rows<T, true><<<grid_a, THREADS, 0, st>>>(
        static_cast<const T*>(dense), static_cast<const float*>(x),
        static_cast<float*>(rowpart), static_cast<float*>(colpart), NT, R, W,
        cchunk, shift0, ncols, slices);
  else
    band_sym_rows<T, false><<<grid_a, THREADS, 0, st>>>(
        static_cast<const T*>(dense), static_cast<const float*>(x),
        static_cast<float*>(rowpart), static_cast<float*>(colpart), NT, R, W,
        cchunk, shift0, ncols, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((unsigned)(((long long)ncols + THREADS - 1) / THREADS));
  band_sym_cols<<<grid_b, THREADS, 0, st>>>(
      static_cast<const float*>(rowpart), static_cast<const float*>(colpart),
      static_cast<const float*>(dvec), static_cast<const float*>(x),
      static_cast<float*>(y), NT, R, W, cchunk, shift0, ncols, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int band_sym_f32(const void* dense, const void* dvec,
                            const void* x, void* y, void* rowpart,
                            void* colpart, int NT, int R, int W, int cchunk,
                            int shift0, int ncols, void* stream) {
  return launch<float>(dense, dvec, x, y, rowpart, colpart, NT, R, W, cchunk,
                       shift0, ncols, stream);
}

extern "C" int band_sym_bf16(const void* dense, const void* dvec,
                             const void* x, void* y, void* rowpart,
                             void* colpart, int NT, int R, int W, int cchunk,
                             int shift0, int ncols, void* stream) {
  return launch<__nv_bfloat16>(dense, dvec, x, y, rowpart, colpart, NT, R, W,
                               cchunk, shift0, ncols, stream);
}
