// Banded-dense matvec of the band engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel xfemm_tpu/ops/pallas_band.py::_band_mv_call
// (pallas grid over row tiles, reached through band_matvec_pallas).
//
//   y[t*R + r] = sum_w dense[t, r, w] * x[(t + shift0) * cchunk + w]
//
// for every row tile t of a (NT, R, W) band, with x read as zero outside
// [0, ncols). The TPU kernel materializes the overlapping (NT, 1, W)
// windows in a prologue; here each block stages its tile's window
// straight from x into shared memory (in slices of TILE_W values), so no
// padded copy of x and no window tensor exist.
//
// Bound: bytes. One apply streams the whole band once (2.17 GB in f32 at
// the 250k main-path shape (1949, 128, 2176)) and does 2 flops per
// element, far below the card's fp32 rate. The design keeps the stream
// coalesced: one warp per band row, 16-byte vector loads along W, four
// rows per warp in flight for memory-level parallelism. Products
// accumulate in fp32 FMA (never TF32); a bf16 band rounds the window to
// bf16 first, as the TPU kernel does, and still accumulates in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // warps per block
constexpr int ROWS_PER_WARP = 4;  // band rows each warp reduces
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int TILE_W = 4096;      // window values staged per pass (16 KB)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round a window value to the band's storage type (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// one 16-byte vector of band values times the matching window values
template <typename T>
__device__ __forceinline__ float dot16(const T* p, const float* xw);

template <>
__device__ __forceinline__ float dot16<float>(const float* p, const float* xw) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return v.x * xw[0] + v.y * xw[1] + v.z * xw[2] + v.w * xw[3];
}

template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      const float* xw) {
  uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = fmaf(__bfloat162float(h[k]), xw[k], s);
  return s;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
band_mv_kernel(const T* __restrict__ dense, const float* __restrict__ x,
               float* __restrict__ y, int R, int W, int cchunk, int shift0,
               int ncols, int slices) {
  constexpr int V = 16 / sizeof(T);  // values per vector load
  __shared__ float xs[TILE_W];
  const int t = blockIdx.x / slices;
  const int row0 = (blockIdx.x % slices) * ROWS_PER_BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long col0 = (long long)(t + shift0) * cchunk;

  const T* rows[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = row0 + warp * ROWS_PER_WARP + k;
    live[k] = r < R;
    rows[k] = dense + ((size_t)t * R + (live[k] ? r : 0)) * (size_t)W;
  }
  float acc[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) acc[k] = 0.f;

  for (int w0 = 0; w0 < W; w0 += TILE_W) {
    const int tw = min(TILE_W, W - w0);
    for (int i = threadIdx.x; i < tw; i += blockDim.x) {
      const long long c = col0 + w0 + i;
      xs[i] = (c >= 0 && c < ncols) ? round_to<T>(x[c]) : 0.f;
    }
    __syncthreads();
    if (VEC) {
      for (int i = lane * V; i < tw; i += 32 * V) {
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k)
          if (live[k]) acc[k] += dot16<T>(rows[k] + w0 + i, xs + i);
      }
    } else {
      for (int i = lane; i < tw; i += 32) {
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k)
          if (live[k]) acc[k] = fmaf(to_f(rows[k][w0 + i]), xs[i], acc[k]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && live[k])
      y[(size_t)t * R + row0 + warp * ROWS_PER_WARP + k] = s;
  }
}

template <typename T>
int launch(const void* dense, const void* x, void* y, int NT, int R, int W,
           int cchunk, int shift0, int ncols, void* stream) {
  if (NT <= 0 || R <= 0 || W <= 0) return 0;
  const int slices = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const dim3 grid((unsigned)((long long)NT * slices));
  const dim3 block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (W % V == 0) &&
                   (reinterpret_cast<uintptr_t>(dense) % 16 == 0);
  if (vec)
    band_mv_kernel<T, true><<<grid, block, 0, s>>>(
        static_cast<const T*>(dense), static_cast<const float*>(x),
        static_cast<float*>(y), R, W, cchunk, shift0, ncols, slices);
  else
    band_mv_kernel<T, false><<<grid, block, 0, s>>>(
        static_cast<const T*>(dense), static_cast<const float*>(x),
        static_cast<float*>(y), R, W, cchunk, shift0, ncols, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int band_mv_f32(const void* dense, const void* x, void* y, int NT,
                           int R, int W, int cchunk, int shift0, int ncols,
                           void* stream) {
  return launch<float>(dense, x, y, NT, R, W, cchunk, shift0, ncols, stream);
}

extern "C" int band_mv_bf16(const void* dense, const void* x, void* y, int NT,
                            int R, int W, int cchunk, int shift0, int ncols,
                            void* stream) {
  return launch<__nv_bfloat16>(dense, x, y, NT, R, W, cchunk, shift0, ncols,
                               stream);
}
