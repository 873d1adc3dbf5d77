// Forward block-Thomas sweep of the block-tridiagonal preconditioner,
// for Hopper (sm_90a): replaces fwd_kernel of xfemm_tpu/ops/blocktri.py::
// _bt_apply_pallas,
//
//   y_0 = r_0,  y_t = r_t - G_{t-1} y_{t-1}
//
// G is (NB-1, b, b), vectors are (NB, b), row-major. The other half of the
// apply, the Sinv products and the backward sweep (q_kernel and
// bwd_kernel), is one persistent kernel: bt_qbwd.cu.
//
// Bound: bytes. The sweep streams G once (1.02 GB in f32 at b=1024,
// NB=244) with 2 flops per element. It is a chain of NB-1 dependent
// b x b matvecs; the TPU walks it as a sequential grid with the carry in
// VMEM. Here each step is its own grid that spreads the b x b block over
// b/8 blocks (128 at b=1024), and the host side of this file enqueues the
// NB-1 step launches back to back on the caller's stream; stream order
// carries the dependency. That costs one launch per step.
//
// One warp per row of G_t, 16-byte loads along the row. The carried
// vector is staged in shared memory, rounded to the factor's storage type
// as the TPU kernel rounds it; every product accumulates in fp32 FMA
// (never TF32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

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

template <typename T>
__device__ __forceinline__ float dot16(const T* p, const float* v);

template <>
__device__ __forceinline__ float dot16<float>(const float* p, const float* v) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return a.x * v[0] + a.y * v[1] + a.z * v[2] + a.w * v[3];
}

template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      const float* v) {
  uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = fmaf(__bfloat162float(h[k]), v[k], s);
  return s;
}

// out[row] = base[row] + sign * (M[row, :] . vec) for one b x b block M;
// one warp per row, blockIdx.x = batch * blocks_per_mat + row block.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rowdot_kernel(const T* __restrict__ M, const float* __restrict__ vec,
              const float* __restrict__ base, float* __restrict__ out, int b,
              int blocks_per_mat, float sign) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float vs[];
  const int batch = blockIdx.x / blocks_per_mat;
  const int row = (blockIdx.x % blocks_per_mat) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const float* v = vec + (size_t)batch * b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) vs[i] = round_to<T>(v[i]);
  __syncthreads();
  if (row >= b) return;
  const T* m = M + ((size_t)batch * b + row) * (size_t)b;
  float acc = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int i = lane * V; i < b; i += 32 * V) acc += dot16<T>(m + i, vs + i);
  } else {
    for (int i = lane; i < b; i += 32) acc = fmaf(to_f(m[i]), vs[i], acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const size_t k = (size_t)batch * b + row;
    out[k] = (base ? base[k] : 0.f) + sign * acc;
  }
}

template <typename T>
bool vec_ok(const void* M, int b) {
  return (b % (16 / (int)sizeof(T)) == 0) &&
         (reinterpret_cast<uintptr_t>(M) % 16 == 0);
}

template <typename T>
cudaError_t rowdot(const T* M, const float* vec, const float* base,
                   float* out, int b, int batches, float sign,
                   cudaStream_t s) {
  const int per = (b + WARPS - 1) / WARPS;
  const dim3 grid((unsigned)((long long)batches * per));
  const size_t shm = (size_t)b * sizeof(float);
  if (vec_ok<T>(M, b))
    rowdot_kernel<T, true><<<grid, WARPS * 32, shm, s>>>(M, vec, base, out,
                                                         b, per, sign);
  else
    rowdot_kernel<T, false><<<grid, WARPS * 32, shm, s>>>(M, vec, base, out,
                                                          b, per, sign);
  return cudaGetLastError();
}

template <typename T>
int fwd(const void* Gv, const void* rv, void* yv, int NB, int b,
        void* stream) {
  if (NB <= 0 || b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* G = static_cast<const T*>(Gv);
  const float* r = static_cast<const float*>(rv);
  float* y = static_cast<float*>(yv);
  cudaError_t e = cudaMemcpyAsync(y, r, (size_t)b * sizeof(float),
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  for (int t = 1; t < NB; ++t) {
    e = rowdot<T>(G + (size_t)(t - 1) * b * b, y + (size_t)(t - 1) * b,
                  r + (size_t)t * b, y + (size_t)t * b, b, 1, -1.f, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

int bt_fwd_f32(const void* G, const void* r, void* y, int NB, int b,
               void* stream) {
  return fwd<float>(G, r, y, NB, b, stream);
}
int bt_fwd_bf16(const void* G, const void* r, void* y, int NB, int b,
                void* stream) {
  return fwd<__nv_bfloat16>(G, r, y, NB, b, stream);
}

}  // extern "C"
