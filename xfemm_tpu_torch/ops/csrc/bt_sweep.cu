// Block-Thomas apply of the block-tridiagonal preconditioner, for Hopper
// (sm_90a): the three kernels of xfemm_tpu/ops/blocktri.py::
// _bt_apply_pallas.
//
//   fwd (replaces fwd_kernel):  y_0 = r_0,  y_t = r_t - G_{t-1} y_{t-1}
//   q   (replaces q_kernel):    q_t = Sinv_t y_t            (all t at once)
//   bwd (replaces bwd_kernel):  z_{NB-1} = q_{NB-1},
//                               z_t = q_t - G_t^T z_{t+1}
//
// G is (NB-1, b, b), Sinv is (NB, b, b), vectors are (NB, b), row-major.
//
// Bound: bytes. Each sweep streams its factor half once (1.02 GB of G or
// Sinv in f32 at b=1024, NB=244) with 2 flops per element. The sweeps
// are a chain of NB-1 dependent b x b matvecs; the TPU walks it as a
// sequential grid with the carry in VMEM. On Hopper one block cannot
// stream 4 MB per step fast enough, so each step is its own grid that
// spreads the b x b block over b/8 blocks (128 at b=1024), and the host
// side of this file enqueues the NB-1 step launches back to back on the
// caller's stream; stream order carries the dependency. That costs one
// launch per step (2*(NB-1) + 1 per apply). A persistent kernel with a
// grid-wide barrier would remove them.
//
// fwd and q contract along G's and Sinv's rows (one warp per row,
// 16-byte loads along the row). bwd contracts over G's rows (G^T z):
// each block owns 8 adjacent columns and 32 row groups, so a warp reads
// four 32-byte row segments per step (whole sectors), and the 32 partial
// sums of a column are reduced in shared memory in a fixed order --
// deterministic, no atomics. The carried vector is staged in shared
// memory, rounded to the factor's storage type as the TPU kernel rounds
// it; every product accumulates in fp32 FMA (never TF32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 8;           // bwd: columns per block
constexpr int GROUPS = WARPS * 4; // bwd: row groups per block

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

// z[j] = q[j] - sum_i G[i, j] * zn[i] for the columns j of this block
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
coldot_kernel(const T* __restrict__ G, const float* __restrict__ zn,
              const float* __restrict__ q, float* __restrict__ z, int b) {
  extern __shared__ float smem[];
  float* zs = smem;             // b values of z_{t+1}
  float* part = smem + b;       // GROUPS x COLS partial sums
  for (int i = threadIdx.x; i < b; i += blockDim.x) zs[i] = round_to<T>(zn[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int c = lane % COLS;
  const int g = (threadIdx.x >> 5) * 4 + lane / COLS;
  const int col = blockIdx.x * COLS + c;
  float acc = 0.f;
  if (col < b) {
#pragma unroll 8
    for (int i = g; i < b; i += GROUPS)
      acc = fmaf(to_f(G[(size_t)i * b + col]), zs[i], acc);
  }
  part[g * COLS + c] = acc;
  __syncthreads();
  if (threadIdx.x < COLS) {
    const int j = blockIdx.x * COLS + threadIdx.x;
    float s = 0.f;
    for (int k = 0; k < GROUPS; ++k) s += part[k * COLS + threadIdx.x];
    if (j < b) z[j] = q[j] - s;
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

template <typename T>
int qmul(const void* Sv, const void* yv, void* qv, int NB, int b,
         void* stream) {
  if (NB <= 0 || b <= 0) return 0;
  return (int)rowdot<T>(static_cast<const T*>(Sv),
                        static_cast<const float*>(yv), nullptr,
                        static_cast<float*>(qv), b, NB, 1.f,
                        static_cast<cudaStream_t>(stream));
}

template <typename T>
int bwd(const void* Gv, const void* qv, void* zv, int NB, int b,
        void* stream) {
  if (NB <= 0 || b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* G = static_cast<const T*>(Gv);
  const float* q = static_cast<const float*>(qv);
  float* z = static_cast<float*>(zv);
  cudaError_t e = cudaMemcpyAsync(z + (size_t)(NB - 1) * b,
                                  q + (size_t)(NB - 1) * b,
                                  (size_t)b * sizeof(float),
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((b + COLS - 1) / COLS));
  const size_t shm = ((size_t)b + GROUPS * COLS) * sizeof(float);
  for (int t = NB - 2; t >= 0; --t) {
    coldot_kernel<T><<<grid, WARPS * 32, shm, s>>>(
        G + (size_t)t * b * b, z + (size_t)(t + 1) * b, q + (size_t)t * b,
        z + (size_t)t * b, b);
    e = cudaGetLastError();
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
int bt_q_f32(const void* S, const void* y, void* q, int NB, int b,
             void* stream) {
  return qmul<float>(S, y, q, NB, b, stream);
}
int bt_q_bf16(const void* S, const void* y, void* q, int NB, int b,
              void* stream) {
  return qmul<__nv_bfloat16>(S, y, q, NB, b, stream);
}
int bt_bwd_f32(const void* G, const void* q, void* z, int NB, int b,
               void* stream) {
  return bwd<float>(G, q, z, NB, b, stream);
}
int bt_bwd_bf16(const void* G, const void* q, void* z, int NB, int b,
                void* stream) {
  return bwd<__nv_bfloat16>(G, q, z, NB, b, stream);
}

}  // extern "C"
