// Banded-dense matvec of the band engine (K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel xfemm_tpu/ops/pallas_band.py::_band_mv_call
// (pallas grid over row tiles, reached through band_matvec_pallas).
//
//   y[t*R + r, c] = sum_w dense[t, r, w] * x[(t + shift0) * cchunk + w, c]
//
// for every row tile t of a (NT, R, W) band and each of the C = 1 or 2
// columns of x ((ncols,) or (ncols, C), row-major; y likewise), with x
// read as zero outside [0, ncols). The TPU kernel materializes the
// overlapping (NT, 1, W) windows in a prologue; here each block stages
// its tile's window straight from x into shared memory, so no padded
// copy of x and no window tensor exist.
//
// Bound: bytes. One launch streams the whole band once, whatever C is
// (2.17 GB in f32 at the 250k main-path shape (1949, 128, 2176); 1.28 GB
// for each of the ac125k Ar and Ai bands (244, 512, 2560)), and does 2C
// flops per element, far below the card's fp32 rate. Products
// accumulate in fp32 FMA (never TF32); a bf16 band rounds the window to
// bf16 first, as the TPU kernel does, and still accumulates in fp32.
//
// Design (the split and the ring come from kernels._mv_plan):
//  - A persistent grid: two blocks per SM where a ring of 8 stages fits
//    in half an SM, else one (a normal launch; no block waits for
//    another). The work items are row slabs of a tile (stage_rows
//    band rows each, NT * ceil(R / stage_rows) items in (tile, slab)
//    order); block k walks the contiguous range [k*items/blocks,
//    (k+1)*items/blocks). Slabs, not whole tiles, so 244 AC tiles still
//    spread over 132 SMs to within one slab; a contiguous range, so a
//    block changes tile only every R / stage_rows items. This replaces
//    the earlier grid of one block per (tile, 32 rows), 7,796 blocks of
//    short life at the 250k shape (~7.4 waves, a part-filled last one).
//  - A TMA ring (persist.cuh): one producer thread keeps cp.async.bulk
//    copies of whole slabs (contiguous rows: W*4 or W*2 bytes each) in
//    flight into `stages` shared-memory stages of ~8 KB or more, each
//    with a full and an empty mbarrier: 140-210 KB in flight per SM, far
//    above the ~25 KB that 3.35 TB/s times the latency needs per SM. The
//    copies carry an L2 evict-first policy: the band passes through L2
//    once and leaves x cached for the windows.
//  - The window never stalls the stream. At each tile change the eight
//    consumer warps meet at a named barrier, stage tile t's window (C x W
//    values, rounded to the band's type) and meet again, while the
//    producer's copies stay in flight: it never waits for a window, and
//    the ring absorbs the consumers' pause. The earlier design staged
//    the window, then synchronised, then issued its first band load, so
//    every block's stream waited a round trip.
//  - Consumers: item j of a block goes to stage j % stages and warp
//    j % 8 (stages is a multiple of 8, so each stage has one reader).
//    A row is reduced by `lpr` lanes (kernels._mv_plan: 32 for wide
//    rows, fewer for narrow ones, so a warp reduces 32/lpr rows at once
//    and a bf16 prolongator row of 44 slices of 16 bytes does not leave
//    most lanes idle in its last pass, as one warp per row did): each
//    lane takes its 16-byte slices in two chains in a fixed order, then
//    a fixed shuffle tree over the lpr lanes. So y is bitwise the same
//    from run to run and for any grid, and column c of a two-column
//    launch is bitwise equal to a one-column launch on column c: each
//    column's products and sums run in the one-column order, and the
//    band is read once for both. The AC complex apply (ops/band.py
//    _complex_op) uses that to stream each of Ar and Ai once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persist.cuh"

namespace {

constexpr int WARPS = 8;              // consumer warps (kernels._MV_WARPS)
constexpr int THREADS = WARPS * 32;   // consumer threads
constexpr int BLOCK = THREADS + 32;   // + one producer warp
constexpr int MAX_STAGES = 32;        // kernels._MV_MAX_STAGES
constexpr int BAR_BYTES = 1024;       // full[32], empty[32]
constexpr int SMEM_LIMIT = 232448;    // a block's shared memory on Hopper

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<__nv_bfloat16> { using type = uint4; };

// a window value in the band's storage type
template <typename T> __device__ __forceinline__ T to_storage(float v);
template <> __device__ __forceinline__ float to_storage<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of a band row times the matching 16 bytes of the window, in a
// fixed order
__device__ __forceinline__ float dot16(const float4 a, const float* w) {
  const float4 c = *reinterpret_cast<const float4*>(w);
  float s = a.x * c.x;
  s = fmaf(a.y, c.y, s);
  s = fmaf(a.z, c.z, s);
  return fmaf(a.w, c.w, s);
}

__device__ __forceinline__ float dot16(const uint4 a, const __nv_bfloat16* w) {
  const uint4 c = *reinterpret_cast<const uint4*>(w);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&c);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 hk = __bfloat1622float2(h[k]);
    const float2 gk = __bfloat1622float2(g[k]);
    s = k == 0 ? hk.x * gk.x : fmaf(hk.x, gk.x, s);
    s = fmaf(hk.y, gk.y, s);
  }
  return s;
}

// the sum of v over each aligned group of `lpr` lanes (a power of two),
// the same bits on every lane of the group and every call
__device__ __forceinline__ float group_sum(float v, int lpr) {
  if (lpr == 32) return persist::warp_sum(v);
  for (int o = lpr >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Plan {
  int NT, R, W, cchunk, shift0, ncols;
  int stage_rows;  // band rows of one item and one stage
  int stages;      // ring stages, a multiple of WARPS
  int lpr;         // lanes per row
};

// mbarriers, the ring, and the window of C x W values
size_t smem_need(const Plan& p, size_t item, int C) {
  return BAR_BYTES + (size_t)p.stages * p.stage_rows * p.W * item +
         (size_t)C * p.W * item;
}

template <typename T, int C>
__global__ void __launch_bounds__(BLOCK, 2)
band_mv_ring(const T* __restrict__ dense, const float* __restrict__ x,
             float* __restrict__ y, Plan p) {
  using VT = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);  // values per 16-byte slice
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, W = p.W, srows = p.stage_rows;
  const size_t sbytes = (size_t)srows * W * sizeof(T);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  T* win = reinterpret_cast<T*>(ring + p.stages * sbytes);  // [C][W]

  // the block's contiguous range of (tile, slab) items
  const int spt = (R + srows - 1) / srows;
  const long long items = (long long)p.NT * spt;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  if (i0 >= i1) return;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      persist::bar_init(full + i, 1);
      persist::bar_init(empty + i, 1);
    }
    persist::ring_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {
    // Producer: every item's slab into the next stage once its reader
    // has released it; no wait on the window.
    if (lane == 0) {
      persist::RingCursor c;
      bool wrapped = false;
      for (long long i = i0; i < i1; ++i) {
        if (wrapped) persist::ring_wait(empty + c.slot, c.phase ^ 1u);
        const long long t = i / spt;
        const int r0 = (int)(i - t * spt) * srows;
        const unsigned nb =
            (unsigned)((size_t)min(srows, R - r0) * W * sizeof(T));
        persist::ring_expect(full + c.slot, nb);
        persist::ring_copy_once(ring + c.slot * sbytes,
                                dense + ((size_t)t * R + r0) * W, nb,
                                full + c.slot);
        c.advance(p.stages);
        wrapped = wrapped || c.slot == 0;
      }
    }
    return;
  }

  const int lpr = p.lpr, group = 32 / lpr;
  const int sub = lane / lpr, sl = lane % lpr;
  const int nit = (W / V + lpr - 1) / lpr;  // slices of a row per lane
  const long long t0 = i0 / spt, t1 = (i1 - 1) / spt;
  for (long long t = t0; t <= t1; ++t) {
    // every consumer warp is done with tile t-1's window
    if (t > t0) asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
    // tile t's window, rounded to the storage type
    const long long col0 = (t + p.shift0) * (long long)p.cchunk;
    for (int w = tid; w < W; w += THREADS) {
      const long long col = col0 + w;
      const bool in = col >= 0 && col < p.ncols;
#pragma unroll
      for (int c = 0; c < C; ++c)
        win[c * W + w] = to_storage<T>(in ? __ldg(x + col * C + c) : 0.f);
    }
    // every consumer warp has staged tile t
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");

    const long long a = max(i0, t * spt) - i0, b = min(i1, (t + 1) * spt) - i0;
    for (long long j = a + ((warp - a % WARPS) + WARPS) % WARPS; j < b;
         j += WARPS) {
      const int slot = (int)(j % p.stages);
      persist::ring_wait(full + slot, (unsigned)((j / p.stages) & 1));
      const int r0 = (int)(i0 + j - t * spt) * srows;
      const int nr = min(srows, R - r0);
      const T* S = reinterpret_cast<const T*>(ring + slot * sbytes);
      for (int g = 0; g < nr; g += group) {
        const int rr = g + sub;
        float a0[C], a1[C];
#pragma unroll
        for (int c = 0; c < C; ++c) a0[c] = a1[c] = 0.f;
        if (rr < nr) {
          const T* row = S + (size_t)rr * W;
#pragma unroll 2
          for (int it = 0; it < nit; it += 2) {
            const int x0 = (sl + it * lpr) * V, x1 = x0 + lpr * V;
            if (x0 < W) {
              const VT v = *reinterpret_cast<const VT*>(row + x0);
#pragma unroll
              for (int c = 0; c < C; ++c) a0[c] += dot16(v, win + c * W + x0);
            }
            if (x1 < W) {
              const VT v = *reinterpret_cast<const VT*>(row + x1);
#pragma unroll
              for (int c = 0; c < C; ++c) a1[c] += dot16(v, win + c * W + x1);
            }
          }
        }
        float s[C];
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = group_sum(a0[c] + a1[c], lpr);
        if (rr < nr && sl == 0) {
          const size_t o = (size_t)t * R + r0 + rr;
          if (C == 1)
            y[o] = s[0];
          else
            *reinterpret_cast<float2*>(y + o * 2) = make_float2(s[0], s[C - 1]);
        }
      }
      __syncwarp();
      if (lane == 0) persist::ring_arrive(empty + slot);
    }
  }
}

// lift the kernel's dynamic shared memory limit to the card's 227 KB,
// once
template <typename T, int C>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      band_mv_ring<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  return e;
}

template <typename T, int C>
int launch(const void* dense, const void* x, void* y, const Plan& p,
           int blocks, int smem, void* stream) {
  const cudaError_t e = allow_smem<T, C>();
  if (e != cudaSuccess) return (int)e;
  band_mv_ring<T, C><<<blocks, BLOCK, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dense), static_cast<const float*>(x),
      static_cast<float*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T>
int band_mv(const void* dense, const void* x, void* y, int NT, int R, int W,
            int cchunk, int shift0, int ncols, int C, int stage_rows,
            int stages, int lpr, int blocks, int smem, void* stream) {
  if (NT <= 0 || R <= 0 || W <= 0) return 0;
  const Plan p{NT, R, W, cchunk, shift0, ncols, stage_rows, stages, lpr};
  const long long items =
      stage_rows > 0 ? (long long)NT * ((R + stage_rows - 1) / stage_rows)
                     : 0;
  if ((C != 1 && C != 2) || ((size_t)W * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dense) % 16 != 0 || stage_rows <= 0 ||
      stage_rows > R || stages < WARPS || stages > MAX_STAGES ||
      stages % WARPS != 0 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) ||
      blocks <= 0 || blocks > items ||
      smem > SMEM_LIMIT || (size_t)smem < smem_need(p, sizeof(T), C))
    return (int)cudaErrorInvalidValue;
  return C == 1 ? launch<T, 1>(dense, x, y, p, blocks, smem, stream)
                : launch<T, 2>(dense, x, y, p, blocks, smem, stream);
}

// blocks resident per SM at `smem` bytes, or minus a CUDA error
template <typename T>
int occupancy(int C, int smem) {
  const auto kern = C == 1 ? band_mv_ring<T, 1> : band_mv_ring<T, 2>;
  cudaError_t e = C == 1 ? allow_smem<T, 1>() : allow_smem<T, 2>();
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCK,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm;
}

}  // namespace

extern "C" int band_mv_f32(const void* dense, const void* x, void* y, int NT,
                           int R, int W, int cchunk, int shift0, int ncols,
                           int C, int stage_rows, int stages, int lpr,
                           int blocks, int smem, void* stream) {
  return band_mv<float>(dense, x, y, NT, R, W, cchunk, shift0, ncols, C,
                        stage_rows, stages, lpr, blocks, smem, stream);
}

extern "C" int band_mv_bf16(const void* dense, const void* x, void* y, int NT,
                            int R, int W, int cchunk, int shift0, int ncols,
                            int C, int stage_rows, int stages, int lpr,
                            int blocks, int smem, void* stream) {
  return band_mv<__nv_bfloat16>(dense, x, y, NT, R, W, cchunk, shift0, ncols,
                                C, stage_rows, stages, lpr, blocks, smem,
                                stream);
}

extern "C" int band_mv_occupancy_f32(int C, int smem) {
  return occupancy<float>(C, smem);
}

extern "C" int band_mv_occupancy_bf16(int C, int smem) {
  return occupancy<__nv_bfloat16>(C, smem);
}
