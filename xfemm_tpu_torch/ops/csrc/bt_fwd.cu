// The forward sweep of the block-Thomas apply as ONE persistent kernel
// for Hopper (sm_90a). It replaces fwd_kernel of
// xfemm_tpu/ops/blocktri.py::_bt_apply_pallas and computes what it
// computes (the scan of blocktri.py:523-529):
//
//   y_0 = r_0,  y_t = r_t - G_{t-1} y^_{t-1}              (t = 1 ... NB-1)
//
// ^ is rounding to the factor's storage type, as the TPU kernel rounds its
// carry; y itself stays fp32 and unrounded, and every product accumulates
// in fp32 FMA (never TF32). G is (NB-1, b, b), f32 or bf16; r and y are
// (NB, b) f32; all row-major.
//
// Bound: bytes, plus one exchange between all blocks per step. The kernel
// reads G once, 2 flops per 2 or 4 bytes: 8.0 GB in bf16 at b=896,
// NB=4987 (2.40 ms at 3.35 TB/s). But y_t needs all of y_{t-1}, so the
// NB-1 steps form a chain, and one step's bytes (1.6 MB there) take half
// a microsecond: the hand-over of y from step to step sets the time.
//
// Design (the split and ring plan comes from kernels._fwd_plan):
//  - One cooperative launch, at most one block per SM, every block
//    resident. Block k owns the contiguous rows R_k of every G_t (the
//    row split of bt_qbwd.cu).
//  - A producer warp streams the block's rows of G_{t-1} through a ring
//    of shared-memory stages, one TMA bulk copy per chunk, as many steps
//    ahead as fit in 227 KB (persist.cuh). b=2048 in f32 streams a
//    block's rows in chunks.
//  - Eight warps compute y_t[R_k], one warp per row: each lane sums its
//    16-byte slices of the row in two chains in a fixed order, then a
//    fixed shuffle tree, so two calls give the same bits (no atomics).
//    Each warp writes its row of y_t and publishes it at once, rounded to
//    the storage type, as a flagged word (value + step tag, persist.cuh)
//    at that row of every copy of the exchange scratch.
//  - The exchange is an all-gather: the same eight warps then poll all b
//    words of step t in copy k % copies, coalesced, with relaxed
//    gpu-scope loads (never the non-coherent path: the words are written
//    during the launch), copy them into shared memory (two buffers by
//    step parity), and meet at one named barrier: y^_t is complete. All
//    blocks polling the same b words crowd their few L2 lines; with
//    kernels._FWD_COPIES = 4 copies a quarter of the blocks polls each,
//    for four stores per row.
//  - r is read with ordinary loads (a block's rows of r_t are not
//    16-byte sized for a bulk copy), one step ahead, while the poll runs.
//  - Measured on the H100 (PERF.md): the exchange, from a block's
//    publish to the whole y^_t in its shared memory, takes most of a
//    step; the stream of G hides behind it.
//    y_0 = r_0 is never exchanged: every block rounds r_0 itself.
//  - Two slots (of `copies` x b words) suffice. y_t goes to slot t & 1
//    with tag t. A block writes y_t only after it has read all of
//    y_{t-1}; every block published its rows of y_{t-1} only after it had
//    read all of y_{t-2}, the slot's previous content (the slot of y_1
//    held nothing). So when a slot is overwritten no block still polls
//    it, and tags never repeat (the scratch is zeroed before the launch;
//    tags start at 1).
//
// An optional trace records clock64 at five points of every step in the
// first and the last block (kernels.bt_fwd's `trace`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persist.cuh"

namespace {

using persist::round_to;
using persist::warp_sum;

constexpr int WARPS = 8;              // compute warps
constexpr int THREADS = WARPS * 32;   // compute threads (kernels._PK_THREADS)
constexpr int BLOCK = THREADS + 32;   // + one producer warp
constexpr int MAXR = 2;  // rows a warp owns: rows <= WARPS * MAXR
constexpr int MAXW = 8;  // words a thread polls: b <= THREADS * MAXW
constexpr int MAX_BLOCKS = 160;
constexpr int MAX_STAGES = 32;
constexpr int BAR_BYTES = 1024;       // full[32], empty[32]
constexpr int NPTS = 5;               // trace points per step

// r (a true input, so the non-coherent path), issued where it stands in
// the program: a prefetch the compiler may not sink to its use
__device__ __forceinline__ float ld_r(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// dot product of 16 bytes of a shared-memory row with y^ in shared memory
// (already rounded to the row's storage type)
__device__ __forceinline__ float dot16(const float* p, const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(v);
  float s = a.x * c.x;
  s = fmaf(a.y, c.y, s);
  s = fmaf(a.z, c.z, s);
  return fmaf(a.w, c.w, s);
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* p,
                                      const float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const float4 c0 = *reinterpret_cast<const float4*>(v);
  const float4 c1 = *reinterpret_cast<const float4*>(v + 4);
  const float2 g0 = __bfloat1622float2(h[0]), g1 = __bfloat1622float2(h[1]);
  const float2 g2 = __bfloat1622float2(h[2]), g3 = __bfloat1622float2(h[3]);
  float s = g0.x * c0.x;
  s = fmaf(g0.y, c0.y, s);
  s = fmaf(g1.x, c0.z, s);
  s = fmaf(g1.y, c0.w, s);
  s = fmaf(g2.x, c1.x, s);
  s = fmaf(g2.y, c1.y, s);
  s = fmaf(g3.x, c1.z, s);
  return fmaf(g3.y, c1.w, s);
}

struct Plan {
  int NB, b;
  int rows;        // rows of every block but the last
  int stage_rows;  // rows one stage holds
  int chunks;      // chunks per step: chunks * stage_rows >= rows
  int stages;
  int copies;      // copies of the exchange scratch
};

// mbarriers, the ring, and y^ in two buffers
size_t smem_need(const Plan& p, size_t item) {
  return BAR_BYTES + (size_t)p.stages * p.stage_rows * p.b * item +
         2 * (size_t)p.b * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1)
fwd_kernel(const T* __restrict__ G, const float* __restrict__ r,
           float* __restrict__ y, uint2* xch, Plan p,
           unsigned long long* trace) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int NB = p.NB, b = p.b, rows = p.rows, srows = p.stage_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x, k = blockIdx.x;
  const int row0 = k * rows;
  const int myrows = min(rows, b - row0);
  const size_t sbytes = (size_t)srows * b * sizeof(T);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  float* yh = reinterpret_cast<float*>(ring + p.stages * sbytes);

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      persist::bar_init(full + i, 1);
      persist::bar_init(empty + i, WARPS);
    }
    persist::ring_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {
    // Producer: for t = 1 .. NB-1, the block's rows of G_{t-1} in
    // `chunks` chunks, each into the next stage once its readers have
    // released it.
    if (lane == 0) {
      persist::RingCursor c;
      bool wrapped = false;
      for (int t = 1; t < NB; ++t)
        for (int ch = 0; ch < p.chunks; ++ch) {
          if (wrapped) persist::ring_wait(empty + c.slot, c.phase ^ 1u);
          const int r0 = ch * srows;
          const unsigned rb =
              (unsigned)(max(0, min(srows, myrows - r0)) * b * sizeof(T));
          persist::ring_expect(full + c.slot, rb);
          persist::ring_copy(ring + c.slot * sbytes,
                             G + ((size_t)(t - 1) * b + row0 + r0) * b, rb,
                             full + c.slot);
          c.advance(p.stages);
          wrapped = wrapped || c.slot == 0;
        }
    }
    return;
  }

#define MARK(ph)                                                  \
  if (trace != nullptr && tid == 0 && (k == 0 || k == nblk - 1)) \
    trace[((size_t)(k != 0) * NB + t) * NPTS + (ph)] = clock64();

  auto sync_warps = []() {
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
  };

  // step 0: y_0 = r_0, and y^_0 from r_0 in every block
  for (int i = tid; i < myrows; i += THREADS) y[row0 + i] = r[row0 + i];
  for (int j = tid; j < b; j += THREADS) yh[j] = round_to<T>(r[j]);
  // r_t of the warp's rows, loaded a step ahead
  float rt[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int rr = warp + i * WARPS;
    rt[i] = NB > 1 && rr < myrows ? ld_r(r + (size_t)b + row0 + rr) : 0.f;
  }
  sync_warps();

  const int nit = (b / V + 31) / 32;  // 16-byte slices of a row per lane
  persist::RingCursor cur;
  for (int t = 1; t < NB; ++t) {
    MARK(0)
    // 1. y_t[r] = r_t[r] - G_{t-1}[r, :] y^_{t-1}, each row published as
    //    soon as its warp has it
    const float* yv = yh + ((t - 1) & 1) * b;
    uint2* xs = xch + (size_t)(t & 1) * p.copies * b;
    for (int c = 0; c < p.chunks; ++c) {
      persist::ring_wait(full + cur.slot, cur.phase);
      const T* S = reinterpret_cast<const T*>(ring + cur.slot * sbytes);
      if (c == 0) MARK(1)
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int rr = warp + i * WARPS;
        if (rr < myrows && rr >= c * srows && rr < (c + 1) * srows) {
          const T* row = S + (size_t)(rr - c * srows) * b;
          // every lane takes nit slices (the last ones masked), in two
          // independent chains: no divergent remainder loop
          float a0 = 0.f, a1 = 0.f;
#pragma unroll 2
          for (int it = 0; it < nit; it += 2) {
            const int x0 = (lane + it * 32) * V, x1 = x0 + 32 * V;
            if (x0 < b) a0 += dot16(row + x0, yv + x0);
            if (x1 < b) a1 += dot16(row + x1, yv + x1);
          }
          const float a = warp_sum(a0 + a1);
          const float v = rt[i] - a;
          if (lane == 0) y[(size_t)t * b + row0 + rr] = v;
          if (lane < p.copies)
            persist::flag_store(xs + (size_t)lane * b + row0 + rr,
                                round_to<T>(v), (unsigned)t);
        }
      }
      __syncwarp();
      if (lane == 0) persist::ring_arrive(empty + cur.slot);
      cur.advance(p.stages);
    }
    MARK(2)
    if (t == NB - 1) break;

    // 2. r_{t+1} of the warp's rows, in flight while the poll runs
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int rr = warp + i * WARPS;
      if (rr < myrows) rt[i] = ld_r(r + (size_t)(t + 1) * b + row0 + rr);
    }
    // 3. poll all b words of y^_t (tag t), coalesced, into shared memory
    float* yn = yh + (t & 1) * b;
    xs += (size_t)(k % p.copies) * b;
    {
      uint2 v[MAXW];
      unsigned pending = 0;
#pragma unroll
      for (int c = 0; c < MAXW; ++c)
        if (tid + c * THREADS < b) pending |= 1u << c;
      unsigned long long t0 = 0;
      unsigned spins = 0;
      while (pending) {
#pragma unroll
        for (int c = 0; c < MAXW; ++c)
          if (pending >> c & 1u)
            v[c] = persist::flag_load(xs + tid + c * THREADS);
#pragma unroll
        for (int c = 0; c < MAXW; ++c)
          if ((pending >> c & 1u) && v[c].y == (unsigned)t) {
            yn[tid + c * THREADS] = __uint_as_float(v[c].x);
            pending &= ~(1u << c);
          }
        if (pending && (++spins & 255u) == 0) {
          if (t0 == 0)
            t0 = persist::now_ns();
          else if (persist::now_ns() - t0 > persist::WAIT_LIMIT_NS)
            __trap();
        }
      }
    }
    MARK(3)
    sync_warps();  // y^_t complete; every warp is done with y^_{t-1}
    MARK(4)
  }
#undef MARK
}

// blocks resident per SM at `smem` bytes, or minus a CUDA error; the
// last query is kept (one plan per factor, so it repeats)
template <typename T>
int occupancy(int smem) {
  static int last_smem = -1, last = 0;
  if (smem == last_smem) return last;
  const auto kern = fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCK,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  last_smem = smem;
  last = per_sm;
  return per_sm;
}

template <typename T>
int fwd(const void* Gv, const void* rv, void* yv, void* work, int NB, int b,
        int rows, int stage_rows, int chunks, int stages, int copies,
        int blocks, int smem, void* trace, void* stream) {
  if (NB <= 0) return 0;
  const Plan p{NB, b, rows, stage_rows, chunks, stages, copies};
  if (b <= 0 || b > THREADS * MAXW || b % 8 != 0 || rows <= 0 ||
      rows > WARPS * MAXR || stage_rows <= 0 || chunks * stage_rows < rows ||
      stages < 2 || stages > MAX_STAGES || copies < 1 || copies > 32 ||
      blocks <= 0 ||
      blocks > MAX_BLOCKS || blocks * rows < b || (blocks - 1) * rows >= b ||
      (size_t)smem < smem_need(p, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int per_sm = occupancy<T>(smem);
  if (per_sm < 0) return -per_sm;
  if ((long long)per_sm * nsm < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  const T* G = static_cast<const T*>(Gv);
  const float* r = static_cast<const float*>(rv);
  float* y = static_cast<float*>(yv);
  uint2* xch = static_cast<uint2*>(work);
  unsigned long long* tr = static_cast<unsigned long long*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tags start at 1: zero the two slots of flagged words, every copy
  e = cudaMemsetAsync(xch, 0, 2 * (size_t)copies * b * sizeof(uint2), s);
  if (e != cudaSuccess) return (int)e;
  Plan pa = p;
  void* args[] = {(void*)&G,  (void*)&r,  (void*)&y,
                  (void*)&xch, (void*)&pa, (void*)&tr};
  e = cudaLaunchCooperativeKernel((const void*)fwd_kernel<T>, dim3(blocks),
                                  dim3(BLOCK), args, (size_t)smem, s);
  return (int)e;
}

}  // namespace

extern "C" {

int bt_fwd_f32(const void* G, const void* r, void* y, void* work, int NB,
               int b, int rows, int stage_rows, int chunks, int stages,
               int copies, int blocks, int smem, void* trace, void* stream) {
  return fwd<float>(G, r, y, work, NB, b, rows, stage_rows, chunks, stages,
                    copies, blocks, smem, trace, stream);
}
int bt_fwd_bf16(const void* G, const void* r, void* y, void* work, int NB,
                int b, int rows, int stage_rows, int chunks, int stages,
                int copies, int blocks, int smem, void* trace, void* stream) {
  return fwd<__nv_bfloat16>(G, r, y, work, NB, b, rows, stage_rows, chunks,
                            stages, copies, blocks, smem, trace, stream);
}
// blocks of the kernel resident on one SM at `smem` bytes of dynamic
// shared memory, or minus a CUDA error code
int bt_fwd_occupancy_f32(int smem) { return occupancy<float>(smem); }
int bt_fwd_occupancy_bf16(int smem) {
  return occupancy<__nv_bfloat16>(smem);
}

}  // extern "C"
