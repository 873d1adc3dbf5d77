// The backward half of the block-Thomas apply as ONE persistent kernel
// for Hopper (sm_90a). It replaces q_kernel and bwd_kernel of
// xfemm_tpu/ops/blocktri.py::_bt_apply_pallas, and computes what the two
// compute in sequence (the reverse scan of blocktri.py:531-539):
//
//   z_{NB-1} = Sinv_{NB-1} y^_{NB-1}
//   z_t      = Sinv_t y^_t - G_t^T z^_{t+1}          (t = NB-2 ... 0)
//
// ^ is rounding to the factor's storage type, as the TPU kernels round
// the carried vector; every product accumulates in fp32 FMA (never TF32).
// Sinv is (NB, b, b), G (NB-1, b, b), f32 or bf16; y and z are (NB, b)
// f32; all row-major.
//
// Bound: bytes, plus one exchange between all blocks per step. The kernel
// reads G, Sinv and y once, 2 flops per 2 or 4 bytes: 16.0 GB in bf16 at
// b=896, NB=4987 (4.78 ms at 3.35 TB/s). But z_t needs all of z_{t+1}, so
// the NB steps form a chain, and one step's bytes (3.2 MB there) take
// under a microsecond: the hand-over of z from step to step sets the time.
//
// Design (the split and ring plan comes from kernels._qbwd_plan):
//  - One cooperative launch, at most one block per SM, every block
//    resident. Block k owns the contiguous rows R_k of every G_t and
//    Sinv_t. Its warps have three roles.
//  - A producer warp streams the block's rows of Sinv_t (with y_t) and of
//    G_{t-1} through a ring of shared-memory stages, one TMA bulk copy per
//    chunk, as many stages ahead as fit in 227 KB (persist.cuh: full and
//    empty mbarriers per stage). A block's rows of one matrix that exceed
//    a stage stream in several chunks.
//  - Eight reader warps compute q_t[R_k] = Sinv_t[R_k,:] y^_t (one warp
//    per row) while step t's partials are in flight; then z_t[R_k]; then,
//    since G_t^T z^_{t+1} contracts over G_t's rows, the block's partial
//    p_k = G_{t-1}[R_k,:]^T z^_t[R_k] over all b columns (threads on
//    adjacent column pairs of a shared-memory row), published as flagged
//    words (value + step tag in one 8-byte word, persist.cuh) to a scratch
//    laid out (3 slots by step, owner block of the column, writer block,
//    row): each owner's partials form one contiguous run.
//  - Two poller warps wait for step t's words of the block's own rows,
//    coalesced, copy them into shared memory and signal the readers (an
//    mbarrier; another one tells them when the readers are done with it).
//    The readers then sum each row's partials in writer order (lanes over
//    writers in order, then a fixed shuffle tree): no float atomics, the
//    same bits on every call. Words written during the launch are read
//    with relaxed gpu-scope loads, never through the non-coherent path.
//  - Measured on the H100 (PERF.md): the exchange, from the writers'
//    stores to the readers' wake-up, takes most of a step; the stream of
//    G and Sinv hides behind it.
//
// An optional trace records clock64 at eight points of every step in the
// first and the last block (kernels.bt_qbwd's `trace`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persist.cuh"

namespace {

constexpr int WARPS = 8;              // reader warps
constexpr int THREADS = WARPS * 32;   // reader threads (kernels._PK_THREADS)
constexpr int POLLERS = 2;            // poller warps
constexpr int PW = 16;                // words a poller lane holds per round
constexpr int BLOCK = THREADS + 32 + POLLERS * 32;  // + one producer warp
constexpr int MAXR = 2;               // rows a warp owns: rows <= WARPS * MAXR
constexpr int MAX_BLOCKS = 160;
constexpr int MAX_STAGES = 32;
constexpr int BAR_BYTES = 1024;       // full[32], empty[32], pready, pfree

using persist::round_to;
using persist::warp_sum;

// dot product of 16 bytes of a shared-memory row with shared floats,
// each rounded to the row's storage type first
template <typename T>
__device__ __forceinline__ float sdot16(const T* p, const float* v);

template <>
__device__ __forceinline__ float sdot16<float>(const float* p,
                                               const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(v);
  float s = a.x * c.x;
  s = fmaf(a.y, c.y, s);
  s = fmaf(a.z, c.z, s);
  return fmaf(a.w, c.w, s);
}

template <>
__device__ __forceinline__ float sdot16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       const float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
  const float4 c0 = *reinterpret_cast<const float4*>(v);
  const float4 c1 = *reinterpret_cast<const float4*>(v + 4);
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  float s = __bfloat162float(h[0]) * round_to<__nv_bfloat16>(c[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i)
    s = fmaf(__bfloat162float(h[i]), round_to<__nv_bfloat16>(c[i]), s);
  return s;
}

// two adjacent elements of a shared-memory row
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct Plan {
  int NB, b;
  int rows;        // rows of every block but the last
  int stage_rows;  // rows one stage holds
  int chunks;      // chunks per matrix and step: chunks * stage_rows >= rows
  int stages;
};

// a stage: stage_rows rows of one matrix, then (with Sinv_t's first
// chunk) the b floats of y_t
__host__ __device__ inline size_t stage_bytes(const Plan& p, size_t item) {
  return (size_t)p.stage_rows * p.b * item + (size_t)p.b * sizeof(float);
}

size_t smem_need(const Plan& p, int blocks, size_t item) {
  return BAR_BYTES + (size_t)p.stages * stage_bytes(p, item) +
         (2 * (size_t)p.rows + (size_t)blocks * p.rows) * sizeof(float);
}

// NC: columns a reader thread owns, b <= THREADS * NC (as NC / 2 pairs
// of adjacent columns, or one column when NC is 1)
template <typename T, int NC>
__global__ void __launch_bounds__(BLOCK, 1)
qbwd_kernel(const T* __restrict__ Sinv, const T* __restrict__ G,
            const float* __restrict__ y, float* __restrict__ z, uint2* part,
            Plan p, unsigned long long* trace) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int NB = p.NB, b = p.b, rows = p.rows, srows = p.stage_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x, k = blockIdx.x;
  const int row0 = k * rows;
  const int myrows = min(rows, b - row0);
  const size_t sbytes = stage_bytes(p, sizeof(T));
  const int npart = nblk * rows;  // partials of one owner block

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* pready = empty + MAX_STAGES;  // a step's partials are in ps
  uint64_t* pfree = pready + 1;           // the readers are done with ps
  unsigned char* ring = smem + BAR_BYTES;
  float* zh = reinterpret_cast<float*>(ring + p.stages * sbytes);
  float* ps = zh + 2 * rows;  // step t's partials of the block's rows

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      persist::bar_init(full + i, 1);
      persist::bar_init(empty + i, WARPS);
    }
    persist::bar_init(pready, 1);
    persist::bar_init(pfree, WARPS);
    persist::ring_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {
    // Producer: for t = NB-1 .. 0, the block's rows of Sinv_t (y_t with
    // the first chunk), then (t > 0) of G_{t-1}, in `chunks` chunks each,
    // each chunk into the next stage once its readers have released it.
    if (lane == 0) {
      persist::RingCursor c;
      bool wrapped = false;
      for (int t = NB - 1; t >= 0; --t)
        for (int m = 0; m < (t > 0 ? 2 : 1); ++m)
          for (int ch = 0; ch < p.chunks; ++ch) {
            if (wrapped) persist::ring_wait(empty + c.slot, c.phase ^ 1u);
            const int r0 = ch * srows;
            const unsigned rb =
                (unsigned)(max(0, min(srows, myrows - r0)) * b * sizeof(T));
            const unsigned yb = m == 0 && ch == 0 ? b * sizeof(float) : 0u;
            unsigned char* dst = ring + c.slot * sbytes;
            persist::ring_expect(full + c.slot, rb + yb);
            persist::ring_copy(dst,
                               m ? G + ((size_t)(t - 1) * b + row0 + r0) * b
                                 : Sinv + ((size_t)t * b + row0 + r0) * b,
                               rb, full + c.slot);
            persist::ring_copy(dst + srows * b * sizeof(T),
                               y + (size_t)t * b, yb, full + c.slot);
            c.advance(p.stages);
            wrapped = wrapped || c.slot == 0;
          }
    }
    return;
  }

  if (warp > WARPS) {
    // Pollers: for each step t < NB-1, wait until the readers are done
    // with ps, then poll the block's partials of step t (slot t % 3, tag
    // t + 1), coalesced, into ps, and signal the readers.
    const int pl = tid - THREADS - 32;
    for (int t = NB - 2; t >= 0; --t) {
      const int u = NB - 2 - t;
      if (u > 0) persist::ring_wait(pfree, (unsigned)(u - 1) & 1u);
      const uint2* P = part + ((size_t)(t % 3) * nblk + k) * npart;
      const unsigned tag = (unsigned)t + 1;
      for (int base = pl; base < npart; base += POLLERS * 32 * PW) {
        uint2 v[PW];
        unsigned pending = 0;
#pragma unroll
        for (int c = 0; c < PW; ++c) {
          const int i = base + c * POLLERS * 32;
          if (i < npart && i % rows < myrows) pending |= 1u << c;
        }
        unsigned long long t0 = 0;
        unsigned spins = 0;
        while (pending) {
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if (pending >> c & 1u)
              v[c] = persist::flag_load(P + base + c * POLLERS * 32);
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if ((pending >> c & 1u) && v[c].y == tag) {
              ps[base + c * POLLERS * 32] = __uint_as_float(v[c].x);
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
      asm volatile("bar.sync 2, %0;" ::"n"(POLLERS * 32) : "memory");
      if (pl == 0) persist::ring_arrive(pready);
    }
    return;
  }

#define MARK(ph)                                                        \
  if (trace != nullptr && tid == 0 && (k == 0 || k == nblk - 1))       \
    trace[((size_t)(k != 0) * NB + (NB - 1 - t)) * 8 + (ph)] = clock64();

  // Readers (8 warps): take the stages in order, release each when read.
  persist::RingCursor cur;
  auto take = [&]() -> const unsigned char* {
    persist::ring_wait(full + cur.slot, cur.phase);
    return ring + cur.slot * sbytes;
  };
  auto give = [&](int slot) {
    __syncwarp();
    if (lane == 0) persist::ring_arrive(empty + slot);
  };
  auto sync_readers = []() {
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
  };

  // this thread's columns: pairs 2*(tid + c*THREADS) + {0, 1}, and where
  // each goes in a writer's slice of the scratch
  constexpr int NPR = (NC + 1) / 2;
  int col[NPR];
  int woff[NPR][2];
#pragma unroll
  for (int c = 0; c < NPR; ++c) {
    col[c] = 2 * (tid + c * THREADS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = col[c] + h;
      const int owner = j / rows;
      woff[c][h] = owner * npart + (j - owner * rows);
    }
  }

  for (int t = NB - 1;; --t) {
    MARK(0)
    // 1. q_r = Sinv_t[r, :] y^_t for the warp's rows (y_t rides with the
    //    first chunk, which is kept until the last one is read)
    float q[MAXR] = {};
    const float* yt = nullptr;
    int first = 0;
    for (int c = 0; c < p.chunks; ++c) {
      const T* S = reinterpret_cast<const T*>(take());
      if (c == 0) {
        yt = reinterpret_cast<const float*>(S + (size_t)srows * b);
        first = cur.slot;
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int r = warp + i * WARPS;
        if (r < myrows && r >= c * srows && r < (c + 1) * srows) {
          const T* row = S + (size_t)(r - c * srows) * b;
          float a = 0.f;
#pragma unroll 4
          for (int x = lane * V; x < b; x += 32 * V)
            a += sdot16<T>(row + x, yt + x);
          q[i] = warp_sum(a);
        }
      }
      if (c > 0) give(cur.slot);
      cur.advance(p.stages);
    }
    give(first);
    MARK(1)
    // 2. z_r = q_r - the partials of row r summed in writer order
    if (t < NB - 1) persist::ring_wait(pready, (unsigned)(NB - 2 - t) & 1u);
    MARK(2)
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int r = warp + i * WARPS;
      if (r >= myrows) continue;
      float s = 0.f;
      if (t < NB - 1) {
        for (int w = lane; w < nblk; w += 32) s += ps[w * rows + r];
        s = warp_sum(s);
      }
      if (lane == 0) {
        const float zr = q[i] - s;
        z[(size_t)t * b + row0 + r] = zr;
        zh[(t & 1) * rows + r] = round_to<T>(zr);
      }
    }
    if (t < NB - 1) {  // ps read: the pollers may refill it
      __syncwarp();
      if (lane == 0) persist::ring_arrive(pfree);
    }
    MARK(3)
    sync_readers();  // z^_t complete
    MARK(4)
    if (t == 0) break;

    // 3. p_k = G_{t-1}[R_k, :]^T z^_t[R_k]; thread on its column pairs
    float2 acc[NPR];
#pragma unroll
    for (int c = 0; c < NPR; ++c) acc[c] = make_float2(0.f, 0.f);
    const float* zt = zh + (t & 1) * rows;
    for (int c = 0; c < p.chunks; ++c) {
      const T* Gs = reinterpret_cast<const T*>(take());
      MARK(5)
      const int r0 = c * srows;
      const int cnt = min(srows, myrows - r0);
#pragma unroll 4
      for (int r = 0; r < cnt; ++r) {
        const float zr = zt[r0 + r];
        const T* row = Gs + (size_t)r * b;
#pragma unroll
        for (int cc = 0; cc < NPR; ++cc)
          if (col[cc] < b) {
            const float2 g = load2(row + col[cc]);
            acc[cc].x = fmaf(g.x, zr, acc[cc].x);
            acc[cc].y = fmaf(g.y, zr, acc[cc].y);
          }
      }
      give(cur.slot);
      cur.advance(p.stages);
    }
    MARK(6)
    // 4. publish the partial, tagged t, in slot (t-1) % 3
    uint2* W = part + (size_t)((t - 1) % 3) * nblk * npart + (size_t)k * rows;
#pragma unroll
    for (int cc = 0; cc < NPR; ++cc)
      if (col[cc] < b) {
        persist::flag_store(W + woff[cc][0], acc[cc].x, (unsigned)t);
        persist::flag_store(W + woff[cc][1], acc[cc].y, (unsigned)t);
      }
    MARK(7)
  }
#undef MARK
}

// blocks resident per SM at `smem` bytes, or minus a CUDA error; the
// last query is kept (one plan per factor, so it repeats)
template <typename T, int NC>
int occupancy(int smem) {
  static int last_smem = -1, last = 0;
  if (smem == last_smem) return last;
  const auto kern = qbwd_kernel<T, NC>;
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
int occupancy_for(int b, int smem) {
  return b <= THREADS     ? occupancy<T, 1>(smem)
         : b <= 2 * THREADS ? occupancy<T, 2>(smem)
         : b <= 4 * THREADS ? occupancy<T, 4>(smem)
                            : occupancy<T, 8>(smem);
}

template <typename T>
int qbwd(const void* Sv, const void* Gv, const void* yv, void* zv,
         void* work, int NB, int b, int rows, int stage_rows, int chunks,
         int stages, int blocks, int smem, void* trace, void* stream) {
  if (NB <= 0) return 0;
  const Plan p{NB, b, rows, stage_rows, chunks, stages};
  if (b <= 0 || b > THREADS * 8 || b % 8 != 0 || rows <= 0 ||
      rows > WARPS * MAXR || stage_rows <= 0 || chunks * stage_rows < rows ||
      stages < chunks || stages > MAX_STAGES || blocks <= 0 ||
      blocks > MAX_BLOCKS || blocks * rows < b || (blocks - 1) * rows >= b ||
      (size_t)smem < smem_need(p, blocks, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int per_sm = occupancy_for<T>(b, smem);
  if (per_sm < 0) return -per_sm;
  if ((long long)per_sm * nsm < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  const T* S = static_cast<const T*>(Sv);
  const T* G = static_cast<const T*>(Gv);
  const float* y = static_cast<const float*>(yv);
  float* z = static_cast<float*>(zv);
  uint2* part = static_cast<uint2*>(work);
  unsigned long long* tr = static_cast<unsigned long long*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tags start at 1: zero the three slots of flagged partials
  e = cudaMemsetAsync(part, 0, 3 * (size_t)blocks * blocks * rows *
                                   sizeof(uint2), s);
  if (e != cudaSuccess) return (int)e;
  Plan pa = p;
  void* args[] = {(void*)&S,    (void*)&G,  (void*)&y, (void*)&z,
                  (void*)&part, (void*)&pa, (void*)&tr};
  const void* kern = b <= THREADS       ? (const void*)qbwd_kernel<T, 1>
                     : b <= 2 * THREADS ? (const void*)qbwd_kernel<T, 2>
                     : b <= 4 * THREADS ? (const void*)qbwd_kernel<T, 4>
                                        : (const void*)qbwd_kernel<T, 8>;
  e = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(BLOCK), args,
                                  (size_t)smem, s);
  return (int)e;
}

}  // namespace

extern "C" {

int bt_qbwd_f32(const void* S, const void* G, const void* y, void* z,
                void* work, int NB, int b, int rows, int stage_rows,
                int chunks, int stages, int blocks, int smem, void* trace,
                void* stream) {
  return qbwd<float>(S, G, y, z, work, NB, b, rows, stage_rows, chunks,
                     stages, blocks, smem, trace, stream);
}
int bt_qbwd_bf16(const void* S, const void* G, const void* y, void* z,
                 void* work, int NB, int b, int rows, int stage_rows,
                 int chunks, int stages, int blocks, int smem, void* trace,
                 void* stream) {
  return qbwd<__nv_bfloat16>(S, G, y, z, work, NB, b, rows, stage_rows,
                             chunks, stages, blocks, smem, trace, stream);
}
// blocks of the kernel for block size b resident on one SM at `smem`
// bytes of dynamic shared memory, or minus a CUDA error code
int bt_qbwd_occupancy_f32(int b, int smem) {
  return occupancy_for<float>(b, smem);
}
int bt_qbwd_occupancy_bf16(int b, int smem) {
  return occupancy_for<__nv_bfloat16>(b, smem);
}

}  // extern "C"
