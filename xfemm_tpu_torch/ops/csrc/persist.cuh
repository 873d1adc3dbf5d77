// Building blocks of the persistent kernels of the block-Thomas apply
// (bt_fwd.cu, the forward sweep; bt_qbwd.cu, the Sinv products and the
// backward sweep), for Hopper (sm_90a):
//
//  - the grid-wide exchange: flagged words, a 4-byte value and a 4-byte
//    tag stored together as one 8-byte word. A block waits for another's
//    value by polling the word until the tag is the one it expects (the
//    step), so each exchange costs one store and its polls, with no
//    fence and no shared counter. The scratch is zeroed before the
//    launch (tags start at 1), and the spin needs every block of the
//    grid resident: launch it cooperatively.
//  - a ring of shared-memory stages filled by TMA bulk copies
//    (cp.async.bulk) from a producer thread: a `full` mbarrier per stage
//    completes when its bytes have landed, an `empty` one when its
//    readers have released it; both sides walk the ring with a cursor
//    that carries the stage and its phase parity.
//
//  - two small helpers of the sweeps: rounding to the factor's storage
//    type, and a warp's sum in a fixed shuffle order.
//
// A wait that has not finished after WAIT_LIMIT_NS traps, so that a
// fault shows as a failed launch and not as a hung card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace persist {

constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------------
// flagged words: a 4-byte value and a 4-byte tag stored as ONE 8-byte
// word, which is single-copy atomic, so a reader that sees the tag it
// waits for sees the value written with it: no fence, no counter.
// ---------------------------------------------------------------------

__device__ __forceinline__ void flag_store(uint2* p, float v, unsigned tag) {
  const unsigned long long w =
      (unsigned long long)tag << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

// .x the value, .y the tag
__device__ __forceinline__ uint2 flag_load(const uint2* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return make_uint2((unsigned)w, (unsigned)(w >> 32));
}

// ---------------------------------------------------------------------
// shared-memory ring: mbarriers + TMA bulk copies
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises an mbarrier that completes a phase after
// `count` arrivals (and the bytes announced to it); then, before any other
// thread uses the barriers, ring_init_fence and a block-wide sync.
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void ring_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One reader's arrival on a barrier.
__device__ __forceinline__ void ring_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One thread: announce that `bytes` will land on the stage's barrier and
// arrive on it (zero bytes complete the phase at once).
__device__ __forceinline__ void ring_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void ring_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool ring_try(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A position in the ring: the stage and the parity of its current fill.
struct RingCursor {
  int slot = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  const uint32_t b = smem_addr(bar);
  if (ring_try(b, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!ring_try(b, parity))
    if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// ---------------------------------------------------------------------
// helpers of the sweeps
// ---------------------------------------------------------------------

// v rounded to the storage type T of the factor, as a float
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the sum of a over the warp, the same bits on every lane and every call
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

}  // namespace persist
