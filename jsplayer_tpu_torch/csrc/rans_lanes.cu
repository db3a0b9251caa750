// Interleaved multi-lane rANS decode: the lane container's entropy stage,
// for B streams in one launch.
//
// Replaces jsplayer_tpu/kernels/rans_lanes.py: decode_lanes_aligned (an XLA
// lax.scan over steps whose symbol search is a 16-bucket compare and a
// one-hot [N,16] x [16,16] MXU product) and decode_lanes (the same scan
// with two per-lane take_along_axis byte gathers a step).  Per lane j of
// stream b, with the state x (u32), the 12-bit static table freq and its
// exclusive prefix sums cum, each step:
//
//   slot = x & 4095; s = the last symbol with cum[s] <= slot (the output)
//   x = freq[s] * (x >> 12) + slot - cum[s]           (mod 2^32)
//   twice: if x < 2^23, x = (x << 8) | the next refill byte
//
// aligned: step t's two refill bytes are refills[t, j, 0..1] (pre-laid by
// the host, layout_refills); packed: lane j's bytes at its own cursor,
// lane_bytes[j, pos++], 255 past its last byte (0 where L == 0: the
// reference's gathers read so).
//
// The table.  The kernels assume a table the container admits: every entry
// > 0, the sum exactly 4096 (lane_format rejects any other).  Then the
// slot determines everything a step needs, so each block builds a 4096-slot
// table in shared memory (16 KB), one 32-bit word a slot:
//   s | (freq[s] - 1) << 8 | (slot - cum[s]) << 20,
// 8 + 12 + 12 bits; the state update is one shared load and one multiply-
// add, x = (f) * (x >> 12) + (slot - cum[s]).  A block's warp 0 scans the
// 256 frequencies (8 a lane, shuffles), then every thread fills 32 slots by
// a binary search over cum.  The reference's two-level one-hot product
// exists for the TPU's MXU and is not copied.
//
// What bounds it.  Bytes, in principle: aligned, 3 bytes a lane-step (two
// refill bytes read, one symbol written) plus the states and tables; for B=4
// x 4096 lanes x 1,182 steps that is 58 MB, 0.0173 ms at 3.35 TB/s.  But
// each lane's steps are one dependent chain (shared load -> multiply-add ->
// compare -> shift-or), and at 4096 lanes a stream there are 16,384 threads
// on 132 SMs: 4 warps an SM, too few to hide the chain's latency.  So the
// kernel is latency-bound, and it reports Msym/s beside the bytes bound.
// The design does what it can for the chain: one thread a lane with x in a
// register; the refill loads, which do not depend on x, are issued 8 steps
// ahead (kAhead) as 16-bit loads, coalesced across the warp (64 contiguous
// bytes a step), evict-first; the symbol stores are 32 contiguous bytes a
// warp a step.  128-thread blocks spread the lanes over the SMs (B=4 x
// 4096 lanes = 128 blocks).  The packed kernel reads its lane's bytes at a
// divergent cursor (uncoalesced, as the reference's gathers): it is the
// minimal-transfer variant and has no ingest route.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 4096;
constexpr int kAhead = 8;  // refill loads issued ahead of the chain
constexpr uint32_t kRansL = 1u << 23;

// Build the slot table of one stream's frequency table (int32 [256]).
__device__ void build_table(const int32_t* __restrict__ freq,
                            uint32_t* __restrict__ table,
                            int32_t* __restrict__ cum) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    int32_t f[8], run = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      f[k] = __ldg(freq + tid * 8 + k);
      run += f[k];
    }
    int32_t incl = run;  // inclusive scan of the lane sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += v;
    }
    int32_t c = incl - run;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cum[tid * 8 + k] = c;
      c += f[k];
    }
    if (tid == 31) cum[256] = c;
  }
  __syncthreads();
  for (int slot = tid; slot < kSlots; slot += kThreads) {
    int lo = 0, hi = 256;  // the last s in [0, 256) with cum[s] <= slot
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= slot) lo = mid; else hi = mid;
    }
    const uint32_t f = (uint32_t)(cum[lo + 1] - cum[lo]);
    table[slot] = (uint32_t)lo | ((f - 1u) & 0xFFFu) << 8 |
                  ((uint32_t)(slot - cum[lo]) & 0xFFFu) << 20;
  }
  __syncthreads();
}

// The symbol of state x and x's update (before the refills).
__device__ __forceinline__ uint32_t decode_step(const uint32_t* table,
                                                uint32_t& x) {
  const uint32_t e = table[x & (kSlots - 1)];
  x = (((e >> 8) & 0xFFFu) + 1u) * (x >> 12) + (e >> 20);
  return e & 0xFFu;
}

__device__ __forceinline__ void refill(uint32_t& x, uint32_t byte) {
  if (x < kRansL) x = (x << 8) | byte;
}

template <bool kHalfWords>
__global__ void __launch_bounds__(kThreads) rans_aligned_kernel(
    const uint8_t* __restrict__ refills, long long rf_bs,
    const int32_t* __restrict__ states, long long st_bs,
    const int32_t* __restrict__ freq, long long fq_bs,
    uint8_t* __restrict__ syms, long long sy_bs, int N, int steps) {
  __shared__ uint32_t table[kSlots];
  __shared__ int32_t cum[257];
  const int b = blockIdx.y;
  build_table(freq + b * fq_bs, table, cum);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  uint32_t x = (uint32_t)states[b * st_bs + j];
  const uint8_t* rf = refills + b * rf_bs + 2LL * j;
  uint8_t* out = syms + b * sy_bs + j;
  const long long row = 2LL * N;  // refill bytes a step
  auto load = [&](int t) -> uint32_t {
    const uint8_t* p = rf + t * row;
    if (kHalfWords) return __ldcs((const unsigned short*)p);
    return (uint32_t)__ldcs(p) | (uint32_t)__ldcs(p + 1) << 8;
  };
  uint32_t r[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) r[k] = k < steps ? load(k) : 0u;
  int t = 0;
  for (; t + kAhead <= steps; t += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const uint32_t s = decode_step(table, x);
      const uint32_t rk = r[k];
      // the load kAhead steps on, issued before this step's chain
      if (t + kAhead + k < steps) r[k] = load(t + kAhead + k);
      out[(long long)(t + k) * N] = (uint8_t)s;
      refill(x, rk & 0xFFu);
      refill(x, rk >> 8);
    }
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (t + k >= steps) break;
    out[(long long)(t + k) * N] = (uint8_t)decode_step(table, x);
    refill(x, r[k] & 0xFFu);
    refill(x, r[k] >> 8);
  }
}

__global__ void __launch_bounds__(kThreads) rans_packed_kernel(
    const uint8_t* __restrict__ lanes, long long ln_bs, int L,
    const int32_t* __restrict__ states, long long st_bs,
    const int32_t* __restrict__ freq, long long fq_bs,
    uint8_t* __restrict__ syms, long long sy_bs, int N, int steps) {
  __shared__ uint32_t table[kSlots];
  __shared__ int32_t cum[257];
  const int b = blockIdx.y;
  build_table(freq + b * fq_bs, table, cum);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  uint32_t x = (uint32_t)states[b * st_bs + j];
  const uint8_t* lb = lanes + b * ln_bs + (long long)j * L;
  uint8_t* out = syms + b * sy_bs + j;
  const uint32_t past = L ? 0xFFu : 0u;  // a read past the lane's bytes
  int pos = 0;
  for (int t = 0; t < steps; ++t) {
    out[(long long)t * N] = (uint8_t)decode_step(table, x);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (x < kRansL) {
        x = (x << 8) | (pos < L ? (uint32_t)__ldg(lb + pos) : past);
        ++pos;
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

// refills: [B, steps, N, 2] u8, each stream's [steps, N, 2] contiguous, batch
// stride rf_bs bytes; states: [B, N] int32 (u32 bits); freq: [B, 256] int32;
// syms: [B, steps, N] u8 out, each stream's [steps, N] contiguous.  Batch
// strides in elements.  Returns cudaGetLastError() after the launch.
extern "C" int jsp_rans_decode_aligned(
    const void* refills, long long rf_bs, const void* states, long long st_bs,
    const void* freq, long long fq_bs, void* syms, long long sy_bs, int B,
    int N, int steps, void* stream) {
  if (B <= 0 || N <= 0 || steps <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  // 16-bit refill loads where every lane's pair starts on an even address
  auto kernel = aligned(refills, 2) && rf_bs % 2 == 0
                    ? rans_aligned_kernel<true>
                    : rans_aligned_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)refills, rf_bs, (const int32_t*)states, st_bs,
      (const int32_t*)freq, fq_bs, (uint8_t*)syms, sy_bs, N, steps);
  return (int)cudaGetLastError();
}

// lanes: [B, N, L] u8, each stream's [N, L] contiguous; the rest as above.
extern "C" int jsp_rans_decode_packed(
    const void* lanes, long long ln_bs, int L, const void* states,
    long long st_bs, const void* freq, long long fq_bs, void* syms,
    long long sy_bs, int B, int N, int steps, void* stream) {
  if (B <= 0 || N <= 0 || steps <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  rans_packed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)lanes, ln_bs, L, (const int32_t*)states, st_bs,
      (const int32_t*)freq, fq_bs, (uint8_t*)syms, sy_bs, N, steps);
  return (int)cudaGetLastError();
}
