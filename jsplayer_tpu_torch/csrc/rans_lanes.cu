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
// The tables.  The kernels assume a table the container admits: every
// entry > 0, the sum exactly 4096 (lane_format rejects any other).  Then the
// slot determines everything a step needs, so each block builds two
// 4096-slot tables in shared memory: a 32-bit word a slot, freq[s] | (slot -
// cum[s]) << 13 (13 + 12 bits), the only load on the state's chain, and the
// symbol, a byte a slot, which only goes to the output.  Built by mark and
// scan: warp 0 scans the 256 frequencies, every symbol marks its first slot
// cum[s] (distinct, since every freq > 0), then a running max over the
// slots, 32 a thread from registers and a block scan of the carries (a
// binary search a slot measured ~9 us slower a launch).  The reference's
// two-level one-hot product exists for the TPU's MXU and is not copied.
//
// The chain.  Each lane's steps are one dependent chain, and at 4096 lanes a
// stream there are 16,384 threads on 132 SMs, 4 warps an SM, one a
// scheduler: the kernel is bound by the chain's latency times the steps,
// not by bytes (3 a lane-step).  A step's chain is one shared load, the
// multiply-add x = (e & 0x1FFF) * (x >> 12) + (e >> 13), and one select for
// both refills: for any u32 x, (x << 8 | b0) < 2^23 if and only if x < 2^15,
// so x < 2^15 takes x << 16 | b0 << 8 | b1, else x < 2^23 takes x << 8 | b0,
// else x stays; both candidates are formed beside the compares.  The chain
// probe below runs the least such chain with no global traffic: its time is
// the decodes' bound (on an H100 80GB HBM3 at 700 W, 0.053 ms for B=4 x
// 4096 lanes x 1,182 steps, ~80 cycles a step; experiments/lane_step.py).
// Every other load is off the chain and far ahead of it:
//
// aligned, staged instance (refills 16-byte aligned, N % 8 == 0: the dense
// window, the ingest's windows): a block's 128 lanes take 256 contiguous
// bytes of refills a step; stages of kStage = 32 steps (8 KB) are copied
// into shared memory with 16-byte cp.async, three buffers, stage k + 2
// issued when stage k starts, so the copies lead the chain by 64-96 steps
// (~2.5-4 us, above a DRAM round trip under load); the first two are issued
// before the table build and overlap it.  The 16-bit shared load of a
// step's refill pair does not depend on x, and the stage's 32 steps are
// unrolled so it is hoisted.  45 KB of static shared memory.  Other shapes
// take the unstaged instance: byte loads kAhead = 8 steps ahead in a
// register ring.  The symbols go out as one byte store a lane-step (32
// contiguous bytes a warp-step; staging them for 16-byte stores measured
// slower).
//
// packed: each lane keeps its next unconsumed bytes in two 4-byte words A,
// B and a cursor `off` bytes into A: b0 and b1 are the low bytes of a
// funnel shift of B:A, ready before x is; a step takes k = (x < 2^15) +
// (x < 2^23) bytes, and when the cursor passes A the window moves on a word
// to C, loaded from shared memory a step ahead, all of it by selects (see
// the step).  The words come from a per-lane ring of kRing = 16
// 16-byte chunks in shared memory (32 KB a block, dynamic): aligned-floor
// chunks of the lane's row copied with cp.async; every 8 steps each lane
// issues the chunks its cursor has left, so the ring leads the chain by 15
// chunks (240 bytes, 120+ steps at the 2 bytes a step can take at most).  A
// row start need not be aligned (rows are L bytes apart): ring position r
// holds the byte at floor16(row) + r.  Bytes past the row read 255 (0 where
// L == 0) by a mask on each loaded word; the bytes of the tensor's first
// and last 16-byte blocks that lie outside it are never read (those chunks
// take byte loads).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one lane a thread
constexpr int kSlots = 4096;
constexpr uint32_t kRansL = 1u << 23;
constexpr int kStage = 32;      // aligned, staged: refill steps a stage
constexpr int kStages = 3;      // aligned, staged: stage buffers
constexpr int kAhead = 8;       // aligned, unstaged: register ring
constexpr int kRing = 16;       // packed: 16-byte chunks a lane
constexpr int kIssueEvery = 8;  // packed: steps between ring refills
constexpr int kRingWait = 6;    // packed: ring refills still in flight

struct Tables {
  uint32_t slot[kSlots];  // freq[s] | (slot - cum[s]) << 13
  uint8_t sym[kSlots];    // s
  int32_t cum[257];
  uint32_t carry[kThreads / 32];
};

// the packed kernel's dynamic shared memory: the tables, then the rings
constexpr int kTablesBytes = (sizeof(Tables) + 15) / 16 * 16;
constexpr int kPackedSmem = kTablesBytes + kRing * kThreads * 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Build both tables of one stream's frequency table (int32 [256]).
__device__ void build_tables(const int32_t* __restrict__ freq, Tables& tb) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint4* sym4 = reinterpret_cast<uint4*>(tb.sym);
  for (int i = tid; i < kSlots / 16; i += kThreads)
    sym4[i] = make_uint4(0u, 0u, 0u, 0u);
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
      tb.cum[tid * 8 + k] = c;
      c += f[k];
    }
    if (tid == 31) tb.cum[256] = c;
  }
  __syncthreads();
  // mark: symbol s starts at slot cum[s] (slot 0 is symbol 0's, as zeroed)
  for (int s = tid; s < 256; s += kThreads) {
    const int32_t c = tb.cum[s];
    if (c >= 0 && c < kSlots) tb.sym[c] = (uint8_t)s;
  }
  __syncthreads();
  // scan: a running max over the marks; this thread's 32 slots first
  const uint4 v0 = sym4[2 * tid], v1 = sym4[2 * tid + 1];
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  uint32_t top = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    top = max(top, (w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
  uint32_t incl = top;  // the carries, an inclusive max scan over threads
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl = max(incl, v);
  }
  if (lane == 31) tb.carry[warp] = incl;
  uint32_t run = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) run = 0;
  __syncthreads();
  for (int k = 0; k < warp; ++k) run = max(run, tb.carry[k]);
  uint32_t out[8];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    run = max(run, (w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
    const int slot = tid * 32 + k;
    const int32_t c = tb.cum[run];
    tb.slot[slot] = (uint32_t)(tb.cum[run + 1] - c) |
                    (uint32_t)(slot - c) << 13;
    if ((k & 3) == 0) out[k >> 2] = 0;
    out[k >> 2] |= run << (8 * (k & 3));
  }
  sym4[2 * tid] = make_uint4(out[0], out[1], out[2], out[3]);
  sym4[2 * tid + 1] = make_uint4(out[4], out[5], out[6], out[7]);
  __syncthreads();
}

// x's symbol and its update before the refills: one shared load on the
// chain (the symbol's load is off it)
__device__ __forceinline__ uint32_t advance(const Tables& tb, uint32_t& x) {
  const uint32_t slot = x & (kSlots - 1);
  const uint32_t e = tb.slot[slot];
  x = (e & 0x1FFFu) * (x >> 12) + (e >> 13);
  return tb.sym[slot];
}

// Both refills in one select; b01 = b0 << 8 | b1.
__device__ __forceinline__ uint32_t refill2(uint32_t x, uint32_t b0,
                                            uint32_t b01) {
  const uint32_t two = x << 16 | b01, one = x << 8 | b0;
  return x < (1u << 15) ? two : x < kRansL ? one : x;
}

// One step on a refill pair p = b0 | b1 << 8 → the symbol.
__device__ __forceinline__ uint32_t step_pair(const Tables& tb, uint32_t& x,
                                              uint32_t p) {
  const uint32_t b0 = p & 0xFFu, b01 = __byte_perm(p, 0u, 0x4401);
  const uint32_t s = advance(tb, x);
  x = refill2(x, b0, b01);
  return s;
}

bool staged(const void* refills, long long rf_bs, int N) {
  return (uintptr_t)refills % 16 == 0 && rf_bs % 16 == 0 && N % 8 == 0;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) rans_aligned_kernel(
    const uint8_t* __restrict__ refills, long long rf_bs,
    const int32_t* __restrict__ states, long long st_bs,
    const int32_t* __restrict__ freq, long long fq_bs,
    uint8_t* __restrict__ syms, long long sy_bs, int N, int steps) {
  __shared__ Tables tb;
  __shared__ __align__(16) uint16_t
      stage[kStaged ? kStages : 1][kStaged ? kStage : 1][kThreads];
  const int b = blockIdx.y, tid = threadIdx.x, j0 = blockIdx.x * kThreads;
  const int j = j0 + tid;
  const bool active = j < N;
  const uint8_t* rf = refills + b * rf_bs + 2LL * j0;  // the block's lanes
  const long long row = 2LL * N;                       // refill bytes a step
  // staged: stage k's rows, 16 bytes a chunk, (N - j0) / 8 chunks a row
  const int cols = (min(kThreads, N - j0) * 2) / 16;
  auto issue = [&](int k) {
    const int t0 = k * kStage, col = tid & 15;
#pragma unroll
    for (int r = tid >> 4; r < kStage; r += kThreads / 16)
      if (col < cols && t0 + r < steps)
        cp_async16(&stage[k % kStages][r][col * 8],
                   rf + (t0 + r) * row + col * 16);
    cp_async_commit();
  };
  if (kStaged) {  // the first two stages' copies overlap the table build
    issue(0);
    issue(1);
  }
  build_tables(freq + b * fq_bs, tb);
  uint32_t x = active ? (uint32_t)states[b * st_bs + j] : 0u;
  uint8_t* out = syms + b * sy_bs + j;
  if (kStaged) {
    const int nst = (steps + kStage - 1) / kStage;
    for (int k = 0; k < nst; ++k) {
      cp_async_wait<1>();  // stage k has landed (this thread's copies)
      __syncthreads();     // ... everyone's, and stage k - 1 is read
      issue(k + 2);        // into stage k - 1's buffer
      if (!active) continue;
      const uint16_t* sb = &stage[k % kStages][0][tid];
      const int t0 = k * kStage;
      uint8_t* o = out + (long long)t0 * N;
      if (t0 + kStage <= steps) {
#pragma unroll
        for (int u = 0; u < kStage; ++u)
          o[(long long)u * N] = (uint8_t)step_pair(tb, x, sb[u * kThreads]);
      } else {
        for (int u = 0; t0 + u < steps; ++u)
          o[(long long)u * N] = (uint8_t)step_pair(tb, x, sb[u * kThreads]);
      }
    }
    return;
  }
  if (!active) return;
  const uint8_t* rl = rf + 2 * tid;
  auto load = [&](int t) -> uint32_t {
    const uint8_t* p = rl + t * row;
    return (uint32_t)__ldcs(p) | (uint32_t)__ldcs(p + 1) << 8;
  };
  uint32_t r[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) r[k] = k < steps ? load(k) : 0u;
  int t = 0;
  for (; t + kAhead <= steps; t += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const uint32_t rk = r[k];
      // the load kAhead steps on, issued before this step's chain
      if (t + kAhead + k < steps) r[k] = load(t + kAhead + k);
      out[(long long)(t + k) * N] = (uint8_t)step_pair(tb, x, rk);
    }
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (t + k >= steps) break;
    out[(long long)(t + k) * N] = (uint8_t)step_pair(tb, x, r[k]);
  }
}

__global__ void __launch_bounds__(kThreads) rans_packed_kernel(
    const uint8_t* __restrict__ lanes, long long ln_bs, int L,
    const uint8_t* __restrict__ hi, const int32_t* __restrict__ states,
    long long st_bs, const int32_t* __restrict__ freq, long long fq_bs,
    uint8_t* __restrict__ syms, long long sy_bs, int N, int steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  Tables& tb = *reinterpret_cast<Tables*>(smem);
  // ring[c][lane]: chunk c (mod kRing) of each lane, 16 bytes
  uint4* ring = reinterpret_cast<uint4*>(smem + kTablesBytes);
  const int b = blockIdx.y, tid = threadIdx.x;
  const int j = blockIdx.x * kThreads + tid;
  const bool active = j < N;
  // the lane's row [p, p + L); ring position r holds the byte at a0 + r
  const uint8_t* p = lanes + b * ln_bs + (long long)j * L;
  const uint8_t* a0 = (const uint8_t*)((uintptr_t)p & ~(uintptr_t)15);
  const int o = (int)(p - a0);
  const int end = o + L;  // the row's end, a ring position
  auto fill = [&](int c) {  // chunk c: ring positions 16c .. 16c + 15
    const int r0 = 16 * c;
    if (!active || r0 >= end) return;  // past the row: the mask reads 255
    uint4* dst = ring + (c & (kRing - 1)) * kThreads + tid;
    const uint8_t* src = a0 + r0;
    if (src >= lanes && src + 16 <= hi) {
      cp_async16(dst, src);
      return;
    }
    // the tensor's first or last 16-byte block: only bytes inside it
    uint8_t* d = reinterpret_cast<uint8_t*>(dst);
    const long long i0 = src < lanes ? lanes - src : 0;
    const long long i1 = min(16LL, (long long)(hi - src));
    for (long long i = i0; i < i1; ++i) d[i] = __ldg(src + i);
  };
  // the aligned ring word at position q: bytes past the row read 255, and
  // 0 where L == 0 (one bit select)
  const uint32_t past = L ? 0xFFFFFFFFu : 0u;
  auto word = [&](int q) -> uint32_t {
    const uint32_t v = reinterpret_cast<const uint32_t*>(
        ring + ((q >> 4) & (kRing - 1)) * kThreads + tid)[(q >> 2) & 3];
    const int lim = end - q;  // the row's bytes from q on
    const uint32_t m = lim >= 4   ? 0u
                       : lim <= 0 ? 0xFFFFFFFFu
                                  : 0xFFFFFFFFu << (8 * lim);
    return (v & ~m) | (past & m);
  };
  int issued = kRing;
  for (int c = 0; c < kRing; ++c) fill(c);
  cp_async_commit();
  build_tables(freq + b * fq_bs, tb);  // overlaps the ring's first copies
  if (!active) return;
  cp_async_wait<0>();
  // the window: the words A, B at ring positions qc - 8, qc - 4 and the
  // cursor `off` bytes into A; C, at qc, is loaded a step ahead of its use
  int qc = (o & ~3) + 8, off = o & 3;
  uint32_t A = word(qc - 8), B = word(qc - 4), C = word(qc);
  uint32_t x = (uint32_t)states[b * st_bs + j];
  uint8_t* out = syms + b * sy_bs + j;
  // selects, not branches: a branch that some lane of the warp takes at
  // nearly every step would hold the next step's chain behind it
  auto step = [&](int t) {
    const uint32_t lo = __funnelshift_r(A, B, 8 * off);
    const uint32_t b0 = lo & 0xFFu, b01 = __byte_perm(lo, 0u, 0x4401);
    const uint32_t s = advance(tb, x);
    off += (x < (1u << 15)) + (x < kRansL);  // the bytes this step takes
    x = refill2(x, b0, b01);
    const bool next = off >= 4;
    A = next ? B : A;
    B = next ? C : B;
    off -= next ? 4 : 0;
    qc += next ? 4 : 0;
    C = word(qc);
    out[(long long)t * N] = (uint8_t)s;
  };
  for (int t0 = 0; t0 < steps; t0 += kIssueEvery) {
    if (t0 + kIssueEvery <= steps) {
#pragma unroll
      for (int u = 0; u < kIssueEvery; ++u) step(t0 + u);
    } else {
      for (int t = t0; t < steps; ++t) step(t);
    }
    // the chunks the cursor has left, refilled kRing on
    for (; issued < (qc >> 4) + kRing; ++issued) fill(issued);
    cp_async_commit();
    cp_async_wait<kRingWait>();
  }
}

// The chain bound's probe (no decode route; experiments/lane_step.py and
// chip_smoke.py time it): the decodes' grid and table build, then `steps`
// times the least chain a table-driven decode needs, one shared load, the
// multiply-add, one compare and select, with no global traffic in the loop;
// each lane's final state to out [B, N].
__global__ void __launch_bounds__(kThreads) rans_chain_probe_kernel(
    const int32_t* __restrict__ states, long long st_bs,
    const int32_t* __restrict__ freq, long long fq_bs,
    int32_t* __restrict__ out, long long out_bs, int N, int steps) {
  __shared__ Tables tb;
  const int b = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  build_tables(freq + b * fq_bs, tb);
  if (j >= N) return;
  uint32_t x = (uint32_t)states[b * st_bs + j];
#pragma unroll 8
  for (int t = 0; t < steps; ++t) {
    advance(tb, x);
    x = x < kRansL ? x << 8 | 0x5Au : x;
  }
  out[b * out_bs + j] = (int32_t)x;
}

}  // namespace

// 1 where jsp_rans_decode_aligned takes its staged instance (refills 16-byte
// aligned with a 16-byte batch stride, N % 8 == 0), 0 for the unstaged one.
extern "C" int jsp_rans_aligned_instance(const void* refills, long long rf_bs,
                                         int N) {
  return staged(refills, rf_bs, N) ? 1 : 0;
}

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
  auto kernel = staged(refills, rf_bs, N) ? rans_aligned_kernel<true>
                                          : rans_aligned_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)refills, rf_bs, (const int32_t*)states, st_bs,
      (const int32_t*)freq, fq_bs, (uint8_t*)syms, sy_bs, N, steps);
  return (int)cudaGetLastError();
}

// lanes: [B, N, L] u8, each stream's [N, L] contiguous; the rest as above.
// No load reads outside [lanes, lanes + (B - 1) * ln_bs + N * L).
extern "C" int jsp_rans_decode_packed(
    const void* lanes, long long ln_bs, int L, const void* states,
    long long st_bs, const void* freq, long long fq_bs, void* syms,
    long long sy_bs, int B, int N, int steps, void* stream) {
  if (B <= 0 || N <= 0 || steps <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      rans_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPackedSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  const uint8_t* base = (const uint8_t*)lanes;
  rans_packed_kernel<<<grid, kThreads, kPackedSmem, (cudaStream_t)stream>>>(
      base, ln_bs, L, base + (B - 1) * ln_bs + (long long)N * L,
      (const int32_t*)states, st_bs, (const int32_t*)freq, fq_bs,
      (uint8_t*)syms, sy_bs, N, steps);
  return (int)cudaGetLastError();
}

// states: [B, N] int32; freq: [B, 256] int32; out: [B, N] int32.
extern "C" int jsp_rans_chain_probe(const void* states, long long st_bs,
                                    const void* freq, long long fq_bs,
                                    void* out, long long out_bs, int B,
                                    int N, int steps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  rans_chain_probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)states, st_bs, (const int32_t*)freq, fq_bs,
      (int32_t*)out, out_bs, N, steps);
  return (int)cudaGetLastError();
}
