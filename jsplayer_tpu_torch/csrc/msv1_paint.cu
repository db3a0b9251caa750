// MSVideo1 paint: a whole window of the MSV1 scan, for all B streams of a
// batch in one launch.
//
// Replaces jsplayer_tpu/kernels/msv1_paint.py: paint_frame (eight one-hot
// where passes over the block colours under a painted-block mask) and the
// pixel half of significant_changes, under the lax.scan of decode_sequence /
// _decode_sequence_novmap (vmapped over streams in decode_batch).  Per pixel
// (y, x) of stream b at step t, with its 4x4 block's type and colours:
//
//   btype[b,t,blk] > 0 and sel[b,t,y,x] < 8 -> colors[b,t,blk,sel]
//   otherwise                               -> the step before's pixel
//
// (the first step's "before" is init[b]), written to frames[b,t], and
// diff[b,t] |= (y >= insign_lines and the pixel changed).  Every step paints,
// whatever `changes` says, as the reference's scan does; the block-row half
// of the significance and its combine with `changes` and the validity carry
// are torch ops on [B, T] in kernels/msv1_paint.py.
//
// MSV1 has no motion: a pixel depends only on the same pixel one step
// earlier.  So the time loop runs inside the kernel, each thread carrying 4
// consecutive pixels of a row (one block's row) in registers over the
// window; no step is a launch of its own.
//
// What bounds it: bytes.  The window writes every frame (4 bytes a pixel a
// step) and reads init once, btype (1 byte a block a step), and sel and
// colours of the painted blocks only (16 + 32 bytes a painted block); a
// CIF (352x288) step with every block painted is 405,504 + 6,336 + 101,376
// + 202,752 bytes, about 0.21 us at 3.35 TB/s.
//
// Design (the staged instance).  Only btype -> (sel, colours) is a true
// dependency; no load depends on the carried pixels.  So no load waits
// inside the time loop: a warp owns one block row of 8 MSV1 blocks (lane =
// 8 * row + block: lanes 0-7 store one whole 128-byte line of a row, 88
// and 80 blocks a row tile CIF and 320x240 exactly) and
//   * stages the btype of 64 steps in shared memory (one round trip);
//   * keeps sel and colours of its painted blocks kRing steps ahead in a
//     shared-memory ring, copied by cp.async (4 bytes of sel a lane, 8
//     bytes of the block's colours a lane), so a step's compute reads
//     shared memory only and the copies of later steps are in flight;
//   * ORs its changed bit into a 64-bit mask, one bit a step, and writes
//     diff once every 64 steps (a warp reduction and at most one atomic a
//     flagged step) instead of a vote and an atomic every step;
//   * stores the frames evict-first (st.global.cs): nothing reads them
//     again in the window.
// On an H100 (PERF.md, a B=8 x 64 CIF window, bound 0.069 ms) the stores
// alone take 0.082 ms and the gathered reads alone 0.063: they contend for
// DRAM, the reads as scattered 32-byte sectors (a painted block's 4 sel
// rows lie in 4 sectors).  Dense sel copies, 2- or 8-step rings, L2
// prefetch sizes and 64 warps an SM measured no faster.  The scalar
// instance (unaligned views: 4-byte sel, 16-byte init, frames and colours
// are what the staged copies and stores need) keeps the one-row-a-warp
// loop with its two round trips a step (btype, then sel and colours), with
// byte and word loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // warps a block of the staged instance
constexpr int kBlocks = 8;  // MSV1 blocks a warp covers: a row of 32 pixels
constexpr int kChunk = 64;  // steps a btype stage and a diff mask cover
constexpr int kRing = 4;    // steps of sel and colours copied ahead
constexpr int kMinBlocks = 48 / kWarps;  // blocks an SM holds: 48 warps
constexpr int kTx = 32, kTy = 8;  // the scalar instance's block

// One warp's staging: btype of a chunk, and a ring of sel words and colours
struct alignas(16) WarpStage {
  uint8_t bt[kChunk][kBlocks];
  uint32_t sel[kRing][32];
  int32_t col[kRing][kBlocks][8];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
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

// Warp g of B * nby * nw: stream b, block row by, blocks [8 wx, 8 wx + 8).
// kMinBlocks keeps it at 40 registers or fewer: 48 warps an SM, so a B=8
// CIF window (6,336 warps) is one wave of the card's 132 SMs.
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) msv1_staged_kernel(
    const int32_t* __restrict__ init, long long init_bs,
    const uint8_t* __restrict__ btype, long long bt_bs, long long bt_ts,
    const uint8_t* __restrict__ sel, long long sel_bs, long long sel_ts,
    const int32_t* __restrict__ colors, long long col_bs, long long col_ts,
    int32_t* __restrict__ frames, long long fr_bs, long long fr_ts,
    int* __restrict__ diff, int B, int T, int Y, int X, int insign_lines,
    int nw) {
  __shared__ WarpStage stage[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nby = Y >> 2, nbx = X >> 2;
  const long long g = (long long)blockIdx.x * kWarps + w;
  if (g >= (long long)B * nby * nw) return;  // a whole warp: no sync left
  WarpStage& s = stage[w];
  const int wx = (int)(g % nw), by = (int)(g / nw % nby);
  const int b = (int)(g / ((long long)nw * nby));
  const int r = lane >> 3, bi = lane & 7;  // the lane's row, block
  const int bx = wx * kBlocks + bi;
  const int nblk = min(kBlocks, nbx - wx * kBlocks);  // blocks in the frame
  const bool inside = bi < nblk;
  const int y = by * 4 + r;
  const bool counted = inside && y >= insign_lines;
  const long long px = (long long)y * X + bx * 4;
  int32_t cur[4] = {0, 0, 0, 0};
  if (inside) {
    const int4 a = __ldg((const int4*)(init + b * init_bs + px));
    cur[0] = a.x; cur[1] = a.y; cur[2] = a.z; cur[3] = a.w;
  }
  // the btype of the lane's block, which it stages for steps r, r + 4, ...
  const uint8_t* btb = btype + b * bt_bs + (long long)by * nbx + bx;
  const uint8_t* sb = sel + b * sel_bs + px;
  const int32_t* cb =
      colors + b * col_bs + ((long long)by * nbx + bx) * 8 + 2 * r;
  int32_t* fp = frames + b * fr_bs + px;  // the next step's frame
  int* db = diff + (long long)b * T;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncwarp();  // the previous chunk's reads of s.bt are done
#pragma unroll 8
    for (int k = r; k < kChunk; k += 4)
      s.bt[k][bi] = k < n && inside ? __ldg(btb + (t0 + k) * bt_ts) : 0;
    __syncwarp();

    // step k's sel word and colour pair into ring slot k % kRing, where
    // the block is painted; one commit group a step, empty or not.  The
    // steps are issued in order, so the sources advance a step a call.
    const uint8_t* isp = sb + t0 * sel_ts;
    const int32_t* icp = cb + t0 * col_ts;
    auto issue = [&](int k) {
      if (k < n && inside && s.bt[k][bi] != 0) {
        const int slot = k % kRing;
        cp_async4(&s.sel[slot][lane], isp);
        cp_async8(&s.col[slot][bi][2 * r], icp);
      }
      cp_async_commit();
      isp += sel_ts;
      icp += col_ts;
    };
#pragma unroll
    for (int k = 0; k < kRing; ++k) issue(k);

    unsigned long long mask = 0;  // bit k: a counted pixel changed at t0 + k
    for (int k = 0; k < n; ++k) {
      cp_async_wait<kRing - 1>();  // this lane's copies of step k landed
      __syncwarp();                // and the block's other three lanes'
      bool changed = false;
      if (inside) {
        if (s.bt[k][bi] != 0) {
          const int slot = k % kRing;
          const uint32_t s4 = s.sel[slot][lane];
          const int32_t* c = s.col[slot][bi];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t sj = s4 >> (8 * j) & 0xFFu;
            if (sj < 8) {
              const int32_t px_v = c[sj];
              changed |= px_v != cur[j];
              cur[j] = px_v;
            }
          }
        }
        __stcs((int4*)fp, make_int4(cur[0], cur[1], cur[2], cur[3]));
      }
      fp += fr_ts;
      mask |= (unsigned long long)(counted && changed) << k;
      __syncwarp();  // every lane is done with slot k % kRing
      issue(k + kRing);
    }
    cp_async_wait<0>();
    const uint32_t lo = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)mask);
    const uint32_t hi = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)(mask >> 32));
    if (lo >> lane & 1u) atomicOr(db + t0 + lane, 1);
    if (hi >> lane & 1u) atomicOr(db + t0 + 32 + lane, 1);
  }
}

__device__ __forceinline__ int32_t pick(unsigned s, const int32_t* c) {
  // c[s] for s < 8 by selects, so the colours stay in registers
  int32_t v = c[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = s == (unsigned)k ? c[k] : v;
  return v;
}

// The scalar instance: 32 x 8 threads cover 128 columns of 8 rows, each
// thread 4 consecutive pixels of a row; a warp is 32 segments of one row,
// so its diff is one vote and one atomic OR of lane 0 a step.
__global__ void __launch_bounds__(kTx * kTy) msv1_scalar_kernel(
    const int32_t* __restrict__ init, long long init_bs,
    const uint8_t* __restrict__ btype, long long bt_bs, long long bt_ts,
    const uint8_t* __restrict__ sel, long long sel_bs, long long sel_ts,
    const int32_t* __restrict__ colors, long long col_bs, long long col_ts,
    int32_t* __restrict__ frames, long long fr_bs, long long fr_ts,
    int* __restrict__ diff, int T, int Y, int X, int insign_lines) {
  const int b = blockIdx.z;
  const int seg = blockIdx.x * kTx + threadIdx.x;  // 4-pixel segment of a row
  const int y = blockIdx.y * kTy + threadIdx.y;
  const int nbx = X >> 2;
  // threads outside the frame stay for the warp's vote
  const bool inside = seg < nbx && y < Y;
  const int x0 = seg * 4;
  const long long blk = (long long)(y >> 2) * nbx + seg;
  const long long px = (long long)y * X + x0;
  const bool counted = inside && y >= insign_lines;
  int32_t cur[4] = {0, 0, 0, 0};
  if (inside) {
    const int32_t* p = init + b * init_bs + px;
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = __ldg(p + j);
  }
  const uint8_t* btb = btype + b * bt_bs + blk;
  const uint8_t* sb = sel + b * sel_bs + px;
  const int32_t* cb = colors + b * col_bs + blk * 8;
  int32_t* fb = frames + b * fr_bs + px;
  for (int t = 0; t < T; ++t) {
    bool changed_px = false;
    if (inside) {
      if (__ldg(btb + t * bt_ts) != 0) {
        const uint8_t* sp = sb + t * sel_ts;
        const int32_t* cp = cb + t * col_ts;
        const unsigned s4 = (unsigned)__ldg(sp) |
                            (unsigned)__ldg(sp + 1) << 8 |
                            (unsigned)__ldg(sp + 2) << 16 |
                            (unsigned)__ldg(sp + 3) << 24;
        int32_t c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = __ldg(cp + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned sj = s4 >> (8 * j) & 0xFFu;
          if (sj < 8) {
            const int32_t v = pick(sj, c);
            changed_px |= v != cur[j];
            cur[j] = v;
          }
        }
      }
      int32_t* f = fb + t * fr_ts;
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = cur[j];
    }
    if (__any_sync(0xFFFFFFFFu, counted && changed_px) &&
        (threadIdx.x & 31) == 0)
      atomicOr(diff + (long long)b * T + t, 1);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

// Whether the staged instance takes the window: 16-byte init and frames
// (the carried pixels' loads and stores), 4-byte sel words and 8-byte
// colour pairs for the copies.
bool staged(const void* init, long long init_bs, const void* sel,
            long long sel_bs, long long sel_ts, const void* colors,
            long long col_bs, long long col_ts, const void* frames,
            long long fr_bs, long long fr_ts) {
  return aligned(init, 16) && aligned(frames, 16) && aligned(sel, 4) &&
         aligned(colors, 8) && init_bs % 4 == 0 && fr_bs % 4 == 0 &&
         fr_ts % 4 == 0 && sel_bs % 4 == 0 && sel_ts % 4 == 0 &&
         col_bs % 2 == 0 && col_ts % 2 == 0;
}

}  // namespace

// 1 where jsp_msv1_paint takes the staged instance for these views, 0 where
// it takes the scalar one.
extern "C" int jsp_msv1_paint_instance(
    const void* init, long long init_bs, const void* sel, long long sel_bs,
    long long sel_ts, const void* colors, long long col_bs, long long col_ts,
    const void* frames, long long fr_bs, long long fr_ts) {
  return staged(init, init_bs, sel, sel_bs, sel_ts, colors, col_bs, col_ts,
                frames, fr_bs, fr_ts)
             ? 1
             : 0;
}

// init: [B, Y, X] int32 (batch stride init_bs, contiguous rows), Y and X
// multiples of 4; btype: [B, T, NB] u8 (NB = (Y/4) * (X/4)); sel: [B, T, Y,
// X] u8; colors: [B, T, NB, 8] int32; frames: [B, T, Y, X] int32 — each with
// batch stride *_bs and step stride *_ts and contiguous rows within a step;
// diff: [B, T] int, zeroed here.  → the first CUDA error code, or 0.
extern "C" int jsp_msv1_paint(
    const void* init, long long init_bs, const void* btype, long long bt_bs,
    long long bt_ts, const void* sel, long long sel_bs, long long sel_ts,
    const void* colors, long long col_bs, long long col_ts, void* frames,
    long long fr_bs, long long fr_ts, void* diff, int B, int T, int Y, int X,
    int insign_lines, void* stream) {
  if (B <= 0 || T <= 0 || Y <= 0 || X <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(diff, 0, sizeof(int) * B * T, s);
  if (e != cudaSuccess) return (int)e;
  if (staged(init, init_bs, sel, sel_bs, sel_ts, colors, col_bs, col_ts,
             frames, fr_bs, fr_ts)) {
    const int nw = ((X >> 2) + kBlocks - 1) / kBlocks;
    const long long warps = (long long)B * (Y >> 2) * nw;
    msv1_staged_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps),
                         32 * kWarps, 0, s>>>(
        (const int32_t*)init, init_bs, (const uint8_t*)btype, bt_bs, bt_ts,
        (const uint8_t*)sel, sel_bs, sel_ts, (const int32_t*)colors, col_bs,
        col_ts, (int32_t*)frames, fr_bs, fr_ts, (int*)diff, B, T, Y, X,
        insign_lines, nw);
  } else {
    const unsigned gx = ((X >> 2) + kTx - 1) / kTx;
    const unsigned gy = (Y + kTy - 1) / kTy;
    msv1_scalar_kernel<<<dim3(gx, gy, B), dim3(kTx, kTy), 0, s>>>(
        (const int32_t*)init, init_bs, (const uint8_t*)btype, bt_bs, bt_ts,
        (const uint8_t*)sel, sel_bs, sel_ts, (const int32_t*)colors, col_bs,
        col_ts, (int32_t*)frames, fr_bs, fr_ts, (int*)diff, T, Y, X,
        insign_lines);
  }
  return (int)cudaGetLastError();
}
