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
// earlier.  So the time loop runs inside the kernel: each thread owns 4
// consecutive pixels of a row (one block's row), keeps them in registers over
// t = 0..T-1 and writes each step's words; no step is a launch of its own.
// A block of 32 x 8 threads covers 128 columns of 8 rows; a warp is 32
// neighbouring segments of one row, so its diff is one vote and one atomic
// OR of lane 0.  Colours are read only for painted blocks (two 16-byte loads
// where aligned), sel as one 4-byte word, the pixels stored as one 16-byte
// word where X % 4 == 0 keeps rows aligned (MSV1 frames are whole blocks,
// so always, given aligned bases and strides).  A step waits two
// round trips (btype, then sel and colours); issuing 2 or 4 steps' loads
// together, prefetching the next step's, or gathering the diff flags of a
// block in shared memory before its atomics measured slower on an H100,
// and evict-first stores or 64-thread blocks no faster (PERF.md).
//
// What bounds it: bytes.  The window writes every frame (4 bytes a pixel a
// step) and reads init once, btype (1 byte a block a step), and sel and
// colours of the painted blocks only (16 + 32 bytes a painted block); a
// CIF (352x288) step with every block painted is 405,504 + 6,336 + 101,376
// + 202,752 bytes, about 0.21 us at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;

__device__ __forceinline__ int32_t pick(unsigned s, const int32_t* c) {
  // c[s] for s < 8 by selects, so the colours stay in registers
  int32_t v = c[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = s == (unsigned)k ? c[k] : v;
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kTx * kTy) msv1_paint_kernel(
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
    if (kVec) {
      const int4 a = __ldg((const int4*)p);
      cur[0] = a.x; cur[1] = a.y; cur[2] = a.z; cur[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[j] = __ldg(p + j);
    }
  }
  const uint8_t* btb = btype + b * bt_bs + blk;
  const uint8_t* sb = sel + b * sel_bs + px;
  const int32_t* cb = colors + b * col_bs + blk * 8;
  int32_t* fb = frames + b * fr_bs + px;
  for (int t = 0; t < T; ++t) {
    bool changed_px = false;
    if (inside) {
      if (__ldg(btb + t * bt_ts) != 0) {
        unsigned s4;
        int32_t c[8];
        const uint8_t* sp = sb + t * sel_ts;
        const int32_t* cp = cb + t * col_ts;
        if (kVec) {
          s4 = __ldg((const unsigned*)sp);
          const int4 c0 = __ldg((const int4*)cp);
          const int4 c1 = __ldg((const int4*)(cp + 4));
          c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
          c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
        } else {
          s4 = (unsigned)__ldg(sp) | (unsigned)__ldg(sp + 1) << 8 |
               (unsigned)__ldg(sp + 2) << 16 | (unsigned)__ldg(sp + 3) << 24;
#pragma unroll
          for (int k = 0; k < 8; ++k) c[k] = __ldg(cp + k);
        }
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
      if (kVec) {
        *(int4*)f = make_int4(cur[0], cur[1], cur[2], cur[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) f[j] = cur[j];
      }
    }
    if (__any_sync(0xFFFFFFFFu, counted && changed_px) &&
        (threadIdx.x & 31) == 0)
      atomicOr(diff + (long long)b * T + t, 1);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

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
  const bool vec = aligned(init, 16) && aligned(frames, 16) &&
                   aligned(sel, 4) && aligned(colors, 16) &&
                   init_bs % 4 == 0 && fr_bs % 4 == 0 && fr_ts % 4 == 0 &&
                   sel_bs % 4 == 0 && sel_ts % 4 == 0 && col_bs % 4 == 0 &&
                   col_ts % 4 == 0;
  const unsigned gx = ((X >> 2) + kTx - 1) / kTx;
  const unsigned gy = (Y + kTy - 1) / kTy;
  auto kernel = vec ? msv1_paint_kernel<true> : msv1_paint_kernel<false>;
  kernel<<<dim3(gx, gy, B), dim3(kTx, kTy), 0, s>>>(
      (const int32_t*)init, init_bs, (const uint8_t*)btype, bt_bs, bt_ts,
      (const uint8_t*)sel, sel_bs, sel_ts, (const int32_t*)colors, col_bs,
      col_ts, (int32_t*)frames, fr_bs, fr_ts, (int*)diff, T, Y, X,
      insign_lines);
  return (int)cudaGetLastError();
}
