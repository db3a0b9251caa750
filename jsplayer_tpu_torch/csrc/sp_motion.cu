// sp_motion: one P-frame step of the ScreenPressor block-command compose,
// for all B streams of a batch in one launch.  One kernel, templated on a
// mode, behind three C entry points:
//
//   general  (jsp_sp_compose_general) replaces
//            jsplayer_tpu/kernels/sp_recon.py: compose_frame, the XLA scan
//            step of decode_sequence / decode_batch (a per-pixel gather).
//   fused    (jsp_sp_motion_patch) replaces
//            jsplayer_tpu/kernels/sp_motion_pallas.py: _patch_kernel (Pallas,
//            behind motion_patch) with the select pass of compose_frame_fast.
//   mxu      (jsp_sp_motion_mxu) replaces
//            jsplayer_tpu/kernels/sp_motion_mxu.py: _kernel (Pallas, behind
//            compose_frame_mxu_safe).
//
// Per pixel (y, x) of stream b, in SP block (by, bx) = (y/16, x/16), row
// i = y%16, column j = x%16, with the block's command b, mv = (mx, my),
// rect = (x0, y0, x1, y1), in_rect = x0 <= x < x1 && y0 <= y < y1:
//
//   general: active = b > 0 && in_rect
//            active && ((b-1) & 2) -> prev[clip(y+my, 0, Y-1), clip(x+mx, 0, X-1)]
//            active                -> payload[y, x]
//            otherwise             -> prev[y, x]
//   fused:   b == 3                -> prev[by*16+my+i, bx*16+mx+j]  (whole block)
//            b > 0 && in_rect      -> payload[y, x]
//            otherwise             -> prev[y, x]
//   mxu:     is_motion != 0        -> prev[sy+i, sx+j], (sy, sx) = src_yx
//            (paycode >> 24) > 0   -> paycode & 0xFFFFFF
//            otherwise             -> prev[y, x]
//   changed[b] == 0                -> prev[y, x] for every pixel, and the
//                                     block's commands are never read (a
//                                     quarantined stream's rows are stale)
//
// The general mode adds in 32-bit two's complement, as jnp's int32 does,
// then clips.  The fused and mxu modes read 0 for a source outside the
// frame; the TPU kernels pad (1080 -> 1088 rows, +8 rows / +128 columns)
// and read the pad there, and the decoder never emits such a source.  Only
// pixels inside the [Y, X] frame are written.
//
// What bounds it: bytes.  A pixel of a changed stream reads one source
// word, the one its command selects (payload inside a data rect, a moved
// prev word for motion, prev elsewhere), and writes out: 8 bytes a pixel.
// On the captured B=4 1080p step chip_smoke.py times that is 16.8 MB a
// stream-step, 67.3 MB for B=4, 0.0201 ms at 3.35 TB/s (`block_bytes`);
// the mxu mode reads paycode wherever a block is not motion, and prev
// besides where its top byte is 0: 93.6 MB, 0.0279 ms.  The TPU kernels
// over-fetch a 24x256 window per motion block (a ~20x read amplification),
// align it with lane rotates or one-hot matmuls, and serial
// read-modify-write stripes; none of that is needed where any address can
// be read.  The design is kmv_compose.cu's, for block commands:
//
//   * a 3-D grid: blockIdx.z is the stream, blockIdx.y a band of 16 rows
//     (one SP block row), blockIdx.x 128 columns (8 SP blocks); each of
//     the 32x8 threads covers 2 rows x 4 consecutive pixels, which lie in
//     one SP block (x0 % 4 == 0, y0 even): 4,080 blocks for a B=4 1080p
//     step;
//   * a thread reads `changed`, then its SP block's command straight into
//     registers with __ldg (the 32 threads of an SP block load the same
//     words; no shared memory, no barrier);
//   * per row, the rect gives a 4-bit mask of the pixels that take the
//     command's source.  A vector wholly outside it loads prev only, one
//     wholly inside the source only (payload or paycode evict-first,
//     __ldcs: it is read once), one that a rect edge splits both, selected
//     per pixel;
//   * a moved vector is one 16-byte load where its source is 16-byte
//     aligned and wholly in the frame, four 4-byte loads where it is in the
//     frame but not aligned (adjacent threads read adjacent words, so the
//     sectors coalesce), and per pixel only at the frame's edge (general
//     clips, fused and mxu read 0);
//   * a still mxu block loads paycode, and prev only for a row where some
//     pixel's top byte is 0;
//   * every load of both rows is issued before any pixel is composed, and
//     out is stored as 16 bytes;
//   * the vector instance (kVec) runs where X % 4 == 0 and the three
//     planes' bases and batch strides are 16-byte aligned (a frames[:, t]
//     view of a [B, T, Y, X] window qualifies); otherwise the same indexing
//     with 4-byte accesses, masked at the row end.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (experiments/block_step.py,
// CUDA graphs of wrapper calls): the captured B=4 step takes 0.025 ms in
// the general and fused modes (79-81% of the bound) and 0.035 ms in the
// mxu mode (79%), against 0.076 ms for the one-thread-a-pixel kernel this
// design replaced.  Commands staged in shared memory behind a barrier
// measured the same as the __ldg loads above, and an unaligned moved
// vector read as two aligned 16-byte loads and a funnel 5% slower than as
// four 4-byte loads.  37-44 registers a thread, no spills (ptxas -v).
//
// `out` must not alias `prev`: motion reads would see pixels already
// written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kGeneral = 0, kFused = 1, kMxu = 2 };

constexpr int kTx = 32, kTy = 8;  // threads a block
constexpr int kPx = 4;            // consecutive pixels of a row a thread covers
constexpr int kRows = 2;          // rows a thread covers
constexpr unsigned kAll = (1u << kPx) - 1;

struct Args {
  const int32_t* prev; long long prev_bs;
  const int32_t* pix; long long pix_bs;    // payload, or paycode (mxu)
  const int32_t* kind; long long kind_bs;  // bts [NB], or is_motion (mxu)
  const int32_t* vec; long long vec_bs;    // mv [NB,2] (mx,my), or src_yx (sy,sx)
  const int32_t* rect; long long rect_bs;  // rect [NB,4]; unused by mxu
  const uint8_t* changed; long long chg_bs;
  int32_t* out; long long out_bs;
  int Y, X, nbx;
};

// kPx words at p: one 16-byte load (kVec: p is 16-byte aligned), else the
// first n with 4-byte loads.  kOnce: evict-first, for a plane read once.
template <bool kVec, bool kOnce>
__device__ __forceinline__ void load_px(int32_t (&d)[kPx],
                                        const int32_t* __restrict__ p,
                                        int n) {
  if (kVec) {
    const int4 v = kOnce ? __ldcs((const int4*)p) : __ldg((const int4*)p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j)
      d[j] = j < n ? (kOnce ? __ldcs(p + j) : __ldg(p + j)) : 0;
  }
}

// A moved row: `row` (a prev row inside the frame) at columns sx0 + j.
// Wholly in the frame it is one 16-byte load where sx0 is aligned (kVec),
// else four 4-byte loads; at the frame's edge it goes per pixel: kClip
// (general) adds j in 32 bits and clips, otherwise a column outside the
// frame reads 0.
template <bool kVec, bool kClip>
__device__ __forceinline__ void load_moved(int32_t (&d)[kPx],
                                           const int32_t* __restrict__ row,
                                           long long sx0, int X) {
  if (sx0 >= 0 && sx0 <= X - kPx) {
    if (kVec && (sx0 & 3) == 0) {
      const int4 v = __ldg((const int4*)(row + sx0));
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j) d[j] = __ldg(row + sx0 + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (kClip) {
        const int sx = (int)((unsigned)sx0 + (unsigned)j);
        d[j] = __ldg(row + (sx < 0 ? 0 : (sx > X - 1 ? X - 1 : sx)));
      } else {
        const long long sx = sx0 + j;
        d[j] = sx >= 0 && sx < X ? __ldg(row + sx) : 0;
      }
    }
  }
}

template <int MODE, bool kVec>
__global__ void __launch_bounds__(kTx * kTy) sp_motion_kernel(Args a) {
  const int b = blockIdx.z;
  const int x0 = (blockIdx.x * kTx + threadIdx.x) * kPx;
  const int y0 = (blockIdx.y * kTy + threadIdx.y) * kRows;
  if (x0 >= a.X || y0 >= a.Y) return;
  const int nr = min(kRows, a.Y - y0);
  const int nx = min(kPx, a.X - x0);  // < kPx only on the 4-byte path
  const unsigned valid = (1u << nx) - 1;
  const int32_t* __restrict__ pv = a.prev + b * a.prev_bs;
  const int32_t* __restrict__ px = a.pix + b * a.pix_bs;
  int32_t* __restrict__ ob = a.out + b * a.out_bs;

  // take[r]: the pixels of row r that take the command's source (payload,
  // paycode or moved prev); the others copy prev.  An unchanged stream
  // takes none, and its command is not read.
  unsigned take[kRows] = {0u, 0u};
  bool moved = false;
  int v0 = 0, v1 = 0;  // mv (mx, my), or src_yx (sy, sx)
  if (a.changed[b * a.chg_bs] != 0) {
    const long long blk = (long long)(y0 >> 4) * a.nbx + (x0 >> 4);
    const int k = __ldg(a.kind + b * a.kind_bs + blk);
    const int32_t* vp = a.vec + b * a.vec_bs + 2 * blk;
    v0 = __ldg(vp);
    v1 = __ldg(vp + 1);
    if (MODE == kMxu) {
      moved = k != 0;
      take[0] = take[1] = kAll;
    } else {
      // issued beside kind and vec: one round trip for the whole command
      const int32_t* rp = a.rect + b * a.rect_bs + 4 * blk;
      const int rx0 = __ldg(rp), ry0 = __ldg(rp + 1);
      const int rx1 = __ldg(rp + 2), ry1 = __ldg(rp + 3);
      if (MODE == kFused && k == 3) {
        moved = true;
        take[0] = take[1] = kAll;
      } else if (k > 0) {
        unsigned cols = 0;
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          cols |= (unsigned)(x0 + j >= rx0 && x0 + j < rx1) << j;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          take[r] = y0 + r >= ry0 && y0 + r < ry1 ? cols : 0u;
        moved = MODE == kGeneral && ((k - 1) & 2);
      }
    }
  }
  // a still block of the mxu mode: paycode decides per pixel
  const bool code = MODE == kMxu && take[0] != 0 && !moved;

  // every row's loads are issued before any pixel is composed
  int32_t own[kRows][kPx] = {}, src[kRows][kPx] = {};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    const int y = y0 + r;
    const long long i = (long long)y * a.X + x0;
    const unsigned t = take[r] & valid;
    if (t != valid) load_px<kVec, false>(own[r], pv + i, nx);
    if (t == 0) continue;
    if (!moved) {
      load_px<kVec, true>(src[r], px + i, nx);
    } else if (MODE == kGeneral) {
      // int32 wrap, then clip: jnp's yy + my and jnp.clip
      int sy = (int)((unsigned)y + (unsigned)v1);
      sy = sy < 0 ? 0 : (sy > a.Y - 1 ? a.Y - 1 : sy);
      load_moved<kVec, true>(src[r], pv + (long long)sy * a.X,
                             (int)((unsigned)x0 + (unsigned)v0), a.X);
    } else {
      // fused: prev[y + my, x + mx]; mxu: prev[sy + y%16, sx + x%16]
      const long long sy = MODE == kFused ? (long long)y + v1
                                          : (long long)v0 + (y & 15);
      const long long sx0 = MODE == kFused ? (long long)x0 + v0
                                           : (long long)v1 + (x0 & 15);
      // a source row outside the frame reads 0: src stays 0
      if (sy >= 0 && sy < a.Y)
        load_moved<kVec, false>(src[r], pv + sy * a.X, sx0, a.X);
    }
  }
  if (code) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) continue;
      bool copy = false;
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        copy |= j < nx && ((uint32_t)src[r][j] >> 24) == 0u;
      if (copy)
        load_px<kVec, false>(own[r], pv + (long long)(y0 + r) * a.X + x0,
                             nx);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    int32_t o[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (code) {
        const uint32_t w = (uint32_t)src[r][j];
        o[j] = (w >> 24) ? (int32_t)(w & 0x00FFFFFFu) : own[r][j];
      } else {
        o[j] = (take[r] >> j) & 1u ? src[r][j] : own[r][j];
      }
    }
    int32_t* op = ob + (long long)(y0 + r) * a.X + x0;
    if (kVec) {
      *(int4*)op = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        if (j < nx) op[j] = o[j];
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int MODE>
int launch(const Args& a, int B, void* stream) {
  if (B <= 0 || a.Y <= 0 || a.X <= 0) return 0;
  const bool vec = a.X % kPx == 0 && aligned16(a.prev) && aligned16(a.pix) &&
                   aligned16(a.out) && a.prev_bs % kPx == 0 &&
                   a.pix_bs % kPx == 0 && a.out_bs % kPx == 0;
  const dim3 block(kTx, kTy);
  const unsigned gx = ((a.X + kPx - 1) / kPx + kTx - 1) / kTx;
  const unsigned gy = ((a.Y + kRows - 1) / kRows + kTy - 1) / kTy;
  auto kernel = vec ? sp_motion_kernel<MODE, true>
                    : sp_motion_kernel<MODE, false>;
  // B > 65535 streams exceeds gridDim.z: the launch fails and is reported
  kernel<<<dim3(gx, gy, (unsigned)B), block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* prev, long long prev_bs, const void* pix,
               long long pix_bs, const void* kind, long long kind_bs,
               const void* vec, long long vec_bs, const void* rect,
               long long rect_bs, const void* changed, long long chg_bs,
               void* out, long long out_bs, int Y, int X) {
  Args a;
  a.prev = (const int32_t*)prev; a.prev_bs = prev_bs;
  a.pix = (const int32_t*)pix; a.pix_bs = pix_bs;
  a.kind = (const int32_t*)kind; a.kind_bs = kind_bs;
  a.vec = (const int32_t*)vec; a.vec_bs = vec_bs;
  a.rect = (const int32_t*)rect; a.rect_bs = rect_bs;
  a.changed = (const uint8_t*)changed; a.chg_bs = chg_bs;
  a.out = (int32_t*)out; a.out_bs = out_bs;
  a.Y = Y; a.X = X; a.nbx = (X + 15) / 16;
  return a;
}

}  // namespace

// Batch strides (`*_bs`) are in elements; each [Y, X] plane and each
// command row is contiguous.
extern "C" int jsp_sp_compose_general(
    const void* prev, long long prev_bs, const void* payload, long long pay_bs,
    const void* bts, long long bts_bs, const void* mv, long long mv_bs,
    const void* rect, long long rect_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, int B, int Y, int X, void* stream) {
  return launch<kGeneral>(
      make_args(prev, prev_bs, payload, pay_bs, bts, bts_bs, mv, mv_bs, rect,
                rect_bs, changed, chg_bs, out, out_bs, Y, X), B, stream);
}

extern "C" int jsp_sp_motion_patch(
    const void* prev, long long prev_bs, const void* payload, long long pay_bs,
    const void* bts, long long bts_bs, const void* mv, long long mv_bs,
    const void* rect, long long rect_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, int B, int Y, int X, void* stream) {
  return launch<kFused>(
      make_args(prev, prev_bs, payload, pay_bs, bts, bts_bs, mv, mv_bs, rect,
                rect_bs, changed, chg_bs, out, out_bs, Y, X), B, stream);
}

extern "C" int jsp_sp_motion_mxu(
    const void* prev, long long prev_bs, const void* paycode, long long pc_bs,
    const void* src_yx, long long src_bs, const void* is_motion,
    long long im_bs, const void* changed, long long chg_bs, void* out,
    long long out_bs, int B, int Y, int X, void* stream) {
  return launch<kMxu>(
      make_args(prev, prev_bs, paycode, pc_bs, is_motion, im_bs, src_yx,
                src_bs, nullptr, 0, changed, chg_bs, out, out_bs, Y, X),
      B, stream);
}
