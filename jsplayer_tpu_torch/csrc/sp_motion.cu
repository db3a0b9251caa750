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
// What bounds it: bytes.  A changed frame reads each pixel's command source
// once (payload/paycode or prev) and writes out: 8-12 bytes a pixel, ~25 MB
// a 1080p stream-step, ~100 MB for B=4, ~30 us at 3.35 TB/s.  The TPU
// kernels over-fetch a 24x256 window per motion block (a ~20x read
// amplification), align it with lane rotates or one-hot matmuls, and serial
// read-modify-write stripes; none of that is needed where any address can
// be read.  Design: one thread block per 16x16 SP block (grid nbx, nby, B),
// one thread a pixel; the block's command is loaded once into shared
// memory, and each half-warp reads one 64-byte row segment, so loads are
// coalesced.  `out` must not alias `prev`: motion reads would see pixels
// already written.  Vectorised 16-byte accesses and a persistent scan are
// later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kGeneral = 0, kFused = 1, kMxu = 2 };

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

__device__ __forceinline__ int32_t read_or_zero(const int32_t* pv, long long sy,
                                                long long sx, int Y, int X) {
  return (sy >= 0 && sy < Y && sx >= 0 && sx < X) ? pv[sy * X + sx] : 0;
}

template <int MODE>
__global__ void __launch_bounds__(256) sp_motion_kernel(Args a) {
  __shared__ int cmd[7];  // kind, vec[2], rect[4]
  const int b = blockIdx.z;
  const long long blk = (long long)blockIdx.y * a.nbx + blockIdx.x;
  const bool chg = a.changed[b * a.chg_bs] != 0;  // uniform in the block
  if (chg) {
    const int t = threadIdx.x;
    if (t == 0) cmd[0] = a.kind[b * a.kind_bs + blk];
    else if (t < 3) cmd[t] = a.vec[b * a.vec_bs + 2 * blk + (t - 1)];
    else if (MODE != kMxu && t < 7)
      cmd[t] = a.rect[b * a.rect_bs + 4 * blk + (t - 3)];
    __syncthreads();
  }
  const int i = threadIdx.x >> 4, j = threadIdx.x & 15;
  const int y = blockIdx.y * 16 + i, x = blockIdx.x * 16 + j;
  if (y >= a.Y || x >= a.X) return;
  const long long p = (long long)y * a.X + x;
  const int32_t* pv = a.prev + b * a.prev_bs;
  int32_t v;
  if (!chg) {
    v = pv[p];
  } else if (MODE == kMxu) {
    if (cmd[0] != 0) {
      v = read_or_zero(pv, (long long)cmd[1] + i, (long long)cmd[2] + j, a.Y,
                       a.X);
    } else {
      const uint32_t w = (uint32_t)a.pix[b * a.pix_bs + p];
      v = (w >> 24) ? (int32_t)(w & 0x00FFFFFFu) : pv[p];
    }
  } else {
    const int k = cmd[0];
    const bool in_rect = x >= cmd[3] && x < cmd[5] && y >= cmd[4] && y < cmd[6];
    if (MODE == kFused && k == 3) {
      v = read_or_zero(pv, (long long)y + cmd[2], (long long)x + cmd[1], a.Y,
                       a.X);
    } else if (k > 0 && in_rect) {
      if (MODE == kGeneral && ((k - 1) & 2)) {
        // int32 wrap, then clip: jnp's yy + my and jnp.clip
        int sy = (int)((unsigned)y + (unsigned)cmd[2]);
        int sx = (int)((unsigned)x + (unsigned)cmd[1]);
        sy = sy < 0 ? 0 : (sy > a.Y - 1 ? a.Y - 1 : sy);
        sx = sx < 0 ? 0 : (sx > a.X - 1 ? a.X - 1 : sx);
        v = pv[(long long)sy * a.X + sx];
      } else {
        v = a.pix[b * a.pix_bs + p];
      }
    } else {
      v = pv[p];
    }
  }
  a.out[b * a.out_bs + p] = v;
}

template <int MODE>
int launch(const Args& a, int B, void* stream) {
  if (B <= 0 || a.Y <= 0 || a.X <= 0) return 0;
  const int nby = (a.Y + 15) / 16;
  dim3 grid((unsigned)a.nbx, (unsigned)nby, (unsigned)B);
  sp_motion_kernel<MODE><<<grid, 256, 0, (cudaStream_t)stream>>>(a);
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
