// bc compose: one P-frame step of the ScreenPressor bc scan, for all B
// streams of a batch in one launch.
//
// Replaces jsplayer_tpu/kernels/sp_recon.py: compose_frame_bc (an XLA step:
// a packed [nby, X] row map of the block codes and rects, its 16x row
// expansion, then K jnp.roll + where passes) together with the
// where(changed, composed, prev) of decode_sequence_bc.  The transport:
// bcode [NB] u8 (0 copy, 1 data, 2+k motion slot k), rloc [NB, 4] u8
// block-local rects (x0, y0, x1, y1), mvk [K, 2] (mx, my), and a u32 plane
// that holds ONLY the data-rect pixels: its other bytes are undefined (the
// native decoder never writes them) and this kernel never reads them.  Per
// pixel (y, x) of stream b, with its block's code c and rect, in_rect the
// test x & 15 in [x0, x1) and y & 15 in [y0, y1):
//
//   c == 1, in_rect               -> plane[y, x] & 0xFFFFFF
//   c == 2+k, k < K, in_rect      -> prev[(y+my_k) mod Y, (x+mx_k) mod X]
//   otherwise                     -> prev[y, x]
//   changed[b] == 0               -> prev[y, x] for every pixel
//
// The pixel rule is compose_frame_kmv's (csrc/kmv_compose.cu), with the
// per-pixel type and slot replaced by the block's code and rect.  The
// modulo is a true one (jnp.roll wraps); the reference negates a vector in
// int32 before its roll, so mx = -2^31 rolls by -2^31 and moves the source
// by +2^31, which roll_offset reproduces.  `out` must not alias `prev`.
//
// What bounds it: bytes.  Every pixel reads one source word (the plane in
// a data rect, prev elsewhere: moved or in place; an unchanged stream reads
// prev) and writes out: 8 bytes a pixel, plus 5 bytes of bcode and rloc a
// block.  For a B=4 1080p step that is 66.36 MB + 0.16 MB = 66.5 MB, 0.0199
// ms at 3.35 TB/s.  The design is kmv_compose.cu's, so the kmv indexing
// carries over:
//
//   * a 3-D grid: blockIdx.z is the stream, blockIdx.y a band of 16 rows,
//     blockIdx.x 128 columns; each thread covers 2 rows x 4 consecutive
//     pixels, which lie inside one 16x16 block, so a thread loads its
//     block's code once and its rect once, as one 32-bit word, and never
//     builds the row map;
//   * the rect's column test is made once a thread (a 4-bit mask) and its
//     row test once a row, so each row of 4 pixels knows which pixels take
//     the plane (or a moved prev) and which keep prev;
//   * 16-byte loads and stores where X % 4 == 0 and the rows are 16-byte
//     aligned (the kVec instance): a row of 4 pixels that all keep prev is
//     one load of prev, one that lies wholly in a data rect one load of the
//     plane, one that moves by a multiple of 4 columns one load of the
//     moved prev; a row the rect splits loads each pixel from its own
//     source, so no plane byte outside a rect is touched;
//   * changed, the block's code and its rect are loaded together, so a
//     thread waits two round trips before its pixel loads (three for a
//     motion block, whose vector slot needs the code); an unchanged stream
//     is then a straight copy of prev.  Loading the rect only after
//     changed, or the vectors into shared memory behind a barrier, both
//     measured slower (experiments/bc_step.py, PERF.md);
//   * the plane is read once, so it is loaded evict-first (__ldcs); prev
//     stays in L2 for the moved reads.
//
// The lane instance (kLane, entry point jsp_lane_compose) is the step of
// jsplayer_tpu/kernels/lane_recon.py: compose_frame_lane with the
// where(changed, composed, prev) of its _scan_frames.  Its data pixels come
// from the window's unique rows instead of a plane: a code-1 pixel inside
// its rect takes rows[row_idx[y], x], the word as it is (no 0xFFFFFF mask,
// as the reference's take is unmasked).  row_idx[y] in [-Ur, -1] wraps to
// Ur + row_idx[y]; any other index outside [0, Ur) reads 0xFFFFFFFF
// (jnp.take's fill).  rows may be the [:, :X] view of wider rows: it has a
// row stride of its own.  The per-thread change is one row_idx load a row
// that holds data pixels, then the row's words from that row (one 16-byte
// load where the row stride keeps 16-byte alignment), loaded through the
// read-only cache: every frame of a window gathers from the same rows.
// The bound is bc's: 8 bytes a pixel, plus the commands and row_idx (4
// bytes a row) of each changed stream.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // threads a block
constexpr int kPx = 4;            // consecutive pixels of a row a thread covers
constexpr int kRows = 2;          // rows a thread covers

// The source offset d of the reference's roll by -v over n (the source of
// index i is (i + d) mod n), 0 <= d < n; -v is taken in int32, so
// v = INT_MIN stays INT_MIN and moves the source by +2^31.
__device__ __forceinline__ int roll_offset(int v, int n) {
  if (v == INT_MIN) return (int)(2147483648u % (unsigned)n);
  const int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ void put4(int32_t* v, int4 a) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// kLane: `plane` is the rows [Ur, X] of row stride ru_rs, read through
// row_idx (batch stride ri_bs); otherwise ru_rs, Ur and row_idx are unused.
template <bool kVec, bool kLane>
__global__ void __launch_bounds__(kTx * kTy) bc_compose_kernel(
    const int32_t* __restrict__ prev, long long prev_bs,
    const int32_t* __restrict__ plane, long long pl_bs,
    const int32_t* __restrict__ mvk, long long mvk_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int32_t* __restrict__ out, long long out_bs,
    const uint8_t* __restrict__ bcode, long long bc_bs,
    const uint8_t* __restrict__ rloc, long long rl_bs, bool rloc_word,
    int Y, int X, int nbx, int K, long long ru_rs, int Ur,
    const int32_t* __restrict__ row_idx, long long ri_bs) {
  const int b = blockIdx.z;
  const int x0 = (blockIdx.x * kTx + threadIdx.x) * kPx;
  const int y0 = (blockIdx.y * kTy + threadIdx.y) * kRows;
  if (x0 >= X || y0 >= Y) return;
  const int32_t* pv = prev + b * prev_bs;
  const int32_t* pl = plane + b * pl_bs;
  int32_t* ob = out + b * out_bs;
  const int nr = min(kRows, Y - y0);
  // the pixels of a row that lie in the frame
  const unsigned valid = kVec ? 0xFu : 0xFu >> (kPx - min(kPx, X - x0));

  // the block's command: mode 0 copy, 1 data, 2 motion by (dx, dy)
  // changed, the code and the rect are loaded together (none waits for
  // another); the vector's slot is loaded once the code is known
  int mode = 0, ry0 = 0, ry1 = 0, dx = 0, dy = 0;
  unsigned cols = 0;
  const bool chg = changed[b * chg_bs] != 0;
  const long long bi = (long long)(y0 >> 4) * nbx + (x0 >> 4);
  const int code = __ldg(bcode + b * bc_bs + bi);
  const uint8_t* rp = rloc + b * rl_bs + 4 * bi;
  const uint32_t rw = rloc_word
      ? __ldg((const uint32_t*)rp)
      : (uint32_t)rp[0] | (uint32_t)rp[1] << 8 | (uint32_t)rp[2] << 16 |
            (uint32_t)rp[3] << 24;
  if (chg) {
    if (code == 1 || (code >= 2 && code - 2 < K)) {
      const int rx0 = rw & 0xFF, rx1 = (rw >> 16) & 0xFF;
      ry0 = (rw >> 8) & 0xFF;
      ry1 = rw >> 24;
      const int lx = x0 & 15;
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        if (lx + j >= rx0 && lx + j < rx1) cols |= 1u << j;
      cols &= valid;
      mode = code == 1 ? 1 : 2;
      if (mode == 2) {
        const int32_t* mk = mvk + b * mvk_bs + 2 * (code - 2);
        dx = roll_offset(mk[0], X);
        dy = roll_offset(mk[1], Y);
      }
    }
  }

  int32_t v[kRows][kPx] = {};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    const int y = y0 + r;
    const long long i = (long long)y * X + x0;
    const int ly = y & 15;
    const unsigned m = (mode && ly >= ry0 && ly < ry1) ? cols : 0u;
    const unsigned keep = valid & ~m;  // pixels that keep prev[y, x]
    if (kVec && keep == 0xFu) {
      put4(v[r], __ldg((const int4*)(pv + i)));
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        if (keep >> j & 1u) v[r][j] = __ldg(pv + i + j);
    }
    if (!m) continue;
    if (kLane && mode == 1) {
      int ri = __ldg(row_idx + b * ri_bs + y);
      if (ri < 0) ri += Ur;
      if ((unsigned)ri >= (unsigned)Ur) {  // jnp.take's fill
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (m >> j & 1u) v[r][j] = -1;
        continue;
      }
      const int32_t* src = pl + ri * ru_rs + x0;
      if (kVec && m == 0xFu) {
        put4(v[r], __ldg((const int4*)src));
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (m >> j & 1u) v[r][j] = __ldg(src + j);
      }
    } else if (mode == 1) {
      if (kVec && m == 0xFu) {
        put4(v[r], __ldcs((const int4*)(pl + i)));
#pragma unroll
        for (int j = 0; j < kPx; ++j) v[r][j] &= 0x00FFFFFF;
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (m >> j & 1u) v[r][j] = __ldcs(pl + i + j) & 0x00FFFFFF;
      }
    } else {
      int sy = y + dy;
      if (sy >= Y) sy -= Y;
      const int32_t* src = pv + (long long)sy * X;
      int sx = x0 + dx;
      if (sx >= X) sx -= X;
      // X % 4 == 0 and dx % 4 == 0: sx is a multiple of 4 and sx + 3 < X
      if (kVec && m == 0xFu && (dx & 3) == 0) {
        put4(v[r], __ldg((const int4*)(src + sx)));
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
          if (!(m >> j & 1u)) continue;
          int s = sx + j;
          if (s >= X) s -= X;
          v[r][j] = __ldg(src + s);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    const long long i = (long long)(y0 + r) * X + x0;
    if (kVec) {
      *(int4*)(ob + i) = make_int4(v[r][0], v[r][1], v[r][2], v[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        if (valid >> j & 1u) ob[i + j] = v[r][j];
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

// bcode: [B, NB] u8, rloc: [B, NB, 4] u8, each with batch stride *_bs and
// contiguous rows; the other arguments as jsp_kmv_compose's.
extern "C" int jsp_bc_compose(
    const void* prev, long long prev_bs, const void* plane, long long pl_bs,
    const void* mvk, long long mvk_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, const void* bcode, long long bc_bs,
    const void* rloc, long long rl_bs, int B, int Y, int X, int K,
    void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K < 0) K = 0;
  const bool vec = X % kPx == 0 && aligned(prev, 16) && aligned(plane, 16) &&
                   aligned(out, 16) && prev_bs % kPx == 0 &&
                   pl_bs % kPx == 0 && out_bs % kPx == 0;
  const bool rloc_word = aligned(rloc, 4) && rl_bs % 4 == 0;
  const int nbx = (X + 15) / 16;
  const dim3 block(kTx, kTy);
  const unsigned gx = ((X + kPx - 1) / kPx + kTx - 1) / kTx;
  const unsigned gy = ((Y + kRows - 1) / kRows + kTy - 1) / kTy;
  auto kernel = vec ? bc_compose_kernel<true, false>
                    : bc_compose_kernel<false, false>;
  // B > 65535 streams exceeds gridDim.z: the launch fails and is reported
  kernel<<<dim3(gx, gy, B), block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)prev, prev_bs, (const int32_t*)plane, pl_bs,
      (const int32_t*)mvk, mvk_bs, (const uint8_t*)changed, chg_bs,
      (int32_t*)out, out_bs, (const uint8_t*)bcode, bc_bs,
      (const uint8_t*)rloc, rl_bs, rloc_word, Y, X, nbx, K, 0, 0, nullptr, 0);
  return (int)cudaGetLastError();
}

// rows: [B, Ur, X] int32 with batch stride ru_bs and row stride ru_rs
// (elements; each row's X words contiguous), Ur >= 1; row_idx: [B, Y] int32
// with batch stride ri_bs and contiguous rows; the other arguments as
// jsp_bc_compose's.
extern "C" int jsp_lane_compose(
    const void* prev, long long prev_bs, const void* rows, long long ru_bs,
    long long ru_rs, int Ur, const void* row_idx, long long ri_bs,
    const void* mvk, long long mvk_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, const void* bcode, long long bc_bs,
    const void* rloc, long long rl_bs, int B, int Y, int X, int K,
    void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K < 0) K = 0;
  const bool vec = X % kPx == 0 && aligned(prev, 16) && aligned(rows, 16) &&
                   aligned(out, 16) && prev_bs % kPx == 0 &&
                   ru_bs % kPx == 0 && ru_rs % kPx == 0 && out_bs % kPx == 0;
  const bool rloc_word = aligned(rloc, 4) && rl_bs % 4 == 0;
  const int nbx = (X + 15) / 16;
  const dim3 block(kTx, kTy);
  const unsigned gx = ((X + kPx - 1) / kPx + kTx - 1) / kTx;
  const unsigned gy = ((Y + kRows - 1) / kRows + kTy - 1) / kTy;
  auto kernel = vec ? bc_compose_kernel<true, true>
                    : bc_compose_kernel<false, true>;
  kernel<<<dim3(gx, gy, B), block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)prev, prev_bs, (const int32_t*)rows, ru_bs,
      (const int32_t*)mvk, mvk_bs, (const uint8_t*)changed, chg_bs,
      (int32_t*)out, out_bs, (const uint8_t*)bcode, bc_bs,
      (const uint8_t*)rloc, rl_bs, rloc_word, Y, X, nbx, K, ru_rs, Ur,
      (const int32_t*)row_idx, ri_bs);
  return (int)cudaGetLastError();
}
