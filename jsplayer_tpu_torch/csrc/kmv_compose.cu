// kmv compose: one P-frame step of the ScreenPressor kmv scan, for all B
// streams of a batch in one launch.
//
// Replaces jsplayer_tpu/kernels/sp_recon.py: compose_frame_kmv (an XLA
// step of K jnp.roll + where passes) together with the
// where(changed, composed, prev) of _scan_decode_kmv.  Per pixel of stream b:
//
//   ptype = (paycode >> 24) & 3, kslot = (paycode >> 26) & 7
//   ptype == 1              -> paycode & 0xFFFFFF          (data pixel)
//   ptype == 2, kslot < K   -> prev[(y+my_k) mod Y, (x+mx_k) mod X]
//   otherwise               -> prev[y, x]
//   changed[b] == 0         -> prev[y, x] for every pixel
//
// The modulo is a true one (jnp.roll wraps, it does not clip), so negative
// vectors and vectors of |mv| >= Y or X, which corrupt streams can carry,
// land where the reference puts them.  `out` must not alias `prev`: shifted
// reads would see pixels already written.
//
// What bounds it: bytes.  A changed stream reads paycode and prev and
// writes out, 12 bytes a pixel (an unchanged stream 8): 99.5 MB for a B=4
// 1080p step, 0.030 ms at 3.35 TB/s.  Motion pixels add one shifted read of
// prev, mostly from L2.  The design keeps many independent 16-byte accesses
// in flight and does no division per pixel:
//
//   * a 3-D grid: blockIdx.z is the stream, blockIdx.y a band of 16 rows,
//     blockIdx.x 128 columns; each thread covers 2 rows x 4 consecutive
//     pixels, so y and x come from the indices;
//   * 16-byte loads of paycode and prev and 16-byte stores of out where
//     X % 4 == 0 and every row start is 16-byte aligned (the kVec
//     instance; a paycode[:, t] view of a [B, T, Y, X] window qualifies);
//     otherwise the same indexing with 4-byte accesses, masked at the row
//     end;
//   * each slot's shift is reduced once per block, in shared memory, to
//     0 <= s < Y (or X) in 32 bits; a pixel wraps it with one
//     compare-and-subtract;
//   * data and copy pixels come from the vectors already loaded; only a
//     motion pixel issues a scalar read of the shifted prev;
//   * an unchanged stream is a straight copy that never reads paycode;
//   * paycode is read once, so it is loaded evict-first (__ldcs) and prev
//     stays in L2 for the shifted reads; out, the next step's prev, is
//     stored with the default policy.
//
// kmv_compose_ds2 (the kDs2 instance) also replaces the Pallas _ds_kernel
// of scripts/exp_model_fusion2.py:34, which ran the packed 2x2 downsample
// inside the scan step (its variant E1).  On Hopper the honest form of that
// is one launch that composes the frame and emits its ds2 plane.  It uses
// the same indexing and the same compose rule; a thread's 2 x 4 pixels are
// two 2x2 quads, whose packed field sums
//
//   red = sum(c & 0xFF) | sum((c >> 8) & 0xFF) << 10 | sum((c >> 16) & 0xFF) << 20
//
// (csrc/ds2_pack.cu's plane, unflipped) it stores as one 8-byte store on
// the vector path.  An odd last row or column is composed and gets no ds2
// word (reduce_window VALID).  The sum needs no second read of the frame:
// the pixels are still in registers.
//
// kmv_compose_frames (kmv_frames_kernel) composes U frames of ONE stream in
// one launch, frame u from frame u-1's output: the U-compose body of
// jsplayer_tpu/kernels/sp_recon.py decode_sequence_kmv_compact_unrolled
// (:639-646), a scan step that ran U composes so that the intermediate
// frames stay near the core.  On Hopper the launch is cooperative and
// persistent: a grid of as many 256-thread blocks as can be resident at
// once (the occupancy x the SM count, at most one a tile) walks the frame's
// tiles of 16 rows x 128 columns with the per-thread design above, then
// waits at a grid barrier (cooperative_groups' grid.sync(), which also
// orders the memory) before the next frame, whose prev is the frame just
// written, read back from the 50 MB L2.  A grid that cannot be co-resident
// makes the launch fail (cudaErrorCooperativeLaunchTooLarge), which the
// wrapper raises; it never falls back to U launches.  prev is read with
// coherent L2 loads (__ldcg), not through the read-only path (__ldg): frame
// u-1's pixels were written by this same launch, and a non-coherent read
// could return stale ones.  out must not alias prev or paycode.  What bounds
// it: bytes, as for one frame a launch, less the launches' gaps.
#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 8;      // kslot is a 3-bit field
constexpr int kTx = 32, kTy = 8;  // threads a block
constexpr int kPx = 4;            // consecutive pixels of a row a thread covers
constexpr int kRows = 2;          // rows a thread covers

// v mod n in [0, n) for any int32 v, n > 0.
__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// The compose rule for the pixel (y, x) of a changed stream: w its paycode
// word, p prev[y, x], pv the stream's prev plane, s_sx/s_sy the slots'
// reduced shifts.  Every instance composes through it; kCoherent reads the
// shifted prev through L2 (__ldcg) instead of the read-only path.
template <bool kCoherent = false>
__device__ __forceinline__ int32_t compose_px(
    uint32_t w, int32_t p, const int32_t* __restrict__ pv, int y, int x,
    const int* s_sx, const int* s_sy, int Y, int X, int K) {
  const uint32_t ptype = (w >> 24) & 3u;
  if (ptype == 1u) return (int32_t)(w & 0x00FFFFFFu);
  const int k = (int)((w >> 26) & 7u);
  if (ptype != 2u || k >= K) return p;
  int sy = y + s_sy[k];
  if (sy >= Y) sy -= Y;
  int sx = x + s_sx[k];
  if (sx >= X) sx -= X;
  const int32_t* q = pv + (long long)sy * X + sx;
  return kCoherent ? __ldcg(q) : __ldg(q);
}

__device__ __forceinline__ uint32_t fields(uint32_t c) {
  return (c & 0xFFu) | (((c >> 8) & 0xFFu) << 10) | (((c >> 16) & 0xFFu) << 20);
}

// kVec: 16-byte accesses (X % 4 == 0, 16-byte aligned rows; with kDs2 also
// 8-byte aligned ds2 rows).  kDs2: also write red[b, y/2, x/2] for every
// complete 2x2 quad.
template <bool kDs2, bool kVec>
__global__ void __launch_bounds__(kTx * kTy) kmv_compose_kernel(
    const int32_t* __restrict__ prev, long long prev_bs,
    const int32_t* __restrict__ paycode, long long pc_bs,
    const int32_t* __restrict__ mvk, long long mvk_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int32_t* __restrict__ out, long long out_bs,
    int32_t* __restrict__ red, long long red_bs,
    int Y, int X, int K) {
  __shared__ int s_sx[kMaxSlots];
  __shared__ int s_sy[kMaxSlots];
  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  if (tid < K) {
    s_sx[tid] = wrap(mvk[b * mvk_bs + 2 * tid], X);
    s_sy[tid] = wrap(mvk[b * mvk_bs + 2 * tid + 1], Y);
  }
  __syncthreads();
  const int x0 = (blockIdx.x * kTx + threadIdx.x) * kPx;
  const int y0 = (blockIdx.y * kTy + threadIdx.y) * kRows;
  if (x0 >= X || y0 >= Y) return;
  const bool chg = changed[b * chg_bs] != 0;
  const int32_t* pv = prev + b * prev_bs;
  const int32_t* pc = paycode + b * pc_bs;
  int32_t* ob = out + b * out_bs;
  const int nr = min(kRows, Y - y0);

  // every row's loads are issued before any pixel is composed
  int32_t p[kRows][kPx];
  uint32_t w[kRows][kPx];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = (long long)(y0 + r) * X + x0;
    if (kVec) {
      int4 a = make_int4(0, 0, 0, 0), c = make_int4(0, 0, 0, 0);
      if (r < nr) {
        a = __ldg((const int4*)(pv + i));
        if (chg) c = __ldcs((const int4*)(pc + i));
      }
      p[r][0] = a.x; p[r][1] = a.y; p[r][2] = a.z; p[r][3] = a.w;
      w[r][0] = c.x; w[r][1] = c.y; w[r][2] = c.z; w[r][3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const bool in = r < nr && x0 + j < X;
        p[r][j] = in ? pv[i + j] : 0;
        w[r][j] = in && chg ? (uint32_t)__ldcs(pc + i + j) : 0u;
      }
    }
  }

  // an unchanged stream has w == 0 (ptype 0): every pixel copies prev
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nr) {
      const long long i = (long long)(y0 + r) * X + x0;
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        p[r][j] = compose_px(w[r][j], p[r][j], pv, y0 + r, x0 + j, s_sx,
                             s_sy, Y, X, K);
      if (kVec) {
        *(int4*)(ob + i) = make_int4(p[r][0], p[r][1], p[r][2], p[r][3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (x0 + j < X) ob[i + j] = p[r][j];
      }
    }
  }

  if (kDs2 && nr == kRows) {
    int32_t q[kPx / 2];
#pragma unroll
    for (int h = 0; h < kPx / 2; ++h)
      q[h] = (int32_t)(fields(p[0][2 * h]) + fields(p[0][2 * h + 1]) +
                       fields(p[1][2 * h]) + fields(p[1][2 * h + 1]));
    int32_t* rq = red + b * red_bs + (long long)(y0 / 2) * (X / 2) + x0 / 2;
    if (kVec) {
      *(int2*)rq = make_int2(q[0], q[1]);
    } else {
#pragma unroll
      for (int h = 0; h < kPx / 2; ++h)
        if (x0 + 2 * h + 1 < X) rq[h] = q[h];
    }
  }
}

// The frames instance: U frames of one stream, frame u composed from
// frame u-1's out (prev for u = 0); paycode [U, Y, X] and out [U, Y, X]
// with frame strides pc_us and out_us, mvk [U, K, 2] with stride mvk_us.
// A block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the gx x
// gy tiles of a frame; the grid meets at a barrier between frames.
template <bool kVec>
__global__ void __launch_bounds__(kTx * kTy) kmv_frames_kernel(
    const int32_t* prev, const int32_t* __restrict__ paycode, long long pc_us,
    const int32_t* __restrict__ mvk, long long mvk_us, int32_t* out,
    long long out_us, int U, int Y, int X, int K, int gx, int tiles) {
  __shared__ int s_sx[kMaxSlots];
  __shared__ int s_sy[kMaxSlots];
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int u = 0; u < U; ++u) {
    const int32_t* pv = u == 0 ? prev : out + (u - 1) * out_us;
    const int32_t* pc = paycode + u * pc_us;
    int32_t* ob = out + u * out_us;
    if (tid < K) {
      s_sx[tid] = wrap(mvk[u * mvk_us + 2 * tid], X);
      s_sy[tid] = wrap(mvk[u * mvk_us + 2 * tid + 1], Y);
    }
    __syncthreads();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int x0 = ((tile % gx) * kTx + threadIdx.x) * kPx;
      const int y0 = ((tile / gx) * kTy + threadIdx.y) * kRows;
      if (x0 >= X || y0 >= Y) continue;
      const int nr = min(kRows, Y - y0);
      int32_t p[kRows][kPx];
      uint32_t w[kRows][kPx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long i = (long long)(y0 + r) * X + x0;
        if (kVec) {
          int4 a = make_int4(0, 0, 0, 0), c = make_int4(0, 0, 0, 0);
          if (r < nr) {
            a = __ldcg((const int4*)(pv + i));
            c = __ldcs((const int4*)(pc + i));
          }
          p[r][0] = a.x; p[r][1] = a.y; p[r][2] = a.z; p[r][3] = a.w;
          w[r][0] = c.x; w[r][1] = c.y; w[r][2] = c.z; w[r][3] = c.w;
        } else {
#pragma unroll
          for (int j = 0; j < kPx; ++j) {
            const bool in = r < nr && x0 + j < X;
            p[r][j] = in ? __ldcg(pv + i + j) : 0;
            w[r][j] = in ? (uint32_t)__ldcs(pc + i + j) : 0u;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const long long i = (long long)(y0 + r) * X + x0;
#pragma unroll
          for (int j = 0; j < kPx; ++j)
            p[r][j] = compose_px<true>(w[r][j], p[r][j], pv, y0 + r, x0 + j,
                                       s_sx, s_sy, Y, X, K);
          if (kVec) {
            *(int4*)(ob + i) = make_int4(p[r][0], p[r][1], p[r][2], p[r][3]);
          } else {
#pragma unroll
            for (int j = 0; j < kPx; ++j)
              if (x0 + j < X) ob[i + j] = p[r][j];
          }
        }
      }
    }
    // frame u is written everywhere before any block reads it as prev;
    // the barrier also keeps the slot shifts until every block is done
    if (u + 1 < U) cooperative_groups::this_grid().sync();
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

// The frames instance's kernel for the layout, and the largest grid of it
// that can be co-resident on the current device (0 on an error).
void* frames_kernel(bool vec) {
  return vec ? (void*)kmv_frames_kernel<true>
             : (void*)kmv_frames_kernel<false>;
}

// Asked once a device and layout, then kept: the answer depends only on
// the compiled kernel and the card, and asking costs host time every call.
constexpr int kMaxDevices = 64;
std::atomic<int> resident_cache[kMaxDevices][2];

int resident_blocks(bool vec) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int kept = resident_cache[dev][vec].load(std::memory_order_relaxed);
    if (kept > 0) return kept;
  }
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, frames_kernel(vec), kTx * kTy, 0) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices)
    resident_cache[dev][vec].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

template <bool kDs2>
int launch(const void* prev, long long prev_bs, const void* paycode,
           long long pc_bs, const void* mvk, long long mvk_bs,
           const void* changed, long long chg_bs, void* out, long long out_bs,
           void* red, long long red_bs, int B, int Y, int X, int K,
           void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K > kMaxSlots) K = kMaxSlots;  // slots >= 8 are unreachable
  const bool vec = X % kPx == 0 && aligned(prev, 16) &&
                   aligned(paycode, 16) && aligned(out, 16) &&
                   prev_bs % kPx == 0 && pc_bs % kPx == 0 &&
                   out_bs % kPx == 0 &&
                   (!kDs2 || (aligned(red, 8) && red_bs % 2 == 0));
  const dim3 block(kTx, kTy);
  const unsigned gx = ((X + kPx - 1) / kPx + kTx - 1) / kTx;
  const unsigned gy = ((Y + kRows - 1) / kRows + kTy - 1) / kTy;
  auto kernel = vec ? kmv_compose_kernel<kDs2, true>
                    : kmv_compose_kernel<kDs2, false>;
  // B > 65535 streams exceeds gridDim.z: the launch fails and is reported
  kernel<<<dim3(gx, gy, B), block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)prev, prev_bs, (const int32_t*)paycode, pc_bs,
      (const int32_t*)mvk, mvk_bs, (const uint8_t*)changed, chg_bs,
      (int32_t*)out, out_bs, (int32_t*)red, red_bs, Y, X, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jsp_kmv_compose(
    const void* prev, long long prev_bs, const void* paycode, long long pc_bs,
    const void* mvk, long long mvk_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, int B, int Y, int X, int K, void* stream) {
  return launch<false>(prev, prev_bs, paycode, pc_bs, mvk, mvk_bs, changed,
                       chg_bs, out, out_bs, nullptr, 0, B, Y, X, K, stream);
}

// red: [B, Y/2, X/2] int32 with batch stride red_bs, rows contiguous.
extern "C" int jsp_kmv_compose_ds2(
    const void* prev, long long prev_bs, const void* paycode, long long pc_bs,
    const void* mvk, long long mvk_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, void* red, long long red_bs, int B, int Y,
    int X, int K, void* stream) {
  return launch<true>(prev, prev_bs, paycode, pc_bs, mvk, mvk_bs, changed,
                      chg_bs, out, out_bs, red, red_bs, B, Y, X, K, stream);
}

// kmv_compose_frames: prev [Y, X] (rows contiguous), paycode [U, Y, X] and
// out [U, Y, X] with frame strides pc_us, out_us, mvk [U, K, 2] with frame
// stride mvk_us.  grid <= 0 sizes the grid to the resident blocks (at most
// one a tile); grid > 0 asks for that many blocks, and a grid that cannot be
// co-resident fails the launch.  *grid_used gets the grid launched.
extern "C" int jsp_kmv_compose_frames(
    const void* prev, const void* paycode, long long pc_us, const void* mvk,
    long long mvk_us, void* out, long long out_us, int U, int Y, int X, int K,
    int grid, int* grid_used, void* stream) {
  *grid_used = 0;
  if (U <= 0 || Y <= 0 || X <= 0) return 0;
  if (K > kMaxSlots) K = kMaxSlots;  // slots >= 8 are unreachable
  const bool vec = X % kPx == 0 && aligned(prev, 16) &&
                   aligned(paycode, 16) && aligned(out, 16) &&
                   pc_us % kPx == 0 && out_us % kPx == 0;
  int gx = ((X + kPx - 1) / kPx + kTx - 1) / kTx;
  int gy = ((Y + kRows - 1) / kRows + kTy - 1) / kTy;
  int tiles = gx * gy;
  if (grid <= 0) {
    const int resident = resident_blocks(vec);
    if (resident <= 0) return (int)cudaErrorLaunchOutOfResources;
    grid = resident < tiles ? resident : tiles;
  }
  void* args[] = {&prev, &paycode, &pc_us, &mvk, &mvk_us, &out, &out_us,
                  &U, &Y, &X, &K, &gx, &tiles};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      frames_kernel(vec), dim3(grid), dim3(kTx, kTy), args, 0,
      (cudaStream_t)stream);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // the refused launch leaves no sticky error
    return (int)rc;
  }
  *grid_used = grid;
  return (int)cudaGetLastError();
}

extern "C" const char* jsp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
