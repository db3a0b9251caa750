// kmv_sparse compose: one P-frame step of the ScreenPressor kmv_sparse scan,
// for all B streams of a batch in one call.
//
// Replaces jsplayer_tpu/kernels/sp_recon.py: compose_frame_kmv_sparse (an
// XLA step: the block-code map, K jnp.roll + where passes, then a lax.scan
// of M dynamic_update_slice tile writes) with the where(changed, composed,
// prev) of _scan_decode_kmv_sparse, and the ragged jnp.take of the tiles in
// decode_batch_kmv_sparse_ragged.  The transport: bcode [NB] u8 per 16x16
// block (2+k, k < K: the whole block moves by mvk[k]; any other code keeps
// prev), mvk [K, 2] (mx, my), and M tiles of 256 words, tile m read from
// row tile_idx[m] of one flat [S, 256] array and written at tile_yx[m] =
// (y0, x0), each start placed as dynamic_update_slice places it: a negative
// start counts from the end (+Y or +X), then it is clamped into [0, Y-16] x
// [0, X-16].  Per pixel (y, x) of stream b:
//
//   owner = the largest m whose placed 16x16 window covers (y, x)
//   owner exists     -> tile word at (y - y0_m, x - x0_m) of row
//                       tile_idx[m] (an index in [-S, -1] wraps, any other
//                       outside [0, S) reads 0xFFFFFFFF, as jnp.take)
//   code == 2+k, k<K -> prev[(y+my_k) mod Y, (x+mx_k) mod X]
//   otherwise        -> prev[y, x]
//   changed[b] == 0  -> prev[y, x] for every pixel
//
// The roll is the reference's: -v is taken in int32 before the roll, so
// v = -2^31 moves the source by +2^31 (roll_offset).  Tile words are written
// as they are (no 0xFFFFFF mask).  `out` must not alias `prev`.
//
// What bounds it: bytes.  Every pixel reads one source word (its owning
// tile's, a moved prev, or prev in place) and writes out: 8 bytes a pixel,
// plus each changed stream's bcode (1 byte a block), tile_idx and tile_yx
// (12 bytes a tile).  For a B=4 1080p step that is 66.36 MB + the commands,
// about 0.0199 ms at 3.35 TB/s.
//
// Design.  "A later tile wins" over any tile_yx (duplicates, overlapping
// clamped edge tiles, off-grid starts) is settled per 16x16 block cell of
// the frame, not per pixel:
//
//   * each cell's header (`top`, `full`, the count of its partial tiles
//     less one) is -1 when a call starts: the wrapper keeps the scratch
//     per device and fills it once, and every compose puts back the headers
//     it read (below), so no fill runs a call;
//   * the owner pass, one thread a (stream, tile), places the tile's start
//     and, for each of the (at most 2x2) cells its window touches, takes
//     atomicMax(top, m); atomicMax(full, m) where the window covers the
//     cell's whole in-frame part, else it appends m to the cell's list of
//     kList partial tiles (atomicAdd on the count; past kList the list
//     overflows);
//   * the compose pass: a 3-D grid (stream, band of 16 rows, 128 columns),
//     a warp a 16x16 cell, 2 rows x 4 consecutive pixels a lane; 16-byte
//     loads and stores where X % 4 == 0 and the rows are 16-byte aligned.
//     It is launched as the owner pass's programmatic dependent: a lane
//     loads changed, its block's code and, speculatively, its two rows of
//     prev in place while the owner pass runs (a pixel that keeps prev,
//     most of a screen frame, then waits on nothing more), and only then
//     waits for the owner pass (griddepcontrol.wait).  Lane 0 takes the
//     cell's header by atomicExch, leaving -1 for the next call, and
//     shuffles it to the warp: it is the header's only reader, so no
//     barrier is needed.  On an H100, a B=4 1080p step: a block barrier
//     before the reset measured ~8 us slower, a plain load and store of
//     the header by lane 0 ~25 us slower (PERF.md).
//     top == full: the cell's every pixel belongs to tile `full` (or to no
//     tile, -1) and a row of 4 pixels is one 16-byte load of the tile row
//     where the start keeps the alignment.
//     top > full (an off-grid or clamped tile covers part of the cell after
//     the last tile that covers all of it: on the host's layouts, the
//     bottom row's clamped tiles where Y % 16 != 0): each pixel takes the
//     largest listed tile past `full` whose window covers it, else `full`;
//     a cell whose list overflowed (more than kList partial tiles, which no
//     host layout makes) walks m from top down to full + 1 instead;
//   * pixels a tile owns take the tile's word, through the read-only cache
//     (a window's pad rows repeat one row).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // the compose's block: kTy warps, cells
constexpr int kMinBlocks = 5;     // compose blocks an SM holds
constexpr int kPx = 4;            // consecutive pixels of a row a thread covers
constexpr int kRows = 2;          // rows a thread covers
constexpr int kOwnerThreads = 256;
constexpr int kList = 4;   // partial tiles a cell lists before it overflows
constexpr int kCell = 8;   // ints a cell: top, full, count, -, list[kList]

// The source offset d of the reference's roll by -v over n (the source of
// index i is (i + d) mod n), 0 <= d < n; -v is taken in int32, so
// v = INT_MIN stays INT_MIN and moves the source by +2^31.
__device__ __forceinline__ int roll_offset(int v, int n) {
  if (v == INT_MIN) return (int)(2147483648u % (unsigned)n);
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Where dynamic_update_slice puts a 16-wide update starting at v along an
// axis of n: a negative start counts from the end (v + n; its
// allow_negative_indices default), then it is clamped into [0, n - 16].
__device__ __forceinline__ int tile_start(int v, int n) {
  if (v < 0) v += n;
  return v < 0 ? 0 : (v > n - 16 ? n - 16 : v);
}

__device__ __forceinline__ void put4(int32_t* v, int4 a) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// cells: [B][NB][kCell] ints (top, full, count - 1, unused, list[kList]),
// headers -1 when the pass starts.
__global__ void __launch_bounds__(kOwnerThreads) sparse_owner_kernel(
    const int32_t* __restrict__ tile_yx, long long ty_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int* __restrict__ cells, int Y, int X, int nbx, int NB, int M) {
  // the compose may start now: it reads the cells only after its
  // griddepcontrol.wait, which waits for this whole grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.y;
  const int m = blockIdx.x * kOwnerThreads + threadIdx.x;
  if (m >= M || changed[b * chg_bs] == 0) return;
  const int32_t* yx = tile_yx + b * ty_bs + 2LL * m;
  const int y0 = tile_start(yx[0], Y), x0 = tile_start(yx[1], X);
  for (int cy = y0 >> 4; cy <= (y0 + 15) >> 4; ++cy) {
    const bool fy = y0 <= cy * 16 && y0 + 16 >= min(cy * 16 + 16, Y);
    for (int cx = x0 >> 4; cx <= (x0 + 15) >> 4; ++cx) {
      int* cell = cells + ((long long)b * NB + cy * nbx + cx) * kCell;
      atomicMax(cell, m);
      if (fy && x0 <= cx * 16 && x0 + 16 >= min(cx * 16 + 16, X)) {
        atomicMax(cell + 1, m);
      } else {
        const int slot = atomicAdd(cell + 2, 1) + 1;
        if (slot < kList) cell[4 + slot] = m;
      }
    }
  }
}

// Where tile m's row lies: its placed start and the flat row it reads
// (-1: jnp.take's fill).
struct TileRef {
  int y0, x0;
  long long row;
};

__device__ __forceinline__ TileRef tile_ref(
    const int32_t* ti, const int32_t* tyx, int m, long long S, int Y, int X) {
  TileRef t;
  t.y0 = tile_start(__ldg(tyx + 2 * m), Y);
  t.x0 = tile_start(__ldg(tyx + 2 * m + 1), X);
  long long r = __ldg(ti + m);
  if (r < 0) r += S;
  t.row = (r >= 0 && r < S) ? r : -1;
  return t;
}

template <bool kVec>
// kMinBlocks: at most 48 registers, 5 blocks (40 warps) an SM; 53 without
// it, 4 blocks, measured ~0.9 us slower a B=4 1080p step on an H100
__global__ void __launch_bounds__(kTx * kTy, kMinBlocks) kmv_sparse_kernel(
    const int32_t* __restrict__ prev, long long prev_bs,
    const int32_t* __restrict__ mvk, long long mvk_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int32_t* __restrict__ out, long long out_bs,
    const uint8_t* __restrict__ bcode, long long bc_bs,
    const int32_t* __restrict__ tiles, long long S, long long t_rs,
    bool tiles_vec, const int32_t* __restrict__ tile_idx, long long ti_bs,
    const int32_t* __restrict__ tile_yx, long long ty_bs,
    int* cells, int Y, int X, int nbx, int NB, int K) {
  // warp threadIdx.y is cell (blockIdx.x * kTy + threadIdx.y, blockIdx.y);
  // lane: 4 pixels of 2 rows, columns (lane & 3) * 4, rows (lane >> 2) * 2
  const int b = blockIdx.z, lane = threadIdx.x;
  const int x0 = (blockIdx.x * kTy + threadIdx.y) * 16 + (lane & 3) * kPx;
  const int y0 = blockIdx.y * 16 + (lane >> 2) * kRows;
  // lanes past the frame stay for the warp's shuffles; lane 0 holds the
  // cell's top-left pixel, so it is active where any lane is
  const bool active = x0 < X && y0 < Y;
  const int32_t* pv = prev + b * prev_bs;
  int32_t* ob = out + b * out_bs;
  const int32_t* ti = tile_idx + b * ti_bs;
  const int32_t* tyx = tile_yx + b * ty_bs;
  const int nr = min(kRows, Y - y0);
  const unsigned valid = kVec ? 0xFu : 0xFu >> (kPx - min(kPx, X - x0));

  // changed, the block's code and prev in place are loaded before the
  // wait for the owner pass; the vector's slot waits for the code
  const long long bi = (long long)(y0 >> 4) * nbx + (x0 >> 4);
  bool chg = false;
  int code = 0;
  int32_t v[kRows][kPx] = {};
  if (active) {
    chg = changed[b * chg_bs] != 0;
    code = __ldg(bcode + b * bc_bs + bi);
    if (kVec) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) put4(v[r], __ldg((const int4*)(pv + (long long)(y0 + r) *
                                                             X + x0)));
    }
  }
  int4 head = make_int4(-1, -1, -1, -1);
  int* cell = nullptr;
  if (cells != nullptr) {  // uniform: every lane reaches the shuffles
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    cell = cells + ((long long)b * NB + bi) * kCell;
    // lane 0 takes the cell's header and leaves -1 for the next call; no
    // other thread reads it, so no barrier is needed
    if (lane == 0 && active) {
      const unsigned long long tf =
          atomicExch((unsigned long long*)cell, ~0ull);
      head.x = (int)(uint32_t)tf;
      head.y = (int)(uint32_t)(tf >> 32);
      head.z = atomicExch(cell + 2, -1);
    }
    head.x = __shfl_sync(0xFFFFFFFFu, head.x, 0);
    head.y = __shfl_sync(0xFFFFFFFFu, head.y, 0);
    head.z = __shfl_sync(0xFFFFFFFFu, head.z, 0);
  }
  if (!active) return;
  int top = chg ? head.x : -1, full = chg ? head.y : -1;
  bool moved = false;
  int dx = 0, dy = 0;
  if (chg && code >= 2 && code - 2 < K) {
    const int32_t* mk = mvk + b * mvk_bs + 2 * (code - 2);
    dx = roll_offset(mk[0], X);
    dy = roll_offset(mk[1], Y);
    moved = true;
  }

  // each pixel's owning tile (-1: none)
  int own[kRows][kPx];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kPx; ++j) own[r][j] = full;
  const int n_list = head.z + 1;  // partial tiles the cell lists
  if (top > full && n_list <= kList) {
    // the listed partial tiles past `full`: each pixel takes the largest
    // whose window covers it
    const int4 list = *(const int4*)(cell + 4);
    const int ms[kList] = {list.x, list.y, list.z, list.w};
#pragma unroll
    for (int e = 0; e < kList; ++e) {
      const int m = ms[e];
      if (e >= n_list || m <= full) continue;
      const int ty = tile_start(__ldg(tyx + 2 * m), Y);
      const int tx = tile_start(__ldg(tyx + 2 * m + 1), X);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if ((unsigned)(y0 + r - ty) >= 16u) continue;
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if ((unsigned)(x0 + j - tx) < 16u && m > own[r][j]) own[r][j] = m;
      }
    }
  } else if (top > full) {
    // an overflowed list: walk every tile from top down to full + 1
    unsigned pending = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) pending |= valid << (r * kPx);
    for (int m = top; m > full && pending; --m) {
      const int ty = tile_start(__ldg(tyx + 2 * m), Y);
      const int tx = tile_start(__ldg(tyx + 2 * m + 1), X);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if ((unsigned)(y0 + r - ty) >= 16u) continue;
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
          const unsigned bit = 1u << (r * kPx + j);
          if ((pending & bit) && (unsigned)(x0 + j - tx) < 16u) {
            own[r][j] = m;
            pending &= ~bit;
          }
        }
      }
    }
  }

  // the tile a whole cell belongs to, looked up once
  TileRef whole = {0, 0, -1};
  if (top == full && full >= 0)
    whole = tile_ref(ti, tyx, full, S, Y, X);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    const int y = y0 + r;
    const long long i = (long long)y * X + x0;
    unsigned tiled = 0;  // pixels a tile owns
#pragma unroll
    for (int j = 0; j < kPx; ++j)
      if (own[r][j] >= 0) tiled |= 1u << j;
    tiled &= valid;
    const unsigned keep = valid & ~tiled;  // pixels that take prev
    if (keep) {
      if (!moved) {
        if (kVec) {
          // loaded at the start
        } else {
#pragma unroll
          for (int j = 0; j < kPx; ++j)
            if (keep >> j & 1u) v[r][j] = __ldg(pv + i + j);
        }
      } else {
        int sy = y + dy;
        if (sy >= Y) sy -= Y;
        const int32_t* src = pv + (long long)sy * X;
        int sx = x0 + dx;
        if (sx >= X) sx -= X;
        // X % 4 == 0 and dx % 4 == 0: sx is a multiple of 4 and sx + 3 < X
        if (kVec && keep == 0xFu && (dx & 3) == 0) {
          put4(v[r], __ldg((const int4*)(src + sx)));
        } else {
#pragma unroll
          for (int j = 0; j < kPx; ++j) {
            if (!(keep >> j & 1u)) continue;
            int s = sx + j;
            if (s >= X) s -= X;
            v[r][j] = __ldg(src + s);
          }
        }
      }
    }
    if (!tiled) continue;
    if (top == full) {  // the whole row belongs to one tile
      if (whole.row < 0) {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (tiled >> j & 1u) v[r][j] = -1;
        continue;
      }
      const int32_t* src =
          tiles + whole.row * t_rs + (y - whole.y0) * 16 + (x0 - whole.x0);
      if (tiles_vec && tiled == 0xFu && ((x0 - whole.x0) & 3) == 0) {
        put4(v[r], __ldg((const int4*)src));
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (tiled >> j & 1u) v[r][j] = __ldg(src + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        if (!(tiled >> j & 1u)) continue;
        const TileRef t = tile_ref(ti, tyx, own[r][j], S, Y, X);
        v[r][j] = t.row < 0 ? -1
                            : __ldg(tiles + t.row * t_rs + (y - t.y0) * 16 +
                                    (x0 + j - t.x0));
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

// prev, out: [B, Y, X] int32 (batch strides *_bs, contiguous rows), Y and
// X >= 16; mvk: [B, K, 2] int32; changed: [B] u8; bcode: [B, NB] u8 with
// NB = ceil(Y/16) * ceil(X/16); tiles: [S, 256] int32, row stride t_rs;
// tile_idx: [B, M] int32; tile_yx: [B, M, 2] int32 (contiguous [M, 2]);
// cells: 16-byte aligned scratch of 8 * B * NB ints whose headers (the first
// 4 ints of each 8) are -1, and are -1 again when the call's work is done.
// Enqueues the owner pass and the compose (its programmatic dependent) on
// `stream`, the compose alone where M == 0 → the first CUDA error code, or
// 0.
extern "C" int jsp_kmv_sparse_compose(
    const void* prev, long long prev_bs, const void* mvk, long long mvk_bs,
    const void* changed, long long chg_bs, void* out, long long out_bs,
    const void* bcode, long long bc_bs, const void* tiles, long long S,
    long long t_rs, const void* tile_idx, long long ti_bs,
    const void* tile_yx, long long ty_bs, void* cells, int B, int Y, int X,
    int K, int M, void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K < 0) K = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nbx = (X + 15) / 16, nby = (Y + 15) / 16, NB = nbx * nby;
  if (M > 0) {
    sparse_owner_kernel<<<dim3((M + kOwnerThreads - 1) / kOwnerThreads, B),
                          kOwnerThreads, 0, s>>>(
        (const int32_t*)tile_yx, ty_bs, (const uint8_t*)changed, chg_bs,
        (int*)cells, Y, X, nbx, NB, M);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = X % kPx == 0 && aligned(prev, 16) && aligned(out, 16) &&
                   prev_bs % kPx == 0 && out_bs % kPx == 0;
  const bool tiles_vec = aligned(tiles, 16) && t_rs % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nbx + kTy - 1) / kTy, nby, B);
  cfg.blockDim = dim3(kTx, kTy);
  cfg.stream = s;
  cudaLaunchAttribute pdl = {};
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  // only the owner pass may run beside the compose's start; without tiles
  // the compose follows the stream's previous work in full
  cfg.attrs = &pdl;
  cfg.numAttrs = M > 0 ? 1 : 0;
  // B > 65535 streams exceeds gridDim.z: the launch fails and is reported
  auto kernel = vec ? kmv_sparse_kernel<true> : kmv_sparse_kernel<false>;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel,
      (const int32_t*)prev, prev_bs, (const int32_t*)mvk, mvk_bs,
      (const uint8_t*)changed, chg_bs, (int32_t*)out, out_bs,
      (const uint8_t*)bcode, bc_bs, (const int32_t*)tiles, S, t_rs,
      tiles_vec, (const int32_t*)tile_idx, ti_bs, (const int32_t*)tile_yx,
      ty_bs, M > 0 ? (int*)cells : nullptr, Y, X, nbx, NB, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
