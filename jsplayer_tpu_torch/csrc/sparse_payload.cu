// unpack_payload: the sparse payload transport's tile scatter, for a window
// of T frames in one C call.
//
// Replaces jsplayer_tpu/kernels/sparse_payload.py: unpack_payload (:61), an
// XLA function that runs the one-hot product
//
//   dense[NB, 256] = onehot[NB, M] (f32) @ tiles[M, 256] (u32 as f32)
//
// on the TPU's matrix unit as a scatter engine, casts to u32 and reorders
// the 16x16 blocks into [Y, X].  On Hopper the product is a scatter and is
// written as one; it gives the product's bits:
//
//   * a word goes through f32 (__uint2float_rn: words at or above 2^24
//     round to nearest even) and back to u32 by __float2uint_rz, which
//     saturates: 0xFFFFFFFF -> 2^32 in f32 -> 0xFFFFFFFF;
//   * tiles that name the same block are summed in f32, in tile order from
//     0.0f (exact while every partial sum stays below 2^24; two tiles give
//     the same sum in any order);
//   * an index outside [0, NB) names no block (-1 pads, and any other);
//   * a block that no tile names is 0.
//
// Two launches on the caller's stream after a memset of the owner array
// [T, NB] to -1:
//   1. the owner pass, a thread a (frame, tile): the first tile to claim a
//      block writes its index (atomicCAS from -1); a later one marks the
//      block -2 (several, atomicExch);
//   2. the dense pass writes every word of [T, Y, X] once: a thread covers
//      2 rows x 4 pixels of one block, reads the block's owner once, and
//      stores 16 bytes a row.  An owner >= 0 is read as 16-byte rows of its
//      tile (4-byte reads for an unaligned view); -1 writes zeros; -2 scans
//      the frame's tile_block in order and sums the matching tiles (rare:
//      pack_tiles never names a block twice).
//
// What bounds it: bytes.  A frame writes Y*X*4 bytes (14.7 MB at
// 2560x1440) and reads its tile_block row and one 1 KB tile a named block;
// the owner array (4 bytes a block) stays in L2.  At 3.35 TB/s that is
// ~4.4 us a QHD frame.  The one-hot product, by contrast, does NB*M*256
// multiply-adds a frame.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // threads a block of the dense pass
constexpr int kPx = 4;            // consecutive pixels of a row a thread covers
constexpr int kRows = 2;          // rows a thread covers
constexpr int kOwnerThreads = 256;

__global__ void __launch_bounds__(kOwnerThreads) owner_kernel(
    const int32_t* __restrict__ tile_block, long long tb_ts,
    int32_t* __restrict__ owner, int T, int M, int NB) {
  const long long i = (long long)blockIdx.x * kOwnerThreads + threadIdx.x;
  if (i >= (long long)T * M) return;
  const int t = (int)(i / M), m = (int)(i % M);
  const int b = tile_block[t * tb_ts + m];
  if (b < 0 || b >= NB) return;
  int32_t* o = owner + (long long)t * NB + b;
  if (atomicCAS(o, -1, m) != -1) atomicExch(o, -2);
}

// The f32 round trip of one word: u32 -> f32 (nearest even) -> u32
// (toward zero, saturating).
__device__ __forceinline__ uint32_t through_f32(uint32_t w) {
  return __float2uint_rz(__uint2float_rn(w));
}

template <bool kVec>
__global__ void __launch_bounds__(kTx * kTy) dense_kernel(
    const int32_t* __restrict__ tiles, long long ts_t, long long ts_m,
    const int32_t* __restrict__ tile_block, long long tb_ts,
    const int32_t* __restrict__ owner, int32_t* __restrict__ out, int M,
    int NB, int Y, int X) {
  const int t = blockIdx.z;
  const int x0 = (blockIdx.x * kTx + threadIdx.x) * kPx;
  const int y0 = (blockIdx.y * kTy + threadIdx.y) * kRows;
  if (x0 >= X || y0 >= Y) return;  // X, Y are multiples of 16
  const int nbx = X >> 4;
  const int blk = (y0 >> 4) * nbx + (x0 >> 4);
  const int own = __ldg(owner + (long long)t * NB + blk);
  // a thread's first word in the block's 16x16 tile
  const int w0 = (y0 & 15) * 16 + (x0 & 15);
  const int32_t* tt = tiles + t * ts_t;
  uint32_t v[kRows][kPx];
  if (own >= 0) {
    const int32_t* src = tt + own * ts_m + w0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kVec) {
        const int4 a = __ldcs((const int4*)(src + 16 * r));
        v[r][0] = a.x; v[r][1] = a.y; v[r][2] = a.z; v[r][3] = a.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          v[r][j] = (uint32_t)__ldcs(src + 16 * r + j);
      }
#pragma unroll
      for (int j = 0; j < kPx; ++j) v[r][j] = through_f32(v[r][j]);
    }
  } else if (own == -1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kPx; ++j) v[r][j] = 0u;
  } else {  // several tiles: their f32 sum, in tile order
    float s[kRows][kPx];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kPx; ++j) s[r][j] = 0.0f;
    const int32_t* tb = tile_block + t * tb_ts;
    for (int m = 0; m < M; ++m) {
      if (__ldg(tb + m) != blk) continue;
      const int32_t* src = tt + m * ts_m + w0;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          s[r][j] += __uint2float_rn((uint32_t)__ldg(src + 16 * r + j));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kPx; ++j) v[r][j] = __float2uint_rz(s[r][j]);
  }
  int32_t* o = out + ((long long)t * Y + y0) * X + x0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *(int4*)(o + (long long)r * X) =
        make_int4((int)v[r][0], (int)v[r][1], (int)v[r][2], (int)v[r][3]);
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

// tiles [T, M, 256] int32 with strides (ts_t, ts_m, 1); tile_block [T, M]
// int32 with strides (tb_ts, 1); owner [T, NB] int32 scratch (any content:
// it is set here); out [T, Y, X] int32 contiguous, 16-byte aligned.  Y and
// X multiples of 16, NB = (Y / 16) * (X / 16).  Returns the first CUDA
// error of the memset and the two launches, else 0.
extern "C" int jsp_unpack_payload(const void* tiles, long long ts_t,
                                  long long ts_m, const void* tile_block,
                                  long long tb_ts, void* owner, void* out,
                                  int T, int M, int NB, int Y, int X,
                                  void* stream) {
  if (T <= 0 || NB <= 0 || Y <= 0 || X <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(owner, 0xFF, (size_t)T * NB * 4, s);
  if (rc != cudaSuccess) return (int)rc;
  if (M > 0) {
    const long long n = (long long)T * M;
    owner_kernel<<<(unsigned)((n + kOwnerThreads - 1) / kOwnerThreads),
                   kOwnerThreads, 0, s>>>((const int32_t*)tile_block, tb_ts,
                                          (int32_t*)owner, T, M, NB);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  const bool vec = aligned(tiles, 16) && ts_t % 4 == 0 && ts_m % 4 == 0;
  const dim3 block(kTx, kTy);
  const dim3 grid((X / kPx + kTx - 1) / kTx, (Y / kRows + kTy - 1) / kTy, T);
  // T > 65535 frames exceeds gridDim.z: the launch fails and is reported
  auto kernel = vec ? dense_kernel<true> : dense_kernel<false>;
  kernel<<<grid, block, 0, s>>>(
      (const int32_t*)tiles, ts_t, ts_m, (const int32_t*)tile_block, tb_ts,
      (const int32_t*)owner, (int32_t*)out, M, NB, Y, X);
  return (int)cudaGetLastError();
}
