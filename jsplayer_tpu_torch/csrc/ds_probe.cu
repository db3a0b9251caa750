// ds probe: the ds2 experiment kernels, one CUDA kernel templated on a mode.
//
// Replaces the Pallas kernels of the 2x2-downsample experiments:
//   scripts/exp_pallas_ds.py:37 _kernel(variant)   -> ds2_fields (tpose,
//       reshape, slice, take: all compute rw22), bitcast_fold (bitcast);
//       tpose16 is csrc/ds2_pack.cu
//   scripts/exp_pallas_ds2.py:31,35,41             -> passthru, pack_h,
//       sum4 (tpose16_notr)
//   scripts/exp_pallas_bisect.py:19-65             -> hpair_i32 (sub_slice,
//       sub_reshape, sub_roll), hpair_lowbyte (bitcast_h), wpair_i32
//       (minor_reshape, lane_gather_same), block_transpose (transpose)
// Their semantics are the plain twins in jsplayer_tpu_torch/experiments/
// probes.py.  The Pallas grid cuts [C, Y, X] frames into blocks of BH rows;
// the last block is partial and its rows past Y read as 0 here (Pallas
// interpret mode reads 0 there; on the TPU they are undefined).  Field
// sums pack b | g << 10 | r << 20 (at most 1020 a field, no carry); int32
// sums wrap.
//
// What bounds it: bytes.  Each mode reads 2-4 words for each word it writes
// and does a few integer ops.  On the TPU these probes tested which layout
// ops Mosaic could lower (strided slices, minor-dim reshapes, lane gathers,
// u16 bitcasts, transposes); on Hopper any address can be read, so every
// mode but block_transpose is one thread an output word, reading its
// inputs straight from device memory (neighbouring threads on neighbouring
// columns, so a warp's loads coalesce), with 4-byte accesses.
// block_transpose moves 32 x 128-word tiles through shared memory with
// 16-byte loads along x and 16-byte stores along r, transposing 4 x 4
// sub-blocks in registers and swizzling the tile's 16-byte units so that
// neither side has bank conflicts (see block_transpose_kernel); odd
// shapes and unaligned views take the same indexing with 4-byte accesses.
// Its bound at [4, 1080, 1920], BH = 128: 33.2 MB read, 35.4 MB written
// (the zero rows of the partial last block are written, not read), 0.0205
// ms at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode {
  kDs2Fields = 0,
  kBitcastFold = 1,
  kPassthru = 2,
  kPackH = 3,
  kSum4 = 4,
  kHpairI32 = 5,
  kHpairLowbyte = 6,
  kWpairI32 = 7,
  kBlockTranspose = 8,
};

struct Frame {
  const uint32_t* p;
  int Y, X;
  // row y of the zero-padded frame: 0 past the last row
  __device__ __forceinline__ uint32_t at(int y, int x) const {
    return y < Y ? p[(long long)y * X + x] : 0u;
  }
};

__device__ __forceinline__ uint32_t fields(uint32_t c) {
  return (c & 0xFFu) | (((c >> 8) & 0xFFu) << 10) | (((c >> 16) & 0xFFu) << 20);
}

template <int M>
__global__ void ds_probe_kernel(const uint32_t* __restrict__ in,
                                long long in_cs, uint32_t* __restrict__ out,
                                long long out_cs, int C, int Y, int X, int BH,
                                int Ho, int Wo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const Frame f{in + c * in_cs, Y, X};
    uint32_t v;
    if (M == kDs2Fields) {  // pack each pixel, then add the four words
      v = fields(f.at(2 * i, 2 * j)) + fields(f.at(2 * i, 2 * j + 1)) +
          fields(f.at(2 * i + 1, 2 * j)) + fields(f.at(2 * i + 1, 2 * j + 1));
    } else if (M == kBitcastFold) {  // row pairs, right half folded left
      v = fields(f.at(2 * i, j)) + fields(f.at(2 * i + 1, j)) +
          fields(f.at(2 * i, j + Wo)) + fields(f.at(2 * i + 1, j + Wo));
    } else if (M == kPassthru) {  // each block's top-left [BH/2, X/2]
      const int half = BH / 2;
      const int blk = i / half;
      v = f.at(blk * BH + (i - blk * half), j);
    } else if (M == kPackH) {
      v = fields(f.at(2 * i, j)) + fields(f.at(2 * i + 1, j));
    } else if (M == kSum4) {
      v = fields(f.at(4 * i, j)) + fields(f.at(4 * i + 1, j)) +
          fields(f.at(4 * i + 2, j)) + fields(f.at(4 * i + 3, j));
    } else if (M == kHpairI32) {
      v = f.at(2 * i, j) + f.at(2 * i + 1, j);  // u32 add = wrapping i32 add
    } else if (M == kHpairLowbyte) {
      v = (f.at(2 * i, j) & 0xFFu) + (f.at(2 * i + 1, j) & 0xFFu);
    } else {  // kWpairI32
      v = f.at(i, 2 * j) + f.at(i, 2 * j + 1);
    }
    out[c * out_cs + (long long)i * Wo + j] = v;
  }
}

// block_transpose: out[c, blk*X + x, r] = frame[c, blk*BH + r, x].  A thread
// block moves a tile of kTr r-values (source rows) x kTw x-values (source
// columns) of one BH-row block: 32 x 128 words, 16 KB each way, 256 threads.
constexpr int kTr = 32;
constexpr int kTw = 128;
constexpr int kTpThreads = 256;
constexpr int kUnits = kTr / 4;  // 16-byte units of r a tile row holds

// The shared tile holds the output's order, [x][r], as 16-byte units of 4
// r-values, with unit u of row x stored at u ^ ((x >> 2) & 7).  Both
// phases then touch 8 distinct 16-byte bank groups in each quarter warp:
// the loads' writes (one r-unit, x = 4 * (lane & 7) + q) and the stores'
// reads (one x, u = 0..7).
__device__ __forceinline__ int tp_slot(int x, int u) {
  return x * kUnits + (u ^ ((x >> 2) & 7));
}

// Phase 1: each thread loads a 4 x 4 sub-block (4 source rows of 4
// columns: 16-byte loads along x on the kVec path), transposes it in
// registers and writes 4 units.  A warp's lanes cover 8 consecutive
// column quads (a 128-byte row segment) of 4 row quads.  Rows past Y are
// zero and are never read.  Phase 2: each thread stores 4 units of the
// output, 16-byte stores along r, a warp 4 rows of 128 contiguous bytes.
template <bool kVec>
__global__ void __launch_bounds__(kTpThreads) block_transpose_kernel(
    const uint32_t* __restrict__ in, long long in_cs,
    uint32_t* __restrict__ out, long long out_cs, int C, int Y, int X,
    int BH) {
  __shared__ uint4 tile[kTw * kUnits];
  const int rtiles = (BH + kTr - 1) / kTr;
  const int blk = blockIdx.y / rtiles;
  const int r0 = (blockIdx.y - blk * rtiles) * kTr;
  const int x0 = blockIdx.x * kTw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xq = (warp & 3) * 8 + (lane & 7);  // column quad of the tile
  const int rq = (warp >> 2) * 4 + (lane >> 3);  // row quad of the tile
  const int xs = x0 + 4 * xq;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const uint32_t* f = in + c * in_cs;
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * rq + i;
      const int y = blk * BH + r;
      const long long row = (long long)y * X;
      if (r < BH && y < Y && (!kVec || xs < X)) {
        if (kVec) {
          const uint4 v = __ldcs((const uint4*)(f + row + xs));
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[i][q] = xs + q < X ? f[row + xs + q] : 0u;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) a[i][q] = 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tile[tp_slot(4 * xq + q, rq)] =
          make_uint4(a[0][q], a[1][q], a[2][q], a[3][q]);
    __syncthreads();
    uint32_t* o = out + c * out_cs;
#pragma unroll
    for (int k = 0; k < kTw * kUnits / kTpThreads; ++k) {
      const int g = k * kTpThreads + threadIdx.x;
      const int x = g / kUnits, u = g % kUnits;
      const int xo = x0 + x, r = r0 + 4 * u;
      if (xo >= X || r >= BH) continue;  // BH % 4 == 0: r + 3 < BH
      const uint4 v = tile[tp_slot(x, u)];
      uint32_t* dst = o + ((long long)blk * X + xo) * BH + r;
      if (kVec) {
        *(uint4*)dst = v;
      } else {
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
    }
    if (c + (int)gridDim.z < C) __syncthreads();  // the tile is reused
  }
}

template <int M>
void launch(const dim3& grid, const dim3& block, cudaStream_t s,
            const uint32_t* in, long long in_cs, uint32_t* out,
            long long out_cs, int C, int Y, int X, int BH, int Ho, int Wo) {
  ds_probe_kernel<M><<<grid, block, 0, s>>>(in, in_cs, out, out_cs, C, Y, X,
                                            BH, Ho, Wo);
}

}  // namespace

// mode: the Mode enum; Ho x Wo: the output plane the wrapper allocated
// (probes.probe_shape).  Returns cudaGetLastError() after the launch.
extern "C" int jsp_ds_probe(int mode, const void* in, long long in_cs,
                            void* out, long long out_cs, int C, int Y, int X,
                            int BH, int Ho, int Wo, void* stream) {
  if (C <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  uint32_t* dst = (uint32_t*)out;
  const unsigned cz = C < 65535 ? C : 65535;
  if (mode == kBlockTranspose) {
    if (BH % 4) return (int)cudaErrorInvalidValue;
    const int nblk = (Y + BH - 1) / BH;
    const dim3 grid((X + kTw - 1) / kTw, nblk * ((BH + kTr - 1) / kTr), cz);
    const bool vec = X % 4 == 0 && (uintptr_t)src % 16 == 0 &&
                     (uintptr_t)dst % 16 == 0 && in_cs % 4 == 0 &&
                     out_cs % 4 == 0;
    auto kernel = vec ? block_transpose_kernel<true>
                      : block_transpose_kernel<false>;
    kernel<<<grid, kTpThreads, 0, s>>>(src, in_cs, dst, out_cs, C, Y, X, BH);
    return (int)cudaGetLastError();
  }
  const dim3 block(32, 8);
  const dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y,
                  cz);
  switch (mode) {
#define JSP_MODE(M)                                                          \
  case M:                                                                    \
    launch<M>(grid, block, s, src, in_cs, dst, out_cs, C, Y, X, BH, Ho, Wo); \
    break;
    JSP_MODE(kDs2Fields)
    JSP_MODE(kBitcastFold)
    JSP_MODE(kPassthru)
    JSP_MODE(kPackH)
    JSP_MODE(kSum4)
    JSP_MODE(kHpairI32)
    JSP_MODE(kHpairLowbyte)
    JSP_MODE(kWpairI32)
#undef JSP_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
