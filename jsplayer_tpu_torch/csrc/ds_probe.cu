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
// columns, so a warp's loads coalesce).  block_transpose stages a 32x32
// tile through shared memory (padded to 33 columns against bank conflicts)
// so that both the reads and the writes coalesce.  4-byte accesses; wider
// ones are later work.
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

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads per tile column; each moves 4 words

// out[c, blk*X + x, r] = frame[c, blk*BH + r, x]; one thread block a 32x32
// tile of one BH-row block.
__global__ void block_transpose_kernel(const uint32_t* __restrict__ in,
                                       long long in_cs,
                                       uint32_t* __restrict__ out,
                                       long long out_cs, int C, int Y, int X,
                                       int BH) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int tiles_per_blk = (BH + kTile - 1) / kTile;
  const int blk = blockIdx.y / tiles_per_blk;
  const int r0 = (blockIdx.y - blk * tiles_per_blk) * kTile;
  const int x0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const Frame f{in + c * in_cs, Y, X};
    for (int k = ty; k < kTile; k += kTileRows) {
      const int r = r0 + k, x = x0 + tx;
      tile[k][tx] = (r < BH && x < X) ? f.at(blk * BH + r, x) : 0u;
    }
    __syncthreads();
    uint32_t* o = out + c * out_cs;
    for (int k = ty; k < kTile; k += kTileRows) {
      const int x = x0 + k, r = r0 + tx;
      if (x < X && r < BH) o[((long long)blk * X + x) * BH + r] = tile[tx][k];
    }
    __syncthreads();
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
    const int tiles_per_blk = (BH + kTile - 1) / kTile;
    const int nblk = (Y + BH - 1) / BH;
    const dim3 block(kTile, kTileRows);
    const dim3 grid((X + kTile - 1) / kTile, nblk * tiles_per_blk, cz);
    block_transpose_kernel<<<grid, block, 0, s>>>(src, in_cs, dst, out_cs, C,
                                                  Y, X, BH);
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
