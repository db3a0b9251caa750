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
// mode but passthru, hpair_i32, wpair_i32 and block_transpose is one thread
// an output word, reading its inputs straight from device memory
// (neighbouring threads on neighbouring columns, so a warp's loads
// coalesce), with 4-byte accesses.  passthru (a strided row copy),
// hpair_i32 (a sum of two whole rows) and wpair_i32 (the column-pair sums
// of a row) move whole rows (see rows_kernel): 16-byte units, several
// loads in flight a thread, a thread block a run of rows.
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
    } else if (M == kPackH) {
      v = fields(f.at(2 * i, j)) + fields(f.at(2 * i + 1, j));
    } else if (M == kSum4) {
      v = fields(f.at(4 * i, j)) + fields(f.at(4 * i + 1, j)) +
          fields(f.at(4 * i + 2, j)) + fields(f.at(4 * i + 3, j));
    } else {  // kHpairLowbyte
      v = (f.at(2 * i, j) & 0xFFu) + (f.at(2 * i + 1, j) & 0xFFu);
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

// The row modes: each output row is one input row, the sum of two, or the
// column-pair sums of one.
//   passthru:  out[c, blk*BH/2 + r, :] = frame[c, blk*BH + r, 0:Wo] for r <
//              BH/2, Wo = X/2: a strided copy of rows;
//   hpair_i32: out[c, o, :] = frame[c, 2o, :] + frame[c, 2o + 1, :] (Wo = X,
//              wrapping int32 sums);
//   wpair_i32: out[c, o, j] = frame[c, o, 2j] + frame[c, o, 2j + 1] (Wo =
//              X/2, the last column dropped when X is odd; wrapping int32
//              sums): output unit u of a row reads input units 2u and
//              2u + 1, so a 16-byte output unit holds the four pair sums
//              of two 16-byte input units;
// a row past Y reads 0.  The one-thread-a-word template kept one 4-byte
// load in flight a thread (8 KB an SM), too little to cover device
// memory's latency, and divided per word.  Here a thread block of
// kPtThreads takes a run of blockDim.y output rows inside one group (a BH
// block for passthru; the frame for hpair_i32), so the group and row
// arithmetic is done once a run; its blockDim.x threads walk a row in
// units of V (16 bytes on the kVec instance, 4 bytes on the other),
// kPtUnroll units a thread with every load in flight before the first
// store (64 bytes a thread for passthru, 128 for hpair_i32 and
// wpair_i32; 128 KB an SM for passthru at 8 blocks).  The grid has a block for every run (frame,
// group, run), in order: measured against one wave of resident blocks
// looping over the runs, it took 2-4% less time, since the card gives each
// freed slot the next run.  Output rows whose inputs all lie past Y are
// stored as zero units and read nothing.
constexpr int kPtThreads = 256;
constexpr int kPtUnroll = 4;

__device__ __forceinline__ uint4 add_units(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ uint32_t add_units(uint32_t a, uint32_t b) {
  return a + b;  // u32 add = wrapping i32 add
}
// wpair_i32: the column-pair sums of input units a, b (consecutive in a row)
__device__ __forceinline__ uint4 pair_units(uint4 a, uint4 b) {
  return make_uint4(a.x + a.y, a.z + a.w, b.x + b.y, b.z + b.w);
}
__device__ __forceinline__ uint32_t pair_units(uint32_t a, uint32_t b) {
  return a + b;
}

// passthru asks for 8 blocks an SM (32 registers a thread; uncapped, ptxas
// gave it 40, so 6 fit; the two measured within 0.3%).  hpair_i32 and
// wpair_i32 hold twice the units in flight and keep their registers.
template <int M, typename V>
__global__ void __launch_bounds__(kPtThreads, M == kPassthru ? 8 : 1)
    rows_kernel(
    const uint32_t* __restrict__ in, long long in_cs,
    uint32_t* __restrict__ out, long long out_cs, int Y, int X, int BH,
    int Wo, int groups, int grows, int runs) {
  constexpr int kWords = sizeof(V) / 4;
  const int W = Wo / kWords;  // output units a row; Wo % kWords == 0
  const int tx = threadIdx.x, TX = blockDim.x;
  const int per_frame = groups * runs;
  const int c = blockIdx.x / per_frame;
  const int rem = blockIdx.x - c * per_frame;
  const int g = rem / runs;
  const int r = (rem - g * runs) * blockDim.y + threadIdx.y;
  if (r >= grows) return;
  const int o = g * grows + r;
  // the input row (the first of hpair_i32's two)
  const int y = M == kPassthru ? g * BH + r : M == kHpairI32 ? 2 * o : o;
  V* dst = (V*)(out + c * out_cs + (long long)o * Wo);
  if (y >= Y) {
    for (int u = tx; u < W; u += TX) __stcs(dst + u, V());
    return;
  }
  const V* src = (const V*)(in + c * in_cs + (long long)y * X);
  const bool pair = M == kHpairI32 && y + 1 < Y;
  for (int u0 = tx; u0 < W; u0 += TX * kPtUnroll) {
    V v[kPtUnroll], w[kPtUnroll];
#pragma unroll
    for (int k = 0; k < kPtUnroll; ++k) {
      const int u = u0 + k * TX;
      if (u < W) {
        if (M == kWpairI32) {
          v[k] = __ldcs(src + 2 * u);
          w[k] = __ldcs(src + 2 * u + 1);
        } else {
          v[k] = __ldcs(src + u);
          if (pair) w[k] = __ldcs(src + W + u);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPtUnroll; ++k) {
      const int u = u0 + k * TX;
      if (u < W)
        __stcs(dst + u, M == kWpairI32 ? pair_units(v[k], w[k])
                        : pair        ? add_units(v[k], w[k])
                                      : v[k]);
    }
  }
}

// Whether a row mode takes its 16-byte instance: whole 16-byte units on
// both sides (X % 4 == 0 for the input rows, Wo % 4 == 0 for the output
// rows and the first Wo words of an input row; for wpair_i32, Wo = X/2, so
// X % 8 == 0), 16-byte aligned bases and frame strides.  block_transpose
// makes the same test with X for Wo.
bool rows_vec(const void* in, long long in_cs, const void* out,
              long long out_cs, int X, int Wo) {
  return X % 4 == 0 && Wo % 4 == 0 && (uintptr_t)in % 16 == 0 &&
         (uintptr_t)out % 16 == 0 && in_cs % 4 == 0 && out_cs % 4 == 0;
}

template <int M, typename V>
int launch_rows(cudaStream_t s, const uint32_t* in, long long in_cs,
                uint32_t* out, long long out_cs, int C, int Y, int X, int BH,
                int Ho, int Wo) {
  // threads along a row: enough warps that kPtUnroll units each cover it
  const int W = Wo / (int)(sizeof(V) / 4);
  const int warps = (W + 32 * kPtUnroll - 1) / (32 * kPtUnroll);
  const int tx = 32 * (warps < kPtThreads / 32 ? warps : kPtThreads / 32);
  const int ty = kPtThreads / tx;
  // passthru's groups are the BH blocks, of BH/2 output rows each
  const int groups = M == kPassthru ? (Y + BH - 1) / BH : 1;
  const int grows = Ho / groups;
  const int runs = (grows + ty - 1) / ty;
  const long long blocks = (long long)C * groups * runs;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  rows_kernel<M, V><<<(unsigned)blocks, dim3(tx, ty), 0, s>>>(
      in, in_cs, out, out_cs, Y, X, BH, Wo, groups, grows, runs);
  return (int)cudaGetLastError();
}

template <int M>
int launch_rows(cudaStream_t s, const uint32_t* in, long long in_cs,
                uint32_t* out, long long out_cs, int C, int Y, int X, int BH,
                int Ho, int Wo) {
  return rows_vec(in, in_cs, out, out_cs, X, Wo)
             ? launch_rows<M, uint4>(s, in, in_cs, out, out_cs, C, Y, X, BH,
                                     Ho, Wo)
             : launch_rows<M, uint32_t>(s, in, in_cs, out, out_cs, C, Y, X,
                                        BH, Ho, Wo);
}

template <int M>
void launch(const dim3& grid, const dim3& block, cudaStream_t s,
            const uint32_t* in, long long in_cs, uint32_t* out,
            long long out_cs, int C, int Y, int X, int BH, int Ho, int Wo) {
  ds_probe_kernel<M><<<grid, block, 0, s>>>(in, in_cs, out, out_cs, C, Y, X,
                                            BH, Ho, Wo);
}

}  // namespace

// Which instance jsp_ds_probe runs for these views: 1 the 16-byte one, 0
// the 4-byte one; -1 for a mode with one instance.
extern "C" int jsp_ds_probe_instance(int mode, const void* in,
                                     long long in_cs, const void* out,
                                     long long out_cs, int X, int Wo) {
  if (mode != kPassthru && mode != kHpairI32 && mode != kWpairI32) return -1;
  return rows_vec(in, in_cs, out, out_cs, X, Wo) ? 1 : 0;
}

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
  if (mode == kPassthru || mode == kHpairI32 || mode == kWpairI32) {
    if (BH % 4) return (int)cudaErrorInvalidValue;
    switch (mode) {
      case kPassthru:
        return launch_rows<kPassthru>(s, src, in_cs, dst, out_cs, C, Y, X,
                                      BH, Ho, Wo);
      case kHpairI32:
        return launch_rows<kHpairI32>(s, src, in_cs, dst, out_cs, C, Y, X,
                                      BH, Ho, Wo);
      default:
        return launch_rows<kWpairI32>(s, src, in_cs, dst, out_cs, C, Y, X,
                                      BH, Ho, Wo);
    }
  }
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
    JSP_MODE(kPackH)
    JSP_MODE(kSum4)
    JSP_MODE(kHpairLowbyte)
#undef JSP_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
