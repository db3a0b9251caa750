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
// land where the reference puts them.
//
// What bounds it: bytes.  A changed frame reads paycode + prev and writes
// out (12 bytes a pixel, ~25 MB at 1080p); motion pixels add one shifted
// read of prev, mostly from L2.  The plain twin (torch.roll + where) makes K
// full-frame copies per frame.  This first version is one thread a pixel
// with 4-byte accesses; vectorised loads and a persistent scan kernel are
// later work.  `out` must not alias `prev`: shifted reads would see pixels
// already written.
//
// kmv_compose_ds2 (the kDs2 instance) also replaces the Pallas _ds_kernel
// of scripts/exp_model_fusion2.py:34, which ran the packed 2x2 downsample
// inside the scan step (its variant E1).  On Hopper the honest form of that
// is one launch that composes the frame and emits its ds2 plane: each
// thread composes one 2x2 quad with the same rule, writes its four pixels
// (the next step's prev) and their packed field sum
//
//   red = sum(c & 0xFF) | sum((c >> 8) & 0xFF) << 10 | sum((c >> 16) & 0xFF) << 20
//
// (csrc/ds2_pack.cu's plane, unflipped).  An odd last row or column is
// composed and gets no ds2 word (reduce_window VALID).  The sum needs no
// second read of the frame: the quad's pixels are still in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 8;  // kslot is a 3-bit field

// One pixel of the compose rule, i = y * X + x.
__device__ __forceinline__ int32_t compose_px(
    const int32_t* __restrict__ pv, const int32_t* __restrict__ pc,
    long long i, bool chg, const int* s_mx, const int* s_my, int Y, int X,
    int K) {
  if (!chg) return pv[i];
  const uint32_t w = (uint32_t)pc[i];
  const uint32_t ptype = (w >> 24) & 3u;
  const uint32_t k = (w >> 26) & 7u;
  if (ptype == 1u) return (int32_t)(w & 0x00FFFFFFu);
  if (ptype == 2u && (int)k < K) {
    const long long y = i / X;
    const long long x = i - y * X;
    long long sy = (y + s_my[k]) % Y;
    long long sx = (x + s_mx[k]) % X;
    if (sy < 0) sy += Y;
    if (sx < 0) sx += X;
    return pv[sy * X + sx];
  }
  return pv[i];
}

__device__ __forceinline__ uint32_t fields(uint32_t c) {
  return (c & 0xFFu) | (((c >> 8) & 0xFFu) << 10) | (((c >> 16) & 0xFFu) << 20);
}

// kDs2 = false: one thread a pixel.  kDs2 = true: one thread a 2x2 quad,
// which also writes red[b, qy, qx] for every complete quad.
template <bool kDs2>
__global__ void kmv_compose_kernel(
    const int32_t* __restrict__ prev, long long prev_bs,
    const int32_t* __restrict__ paycode, long long pc_bs,
    const int32_t* __restrict__ mvk, long long mvk_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int32_t* __restrict__ out, long long out_bs,
    int32_t* __restrict__ red, long long red_bs,
    int Y, int X, int K) {
  __shared__ int s_mx[kMaxSlots];
  __shared__ int s_my[kMaxSlots];
  const int b = blockIdx.y;
  const int32_t* pv = prev + b * prev_bs;
  const int32_t* pc = paycode + b * pc_bs;
  int32_t* ob = out + b * out_bs;
  const bool chg = changed[b * chg_bs] != 0;
  if (threadIdx.x < K) {
    s_mx[threadIdx.x] = mvk[b * mvk_bs + 2 * threadIdx.x];
    s_my[threadIdx.x] = mvk[b * mvk_bs + 2 * threadIdx.x + 1];
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (!kDs2) {
    const long long n = (long long)Y * X;
    for (long long i = first; i < n; i += step)
      ob[i] = compose_px(pv, pc, i, chg, s_mx, s_my, Y, X, K);
    return;
  }
  int32_t* rb = red + b * red_bs;
  const int Wq = (X + 1) / 2, Ho = Y / 2, Wo = X / 2;
  const long long nq = (long long)((Y + 1) / 2) * Wq;
  for (long long q = first; q < nq; q += step) {
    const int qy = (int)(q / Wq), qx = (int)(q - (long long)qy * Wq);
    uint32_t sum = 0;
    for (int dy = 0; dy < 2; ++dy) {
      const int y = 2 * qy + dy;
      if (y >= Y) break;
      for (int dx = 0; dx < 2; ++dx) {
        const int x = 2 * qx + dx;
        if (x >= X) break;
        const long long i = (long long)y * X + x;
        const int32_t v = compose_px(pv, pc, i, chg, s_mx, s_my, Y, X, K);
        ob[i] = v;
        sum += fields((uint32_t)v);
      }
    }
    if (qy < Ho && qx < Wo) rb[(long long)qy * Wo + qx] = (int32_t)sum;
  }
}

template <bool kDs2>
int launch(const void* prev, long long prev_bs, const void* paycode,
           long long pc_bs, const void* mvk, long long mvk_bs,
           const void* changed, long long chg_bs, void* out, long long out_bs,
           void* red, long long red_bs, int B, int Y, int X, int K,
           void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K > kMaxSlots) K = kMaxSlots;  // slots >= 8 are unreachable
  const int threads = 256;
  const long long n = kDs2 ? (long long)((Y + 1) / 2) * ((X + 1) / 2)
                           : (long long)Y * X;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  dim3 grid((unsigned)blocks, (unsigned)B);
  kmv_compose_kernel<kDs2><<<grid, threads, 0, (cudaStream_t)stream>>>(
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

extern "C" const char* jsp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
