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
// with 4-byte accesses; vectorised loads, a persistent scan kernel and a
// fused ds2 epilogue are later work.  `out` must not alias `prev`: shifted
// reads would see pixels already written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 8;  // kslot is a 3-bit field

__global__ void kmv_compose_kernel(
    const int32_t* __restrict__ prev, long long prev_bs,
    const int32_t* __restrict__ paycode, long long pc_bs,
    const int32_t* __restrict__ mvk, long long mvk_bs,
    const uint8_t* __restrict__ changed, long long chg_bs,
    int32_t* __restrict__ out, long long out_bs,
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
  const long long n = (long long)Y * X;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int32_t v;
    if (!chg) {
      v = pv[i];
    } else {
      const uint32_t w = (uint32_t)pc[i];
      const uint32_t ptype = (w >> 24) & 3u;
      const uint32_t k = (w >> 26) & 7u;
      if (ptype == 1u) {
        v = (int32_t)(w & 0x00FFFFFFu);
      } else if (ptype == 2u && (int)k < K) {
        const long long y = i / X;
        const long long x = i - y * X;
        long long sy = (y + s_my[k]) % Y;
        long long sx = (x + s_mx[k]) % X;
        if (sy < 0) sy += Y;
        if (sx < 0) sx += X;
        v = pv[sy * X + sx];
      } else {
        v = pv[i];
      }
    }
    ob[i] = v;
  }
}

}  // namespace

extern "C" int jsp_kmv_compose(
    const void* prev, long long prev_bs, const void* paycode, long long pc_bs,
    const void* mvk, long long mvk_bs, const void* changed, long long chg_bs,
    void* out, long long out_bs, int B, int Y, int X, int K, void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0) return 0;
  if (K > kMaxSlots) K = kMaxSlots;  // slots >= 8 are unreachable
  const int threads = 256;
  const long long n = (long long)Y * X;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  dim3 grid((unsigned)blocks, (unsigned)B);
  kmv_compose_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)prev, prev_bs, (const int32_t*)paycode, pc_bs,
      (const int32_t*)mvk, mvk_bs, (const uint8_t*)changed, chg_bs,
      (int32_t*)out, out_bs, Y, X, K);
  return (int)cudaGetLastError();
}

extern "C" const char* jsp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
