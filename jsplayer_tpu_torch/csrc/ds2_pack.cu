// ds2 pack: the packed half-resolution model plane of a stack of frames.
//
// Replaces jsplayer_tpu/kernels/rgb_convert.py: _ds2_pack_kernel (the Pallas
// kernel behind ds2_pack).  Its semantics are those of ds2_pack_ref: for
// each 2x2 window (reduce_window VALID, so an odd last row or column is
// dropped) the sums of the three 8-bit channels, packed
//
//   out = sum(c & 0xFF) | sum((c >> 8) & 0xFF) << 10 | sum((c >> 16) & 0xFF) << 20
//
// (each sum <= 1020 < 1024).  flip != 0 writes output row Ho-1-i, the
// bottom-up -> top-down row flip the reference applies to the small plane
// (sp_recon._model_emit, rgb_convert.ds2_packed_output).  Every shape is
// taken; the Pallas gate (X even, X >= 256, Y >= 16) does not apply.
//
// What bounds it: bytes.  It reads the frame once (4 bytes a pixel) and
// writes a quarter of that.  The TPU kernel needed u16 bitcasts and two
// in-VMEM transposes to pair columns; here each thread reads its 2x2 window
// straight from device memory and sums the low and high bytes as two 16-bit
// fields of one word.  Neighbouring threads read neighbouring 8-byte column
// pairs, so a warp's loads are coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void ds2_pack_kernel(const int32_t* __restrict__ in, long long in_cs,
                                int32_t* __restrict__ out, long long out_cs,
                                int C, int X, int Ho, int Wo, int flip) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  const int oi = flip ? (Ho - 1 - i) : i;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const uint32_t* r0 =
        (const uint32_t*)(in + c * in_cs + (long long)(2 * i) * X + 2 * j);
    const uint32_t* r1 = r0 + X;
    const uint32_t a = r0[0], b = r0[1], d = r1[0], e = r1[1];
    // low byte (b) and byte 2 (r) ride one word as two 16-bit fields
    const uint32_t rb = (a & 0x00FF00FFu) + (b & 0x00FF00FFu) +
                        (d & 0x00FF00FFu) + (e & 0x00FF00FFu);
    const uint32_t g = ((a >> 8) & 0xFFu) + ((b >> 8) & 0xFFu) +
                       ((d >> 8) & 0xFFu) + ((e >> 8) & 0xFFu);
    out[c * out_cs + (long long)oi * Wo + j] =
        (int32_t)((rb & 0xFFFFu) | (g << 10) | ((rb >> 16) << 20));
  }
}

}  // namespace

extern "C" int jsp_ds2_pack(const void* in, long long in_cs, void* out,
                            long long out_cs, int C, int Y, int X, int flip,
                            void* stream) {
  const int Ho = Y / 2, Wo = X / 2;
  if (C <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y,
                  C < 65535 ? C : 65535);
  ds2_pack_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, in_cs, (int32_t*)out, out_cs, C, X, Ho, Wo, flip);
  return (int)cudaGetLastError();
}
