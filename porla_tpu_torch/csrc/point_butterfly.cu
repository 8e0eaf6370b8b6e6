// K3 point_butterfly and K7 point_butterfly_window: the MAC-mirror butterfly
// (M0 + s*M1, M0 - s*M1) per lane, with s*M1 and the two full-cased adds
// fused into the same thread. One template, two modes, as in K2:
//
// - GLV (K3): s*M1 by the GLV scalar mul, for 256-bit scalars split on the
//   host. Replaces porla_tpu/curves/pallas_curve.py::_glv_butterfly_kernel
//   (built by _glv_butterfly_call).
// - windowed (K7): s*M1 over the low nbits of s in 4-bit windows, for every
//   other scalar width. Replaces ::_butterfly_kernel (built by
//   _butterfly_call).
//
// Bound on this card: operations (one scalar mul, ~2,250 field products at
// 256 bits with GLV and nbits/4 * 44 plus a 16-entry table without, plus
// two adds per lane, against ~420 bytes that the function must read and
// write, packed). As in K2, a lane lives in one thread and nothing goes back
// to device memory until both outputs are final.
#include <cuda_runtime.h>

#include "porla_field.cuh"

template <bool GLV>
__global__ void __launch_bounds__(128)
point_butterfly_kernel(const int64_t* __restrict__ m0x,
                       const int64_t* __restrict__ m0y,
                       const int64_t* __restrict__ m0z,
                       const int64_t* __restrict__ m1x,
                       const int64_t* __restrict__ m1y,
                       const int64_t* __restrict__ m1z,
                       const int64_t* __restrict__ k1,
                       const int64_t* __restrict__ k2,
                       const int64_t* __restrict__ g1,
                       const int64_t* __restrict__ g2, Fe beta, int nbits,
                       int64_t* hx, int64_t* hy, int64_t* hz, int64_t* lx,
                       int64_t* ly, int64_t* lz, int64_t B, Mod M) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= B) return;
  Pt m1 = pt_load(m1x, m1y, m1z, i);
  Pt t;
  if constexpr (GLV)
    t = pt_smul_glv(m1, k1 + 16 * i, k2 + 16 * i, g1[i], g2[i], beta, M);
  else
    t = pt_smul_window(m1, k1 + 16 * i, nbits, M);
  Pt m0 = pt_load(m0x, m0y, m0z, i);
  pt_store(hx, hy, hz, i, pt_add(m0, t, M));
  pt_store(lx, ly, lz, i, pt_add(m0, pt_neg(t, M), M));
}

extern "C" int porla_point_butterfly(
    const int64_t* m0x, const int64_t* m0y, const int64_t* m0z,
    const int64_t* m1x, const int64_t* m1y, const int64_t* m1z,
    const int64_t* k1, const int64_t* k2, const int64_t* g1,
    const int64_t* g2, const uint32_t* beta8, int64_t* hx, int64_t* hy,
    int64_t* hz, int64_t* lx, int64_t* ly, int64_t* lz, int64_t B,
    const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  Fe beta = fe_from_words(beta8);
  unsigned blocks = (unsigned)((B + 127) / 128);
  point_butterfly_kernel<true><<<blocks, 128, 0, (cudaStream_t)stream>>>(
      m0x, m0y, m0z, m1x, m1y, m1z, k1, k2, g1, g2, beta, 256, hx, hy, hz, lx,
      ly, lz, B, M);
  return (int)cudaGetLastError();
}

extern "C" int porla_point_butterfly_window(
    const int64_t* m0x, const int64_t* m0y, const int64_t* m0z,
    const int64_t* m1x, const int64_t* m1y, const int64_t* m1z,
    const int64_t* s, int nbits, int64_t* hx, int64_t* hy, int64_t* hz,
    int64_t* lx, int64_t* ly, int64_t* lz, int64_t B, const uint32_t* mod17,
    void* stream) {
  Mod M = mod_from_words(mod17);
  unsigned blocks = (unsigned)((B + 127) / 128);
  point_butterfly_kernel<false><<<blocks, 128, 0, (cudaStream_t)stream>>>(
      m0x, m0y, m0z, m1x, m1y, m1z, s, nullptr, nullptr, nullptr, fe_zero(),
      nbits, hx, hy, hz, lx, ly, lz, B, M);
  return (int)cudaGetLastError();
}
