// K2 scalar_mul: batched k_i * P_i, one thread per lane, in two modes.
//
// Replaces porla_tpu/curves/pallas_curve.py::_smul_kernel (windowed mode:
// nbits MSB-first 4-bit windows over a 16-entry per-lane table,
// _scalar_mul_body) and ::_glv_smul_kernel (GLV mode: k = k1 + lambda*k2
// with 128-bit halves, sign flags and the endomorphism (beta*x, y),
// _glv_smul_body). The GLV split itself stays on the host (curves/glv.py).
//
// Bound on this card: operations. A 256-bit GLV lane is ~32*(4 doublings +
// 2 full adds) plus a 16-entry table build per half, ~2,250 field products
// of 136 32x32->64-bit products each, against ~230 bytes that the function
// must read and write (packed: a point in and out, two 128-bit halves).
// The design
// keeps a lane's whole scalar mul in one thread: coordinates in registers,
// the per-lane tables in local memory (L1-resident at these sizes), and the
// window loop inside the thread, so nothing returns to device memory
// between windows. Degenerate adds are resolved with selects, so every add
// also computes a doubling.
#include <cuda_runtime.h>

#include "porla_field.cuh"

template <bool GLV>
__global__ void __launch_bounds__(128)
scalar_mul_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                  const int64_t* __restrict__ z, const int64_t* __restrict__ k1,
                  const int64_t* __restrict__ k2, const int64_t* __restrict__ g1,
                  const int64_t* __restrict__ g2, Fe beta, int nbits,
                  int64_t* ox, int64_t* oy, int64_t* oz, int64_t B, Mod M) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= B) return;
  Pt p = pt_load(x, y, z, i);
  Pt r;
  if constexpr (GLV)
    r = pt_smul_glv(p, k1 + 16 * i, k2 + 16 * i, g1[i], g2[i], beta, M);
  else
    r = pt_smul_window(p, k1 + 16 * i, nbits, M);
  pt_store(ox, oy, oz, i, r);
}

static unsigned grid_for(int64_t B, int threads) {
  return (unsigned)((B + threads - 1) / threads);
}

extern "C" int porla_scalar_mul_window(const int64_t* x, const int64_t* y,
                                       const int64_t* z, const int64_t* s,
                                       int nbits, int64_t* ox, int64_t* oy,
                                       int64_t* oz, int64_t B,
                                       const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  Fe none = fe_zero();
  scalar_mul_kernel<false><<<grid_for(B, 128), 128, 0, (cudaStream_t)stream>>>(
      x, y, z, s, nullptr, nullptr, nullptr, none, nbits, ox, oy, oz, B, M);
  return (int)cudaGetLastError();
}

extern "C" int porla_scalar_mul_glv(const int64_t* x, const int64_t* y,
                                    const int64_t* z, const int64_t* k1,
                                    const int64_t* k2, const int64_t* g1,
                                    const int64_t* g2, const uint32_t* beta8,
                                    int64_t* ox, int64_t* oy, int64_t* oz,
                                    int64_t B, const uint32_t* mod17,
                                    void* stream) {
  Mod M = mod_from_words(mod17);
  Fe beta = fe_from_words(beta8);
  scalar_mul_kernel<true><<<grid_for(B, 128), 128, 0, (cudaStream_t)stream>>>(
      x, y, z, k1, k2, g1, g2, beta, 256, ox, oy, oz, B, M);
  return (int)cudaGetLastError();
}
