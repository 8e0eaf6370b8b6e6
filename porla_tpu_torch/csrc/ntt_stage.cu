// K1 ntt_stage: one radix-2 NTT butterfly stage over one CRT lane.
//
// Replaces porla_tpu/ntt/pallas_stage.py::_stage_kernel (built by
// _stage_call). Computes, for every pair (k, k + m2) with k mod 2*m2 < m2
// and every chunk c of an (n, C, 16) limb array,
//   out[k]      = a[k] + tw[j] * a[k + m2]   (mod lane modulus)
//   out[k + m2] = a[k] - tw[j] * a[k + m2]
// with j = k mod m2 and tw in Montgomery form (engine.encode_stages order).
//
// Bound on this card: bytes. One thread per pair does one 256-bit
// Montgomery product (136 32x32->64-bit products) per 128 bytes that the
// function must move (two values in, two out, packed; 512 bytes in the
// int64 layout of 16 limbs of 16 bits), far below the
// card's ratio of operations to bytes. The design does nothing clever about
// that yet: it reads the port's int64 limb layout as is (4x the bytes of a
// packed 32-bit layout) and keeps the product in registers. The TPU
// version's bf16 Toeplitz products and byte-digit tiles are not carried
// over: Hopper multiplies 32-bit words natively.
#include <cuda_runtime.h>

#include "porla_field.cuh"

__global__ void __launch_bounds__(256)
ntt_stage_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ tw,
                 int64_t* __restrict__ out, int64_t npairs, int C, int m2,
                 Mod M) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= npairs * C) return;
  int c = (int)(i % C);
  int64_t pr = i / C;
  int64_t g = pr / m2;
  int j = (int)(pr % m2);
  int64_t k0 = (g * 2 * m2 + j) * C + c;
  int64_t k1 = k0 + (int64_t)m2 * C;
  Fe u = fe_load(a + 16 * k0);
  Fe t = fe_load(a + 16 * k1);
  Fe w = fe_load(tw + 16 * (int64_t)j);
  Fe prod = fe_mul(t, w, M);
  fe_store(out + 16 * k0, fe_add(u, prod, M));
  fe_store(out + 16 * k1, fe_sub(u, prod, M));
}

extern "C" int porla_ntt_stage(const int64_t* a, const int64_t* tw,
                               int64_t* out, int64_t n, int C, int m2,
                               const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  int64_t total = (n / 2) * C;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ntt_stage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, tw, out, n / 2, C, m2, M);
  return (int)cudaGetLastError();
}
