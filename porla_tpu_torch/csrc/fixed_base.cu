// K4 fixed_base: scalar_i * G_(i mod ng) from per-window affine tables
// T_w[d] = d * 16^w * G_g, one mixed add per 4-bit window.
//
// Replaces porla_tpu/curves/pallas_curve.py::_fb_kernel (built by _fb_call).
// The TPU kernel carried each lane's accumulator across the sequential grid
// axis (pl.when(g == 0) initialises it, later grid steps add more windows);
// Hopper runs blocks in no order, so here each thread walks all nbits/4
// windows of its lane in a loop and writes the sum once.
//
// Bound on this card: operations. A lane does nbits/4 mixed adds (11 field
// products each; the full-cased form also computes the doubling for the
// P == Q case, ~18 in all) and reads one 64-byte affine table entry per
// window (packed; 384 bytes in the int64 limb layout). Tables are shared by every lane with the same
// generator (the whole table of 128 generators x 64 windows is 50 MB in the
// int64 limb layout, about the size of L2).
#include <cuda_runtime.h>

#include "porla_field.cuh"

__global__ void __launch_bounds__(128)
fixed_base_kernel(const int64_t* __restrict__ tx,
                  const int64_t* __restrict__ ty,
                  const int64_t* __restrict__ tz,
                  const int64_t* __restrict__ s, int64_t* ox, int64_t* oy,
                  int64_t* oz, int64_t B, int ng, int nwin, Mod M) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= B) return;
  int g = (int)(i % ng);
  const int64_t* si = s + 16 * i;
  Pt acc = pt_inf(M);
  for (int w = 0; w < nwin; w++) {
    int64_t e = ((int64_t)w * 16 + nibble(si, w)) * ng + g;
    acc = pt_madd(acc, pt_load(tx, ty, tz, e), M);
  }
  pt_store(ox, oy, oz, i, acc);
}

extern "C" int porla_fixed_base(const int64_t* tx, const int64_t* ty,
                                const int64_t* tz, const int64_t* s,
                                int64_t* ox, int64_t* oy, int64_t* oz,
                                int64_t B, int ng, int nwin,
                                const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  unsigned blocks = (unsigned)((B + 127) / 128);
  fixed_base_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      tx, ty, tz, s, ox, oy, oz, B, ng, nwin, M);
  return (int)cudaGetLastError();
}
