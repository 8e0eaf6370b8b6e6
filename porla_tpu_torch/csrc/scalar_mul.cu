// K2 scalar_mul: batched k_i * P_i, in two modes.
//
// Replaces porla_tpu/curves/pallas_curve.py::_smul_kernel (windowed mode:
// nbits MSB-first 4-bit windows over a 16-entry per-lane table,
// _scalar_mul_body) and ::_glv_smul_kernel (GLV mode: k = k1 + lambda*k2
// with 128-bit halves, sign flags and the endomorphism (beta*x, y),
// _glv_smul_body). The GLV split itself stays on the host (curves/glv.py).
//
// Bound on this card: operations (a 256-bit GLV lane is ~1,600 field
// products of 136 32x32->64-bit products each, a 32-bit windowed lane ~540,
// against ~230 and ~200 bytes read and written, packed). At the protocol's
// shapes the lanes are few (1 lane in each update's point_scale, 1024 at
// initialize, 2048 in an audit's MAC MSM), so a lane's chain of dependent
// field products is the time, not the card's throughput. The design is
// K3's (porla_coop.cuh):
// - a field element lies on 8 neighbouring threads, one 32-bit word each:
//   a product is CIOS by warp shuffles, a carry chain two warp votes;
// - the GLV halves run as two chains on the lane's two groups of 8 threads
//   (16 threads a lane), k1*(±P) and k2*(±phi(P)) by the windowed scalar
//   mul over 128 bits, and meet in one full-cased add (c_glv_halves), which
//   group 0 writes: the Jacobian limbs of cuda_curve.glv_halves_plain;
// - the windowed mode is one group a lane (8 threads), CurveOps.scalar_mul's
//   formulas in its order, so its limbs are that function's;
// - each group's 15-entry table lies in shared memory; the full-cased adds
//   compute the P == Q doubling only where a lane of the warp meets it.
#include <cuda_runtime.h>

#include "porla_coop.cuh"

// Threads 8l .. 8l + 7 of a block run lane l, thread k holding word k.
__global__ void __launch_bounds__(COOP_THREADS)
scalar_mul_window_kernel(const int64_t* __restrict__ x,
                         const int64_t* __restrict__ y,
                         const int64_t* __restrict__ z,
                         const int64_t* __restrict__ s, int nbits,
                         int64_t* ox, int64_t* oy, int64_t* oz, int64_t B,
                         Mod M) {
  __shared__ uint32_t tab[45 * COOP_THREADS];
  CMod C = c_mod(M);
  int64_t lane = blockIdx.x * (int64_t)(COOP_THREADS / 8) + (threadIdx.x >> 3);
  bool live = lane < B;               // the others compute lane 0 unseen:
  int64_t i = live ? lane : 0;        // every thread votes and shuffles
  CPt r = c_smul_window(c_load_pt(x, y, z, i, C.k), s + 16 * i, nbits, tab,
                        C);
  if (live) c_store_pt(ox, oy, oz, lane, C.k, r);
}

// Threads 16l .. 16l + 7 of a block run GLV half 0 of the block's lane l,
// 16l + 8 .. 16l + 15 half 1; half 0 writes the sum.
__global__ void __launch_bounds__(COOP_THREADS)
scalar_mul_glv_kernel(const int64_t* __restrict__ x,
                      const int64_t* __restrict__ y,
                      const int64_t* __restrict__ z,
                      const int64_t* __restrict__ k1,
                      const int64_t* __restrict__ k2,
                      const int64_t* __restrict__ g1,
                      const int64_t* __restrict__ g2, Fe beta, int64_t* ox,
                      int64_t* oy, int64_t* oz, int64_t B, Mod M) {
  __shared__ uint32_t tab[45 * COOP_THREADS];
  CMod C = c_mod(M);
  int h = (threadIdx.x >> 3) & 1;
  int64_t lane = blockIdx.x * (int64_t)(COOP_THREADS / 16) + (threadIdx.x >> 4);
  bool live = lane < B;
  int64_t i = live ? lane : 0;
  CPt r = c_glv_halves(c_load_pt(x, y, z, i, C.k), (h ? k2 : k1) + 16 * i,
                       h ? g2[i] : g1[i], beta.w[C.k], h, tab, C);
  if (live && !h) c_store_pt(ox, oy, oz, lane, C.k, r);
}

static unsigned grid_for(int64_t B, int lanes_per_block) {
  return (unsigned)((B + lanes_per_block - 1) / lanes_per_block);
}

extern "C" int porla_scalar_mul_window(const int64_t* x, const int64_t* y,
                                       const int64_t* z, const int64_t* s,
                                       int nbits, int64_t* ox, int64_t* oy,
                                       int64_t* oz, int64_t B,
                                       const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  scalar_mul_window_kernel<<<grid_for(B, COOP_THREADS / 8), COOP_THREADS, 0,
                             (cudaStream_t)stream>>>(x, y, z, s, nbits, ox,
                                                     oy, oz, B, M);
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
  scalar_mul_glv_kernel<<<grid_for(B, COOP_THREADS / 16), COOP_THREADS, 0,
                          (cudaStream_t)stream>>>(x, y, z, k1, k2, g1, g2,
                                                  beta, ox, oy, oz, B, M);
  return (int)cudaGetLastError();
}
