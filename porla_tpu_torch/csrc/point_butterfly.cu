// K3 point_butterfly and K7 point_butterfly_window: the MAC-mirror butterfly
// (M0 + s*M1, M0 - s*M1) per lane, with s*M1 and the two full-cased adds in
// the same kernel.
//
// - K3 (GLV, 256-bit scalars split on the host into k1 + lambda*k2 with
//   128-bit halves). Replaces porla_tpu/curves/pallas_curve.py::
//   _glv_butterfly_kernel (built by _glv_butterfly_call).
// - K7 (windowed, every other scalar width): s*M1 over the low nbits of s in
//   4-bit windows, then both adds. Replaces ::_butterfly_kernel (built by
//   _butterfly_call).
//
// Bound on this card: operations (one scalar mul, ~2,250 field products at
// 256 bits with GLV and nbits/4 * 44 plus a 16-entry table without, plus
// two adds a lane, against ~420 bytes read and written, packed). At the main
// path's 1024 lanes a lane's chain of dependent field products is the time:
// one thread's 8-word product is a chain of ~16 carry chains, and no other
// warp waits on a scheduler to hide its latency. What the design does about
// it:
// - The two GLV halves run as separate chains, k1*q1 and k2*q2, each 32
//   windows of 4 doublings and one table add (CurveOps.scalar_mul over 128
//   bits), and are added once at the end (c_glv_halves, shared with K2's GLV
//   mode). A chain is then ~1,600 field products instead of ~2,700 (the TPU
//   kernel's interleaved order shares the doublings but makes one chain do
//   both halves' adds). The Jacobian limbs differ from that order's; the
//   plain version (glv_butterfly_plain) follows this one.
// - Each chain runs on 8 neighbouring threads, thread k holding word k of
//   every field element, with its window table in shared memory
//   (porla_coop.cuh). A lane is 16 threads, 1024 lanes 16,384 threads.
// - Both groups of a lane hold the halves' sum; both add it to M0 (the same
//   operands in the same order), then one writes M0 + t and the other
//   M0 - t.
// - K7 is K2's windowed mode on the same form: one group of 8 threads a
//   lane runs c_smul_window (its table in shared memory, CurveOps.
//   scalar_mul's order), then both closing adds, so its limbs are
//   window_butterfly_plain's. A lane is 8 threads, 1024 lanes 8,192 threads.
#include <cuda_runtime.h>

#include "porla_coop.cuh"

// Threads 16l .. 16l + 7 of a block run GLV half 0 of the block's lane l,
// 16l + 8 .. 16l + 15 half 1, thread k of a group holding word k of every
// element; half 0 writes M0 + t, half 1 M0 - t.
__global__ void __launch_bounds__(COOP_THREADS)
glv_butterfly_kernel(const int64_t* __restrict__ m0x,
                     const int64_t* __restrict__ m0y,
                     const int64_t* __restrict__ m0z,
                     const int64_t* __restrict__ m1x,
                     const int64_t* __restrict__ m1y,
                     const int64_t* __restrict__ m1z,
                     const int64_t* __restrict__ k1,
                     const int64_t* __restrict__ k2,
                     const int64_t* __restrict__ g1,
                     const int64_t* __restrict__ g2, Fe beta, int64_t* hx,
                     int64_t* hy, int64_t* hz, int64_t* lx, int64_t* ly,
                     int64_t* lz, int64_t B, Mod M) {
  __shared__ uint32_t tab[45 * COOP_THREADS];
  CMod C = c_mod(M);
  int k = C.k;
  int h = (threadIdx.x >> 3) & 1;
  int64_t lane = blockIdx.x * (int64_t)(COOP_THREADS / 16) + (threadIdx.x >> 4);
  bool live = lane < B;               // the others compute lane 0 unseen:
  int64_t i = live ? lane : 0;        // every thread votes and shuffles
  CPt tt = c_glv_halves(c_load_pt(m1x, m1y, m1z, i, k),
                        (h ? k2 : k1) + 16 * i, h ? g2[i] : g1[i], beta.w[k],
                        h, tab, C);
  CPt m0 = c_load_pt(m0x, m0y, m0z, i, k);
  CPt nt = c_neg(tt, C);
  CPt r = c_padd(m0, h ? nt : tt, C);
  if (!live) return;
  c_store_pt(h ? lx : hx, h ? ly : hy, h ? lz : hz, lane, k, r);
}

// Threads 8l .. 8l + 7 of a block run lane l, thread k holding word k of
// every element: s*M1 by the windowed chain, then both closing adds.
__global__ void __launch_bounds__(COOP_THREADS)
window_butterfly_kernel(const int64_t* __restrict__ m0x,
                        const int64_t* __restrict__ m0y,
                        const int64_t* __restrict__ m0z,
                        const int64_t* __restrict__ m1x,
                        const int64_t* __restrict__ m1y,
                        const int64_t* __restrict__ m1z,
                        const int64_t* __restrict__ s, int nbits, int64_t* hx,
                        int64_t* hy, int64_t* hz, int64_t* lx, int64_t* ly,
                        int64_t* lz, int64_t B, Mod M) {
  __shared__ uint32_t tab[45 * COOP_THREADS];
  CMod C = c_mod(M);
  int k = C.k;
  int64_t lane = blockIdx.x * (int64_t)(COOP_THREADS / 8) + (threadIdx.x >> 3);
  bool live = lane < B;               // the others compute lane 0 unseen:
  int64_t i = live ? lane : 0;        // every thread votes and shuffles
  CPt t = c_smul_window(c_load_pt(m1x, m1y, m1z, i, k), s + 16 * i, nbits,
                        tab, C);
  CPt m0 = c_load_pt(m0x, m0y, m0z, i, k);
  CPt hi = c_padd(m0, t, C);
  CPt lo = c_padd(m0, c_neg(t, C), C);
  if (!live) return;
  c_store_pt(hx, hy, hz, lane, k, hi);
  c_store_pt(lx, ly, lz, lane, k, lo);
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
  int per_block = COOP_THREADS / 16;
  glv_butterfly_kernel<<<(unsigned)((B + per_block - 1) / per_block),
                         COOP_THREADS, 0, (cudaStream_t)stream>>>(
      m0x, m0y, m0z, m1x, m1y, m1z, k1, k2, g1, g2, beta, hx, hy, hz, lx, ly,
      lz, B, M);
  return (int)cudaGetLastError();
}

extern "C" int porla_point_butterfly_window(
    const int64_t* m0x, const int64_t* m0y, const int64_t* m0z,
    const int64_t* m1x, const int64_t* m1y, const int64_t* m1z,
    const int64_t* s, int nbits, int64_t* hx, int64_t* hy, int64_t* hz,
    int64_t* lx, int64_t* ly, int64_t* lz, int64_t B, const uint32_t* mod17,
    void* stream) {
  Mod M = mod_from_words(mod17);
  int per_block = COOP_THREADS / 8;
  unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  window_butterfly_kernel<<<blocks, COOP_THREADS, 0, (cudaStream_t)stream>>>(
      m0x, m0y, m0z, m1x, m1y, m1z, s, nbits, hx, hy, hz, lx, ly, lz, B, M);
  return (int)cudaGetLastError();
}
