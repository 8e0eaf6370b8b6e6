// K3 point_butterfly and K7 point_butterfly_window: the MAC-mirror butterfly
// (M0 + s*M1, M0 - s*M1) per lane, with s*M1 and the two full-cased adds in
// the same kernel.
//
// - K3 (GLV, 256-bit scalars split on the host into k1 + lambda*k2 with
//   128-bit halves). Replaces porla_tpu/curves/pallas_curve.py::
//   _glv_butterfly_kernel (built by _glv_butterfly_call).
// - K7 (windowed, every other scalar width): s*M1 over the low nbits of s in
//   4-bit windows, one thread a lane. Replaces ::_butterfly_kernel (built by
//   _butterfly_call).
//
// Bound on this card: operations (one scalar mul, ~2,250 field products at
// 256 bits with GLV and nbits/4 * 44 plus a 16-entry table without, plus
// two adds a lane, against ~420 bytes read and written, packed). At the main
// path's 1024 lanes a lane's chain of dependent field products is the time:
// one thread's 8-word product is a chain of ~16 carry chains, and no other
// warp waits on a scheduler to hide its latency. What K3's design does about
// it:
// - The two GLV halves run as separate chains, k1*q1 and k2*q2, each 32
//   windows of 4 doublings and one table add (CurveOps.scalar_mul over 128
//   bits), and are added once at the end. A chain is then ~1,600 field
//   products instead of ~2,700 (the TPU kernel's interleaved order shares
//   the doublings but makes one chain do both halves' adds). The Jacobian
//   limbs differ from that order's; the plain version (glv_butterfly_plain)
//   follows this one.
// - Each chain runs on 8 neighbouring threads, thread k holding word k of
//   every field element (cooperative arithmetic): a product is CIOS with the
//   operand's words and the reduction factor passed by warp shuffles, a
//   carry chain is resolved at once from two warp votes (the words that
//   generate a carry and those that pass one on), and a zero test is one
//   vote. Every value stays canonical, so the words are those of the
//   one-thread formulas. A lane is 16 threads, 1024 lanes 16,384 threads.
// - A group's 15-entry table (1d .. 15d; 0d is infinity) lies in shared
//   memory, word-major with the thread fastest, so that the groups'
//   digit-dependent reads do not conflict; the per-lane tables of K2 and K7
//   live in local memory.
// - The halves meet by a shuffle across the lane's two groups; both add
//   them (the same operands in the same order), then one writes M0 + t and
//   the other M0 - t.
// - Every shuffle and vote names the whole warp, so no call that holds one
//   sits under a condition that splits a warp: the doubling case of an add
//   runs where any lane of the warp needs it and is selected where its own
//   does.
#include <cuda_runtime.h>

#include "porla_field.cuh"

// --- K3: cooperative field arithmetic, 8 neighbouring threads an element,
// thread k holding word k ---
#define FULL 0xffffffffu
#define K3_THREADS 128               // 8 lanes a block, 16 threads a lane

// A thread's share of the modulus: its word k of n and of R mod n, -n^-1
// mod 2^32, and the warp lane of its group's word 0
struct CMod {
  uint32_t n, one, ninv;
  int k, base;
};

// The group's 8 bits of a warp vote
__device__ __forceinline__ uint32_t seg_of(uint32_t ballot, const CMod& C) {
  return (ballot >> C.base) & 0xFFu;
}

// The carry (borrow) into word k of a chain whose words generate one (`gen`)
// or pass one on (`prop`, disjoint from gen): adding gen << 1 to prop runs
// every carry through the propagating words at once. `top` gets the carry
// out of word 7.
__device__ __forceinline__ uint32_t chain_in(uint32_t gen, uint32_t prop,
                                             int k, uint32_t& top) {
  uint32_t s = (gen << 1) + prop;
  top = (s >> 8) & 1u;
  return ((s ^ prop) >> k) & 1u;
}

// top * 2^256 + s < 2n -> mod n (cond_sub)
__device__ __forceinline__ uint32_t c_cond_sub(uint32_t s, uint32_t top,
                                               const CMod& C) {
  uint32_t gen = seg_of(__ballot_sync(FULL, s < C.n), C);
  uint32_t prop = seg_of(__ballot_sync(FULL, s == C.n), C);
  uint32_t bw;
  uint32_t d = s - C.n - chain_in(gen, prop, C.k, bw);
  return (top || !bw) ? d : s;
}

// fe_add and fe_sub
__device__ __forceinline__ uint32_t c_add(uint32_t a, uint32_t b,
                                          const CMod& C) {
  uint32_t s = a + b;
  uint32_t gen = seg_of(__ballot_sync(FULL, s < a), C);
  uint32_t prop = seg_of(__ballot_sync(FULL, s == 0xFFFFFFFFu), C);
  uint32_t top;
  s += chain_in(gen, prop, C.k, top);
  return c_cond_sub(s, top, C);
}

__device__ __forceinline__ uint32_t c_sub(uint32_t a, uint32_t b,
                                          const CMod& C) {
  uint32_t gen = seg_of(__ballot_sync(FULL, a < b), C);
  uint32_t prop = seg_of(__ballot_sync(FULL, a == b), C);
  uint32_t bw;
  uint32_t d = a - b - chain_in(gen, prop, C.k, bw);
  uint32_t f = d + C.n;
  uint32_t g2 = seg_of(__ballot_sync(FULL, f < d), C);
  uint32_t p2 = seg_of(__ballot_sync(FULL, f == 0xFFFFFFFFu), C);
  uint32_t t2;
  f += chain_in(g2, p2, C.k, t2);
  return bw ? f : d;
}

__device__ __forceinline__ bool c_is_zero(uint32_t a, const CMod& C) {
  return seg_of(__ballot_sync(FULL, a != 0), C) == 0;
}

__device__ __forceinline__ bool c_eq(uint32_t a, uint32_t b, const CMod& C) {
  return seg_of(__ballot_sync(FULL, a != b), C) == 0;
}

// fe_mul's CIOS over the 8 threads, the same integers, so the same result.
// T = sum_k (t_k + c_k 2^32) 2^(32k): thread k holds word k and the carry c_k
// into word k + 1. A row adds b_i * a and m * n (m from word 0, broadcast),
// then shifts T down a word: word k takes word k + 1's low half and its own
// carries. The carries are resolved once, after the last row.
__device__ __forceinline__ uint32_t c_mul(uint32_t a, uint32_t b,
                                          const CMod& C) {
  uint32_t t = 0, c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t bi = __shfl_sync(FULL, b, i, 8);
    uint64_t v1 = (uint64_t)a * bi + t;
    uint32_t l1 = (uint32_t)v1;
    uint32_t m = __shfl_sync(FULL, l1, 0, 8) * C.ninv;
    uint64_t v2 = (uint64_t)m * C.n + l1;
    uint64_t H = (v1 >> 32) + (v2 >> 32) + c;
    uint32_t up = __shfl_down_sync(FULL, (uint32_t)v2, 1, 8);
    if (C.k == 7) up = 0;
    uint64_t nt = H + up;
    t = (uint32_t)nt;
    c = (uint32_t)(nt >> 32);
  }
  uint32_t cin = __shfl_up_sync(FULL, c, 1, 8);
  if (C.k == 0) cin = 0;
  uint32_t top = __shfl_sync(FULL, c, 7, 8);
  uint32_t s = t + cin;
  uint32_t gen = seg_of(__ballot_sync(FULL, s < t), C);
  uint32_t prop = seg_of(__ballot_sync(FULL, s == 0xFFFFFFFFu), C);
  uint32_t top2;
  s += chain_in(gen, prop, C.k, top2);
  return c_cond_sub(s, top + top2, C);
}

struct CPt {
  uint32_t x, y, z;
};

__device__ __forceinline__ CPt c_inf(const CMod& C) {
  return CPt{C.one, C.one, 0u};
}

__device__ __forceinline__ CPt c_sel(bool c, const CPt& a, const CPt& b) {
  return CPt{c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z};
}

__device__ __forceinline__ CPt c_neg(const CPt& p, const CMod& C) {
  return CPt{p.x, c_sub(0u, p.y, C), p.z};
}

// pt_dbl's formulas and order
static __device__ __noinline__ CPt c_dbl(CPt p, CMod C) {
  uint32_t A = c_mul(p.x, p.x, C);
  uint32_t Bq = c_mul(p.y, p.y, C);
  uint32_t Cc = c_mul(Bq, Bq, C);
  uint32_t xb = c_add(p.x, Bq, C);
  uint32_t xb2 = c_mul(xb, xb, C);
  uint32_t YZ = c_mul(p.y, p.z, C);
  uint32_t D = c_sub(c_sub(xb2, A, C), Cc, C);
  D = c_add(D, D, C);
  uint32_t E = c_add(c_add(A, A, C), A, C);
  uint32_t F = c_mul(E, E, C);
  CPt r;
  r.x = c_sub(F, c_add(D, D, C), C);
  uint32_t C2 = c_add(Cc, Cc, C);
  uint32_t C4 = c_add(C2, C2, C);
  uint32_t C8 = c_add(C4, C4, C);
  r.y = c_sub(c_mul(E, c_sub(D, r.x, C), C), C8, C);
  r.z = c_add(YZ, YZ, C);
  return r;
}

// pt_add's formulas, cases and order (the doubling where any lane of the
// warp needs it, selected where this one does)
static __device__ __noinline__ CPt c_padd(CPt p1, CPt p2, CMod C) {
  uint32_t Z1Z1 = c_mul(p1.z, p1.z, C);
  uint32_t Z2Z2 = c_mul(p2.z, p2.z, C);
  uint32_t A1 = c_mul(p1.y, p2.z, C);
  uint32_t A2 = c_mul(p2.y, p1.z, C);
  uint32_t U1 = c_mul(p1.x, Z2Z2, C);
  uint32_t U2 = c_mul(p2.x, Z1Z1, C);
  uint32_t S1 = c_mul(A1, Z2Z2, C);
  uint32_t S2 = c_mul(A2, Z1Z1, C);
  uint32_t H = c_sub(U2, U1, C);
  uint32_t R = c_sub(S2, S1, C);
  uint32_t HH = c_mul(H, H, C);
  uint32_t RR = c_mul(R, R, C);
  uint32_t Z1Z2 = c_mul(p1.z, p2.z, C);
  uint32_t HHH = c_mul(H, HH, C);
  uint32_t V = c_mul(U1, HH, C);
  CPt raw;
  raw.z = c_mul(Z1Z2, H, C);
  raw.x = c_sub(c_sub(RR, HHH, C), c_add(V, V, C), C);
  raw.y = c_sub(c_mul(R, c_sub(V, raw.x, C), C), c_mul(S1, HHH, C), C);
  bool p1_inf = c_is_zero(p1.z, C);
  bool p2_inf = c_is_zero(p2.z, C);
  bool h_zero = c_eq(U1, U2, C);
  bool r_zero = c_eq(S1, S2, C);
  bool both = !p1_inf && !p2_inf;
  bool dbl_case = both && h_zero && r_zero;
  bool inf_case = both && h_zero && !r_zero;
  CPt out = raw;
  if (__any_sync(FULL, dbl_case)) {
    CPt d = c_dbl(p1, C);
    out = c_sel(dbl_case, d, out);
  }
  out = c_sel(inf_case, c_inf(C), out);
  out = c_sel(p2_inf, p1, out);
  out = c_sel(p1_inf, p2, out);
  return out;
}

__device__ __forceinline__ uint32_t c_word(const int64_t* p, int k) {
  return (uint32_t)p[2 * k] | ((uint32_t)p[2 * k + 1] << 16);
}

__device__ __forceinline__ void c_store(int64_t* p, int k, uint32_t w) {
  p[2 * k] = (int64_t)(w & 0xFFFFu);
  p[2 * k + 1] = (int64_t)(w >> 16);
}

// Entry d (1..15) of the calling group's table: word-major, thread fastest
__device__ __forceinline__ uint32_t* c_entry(uint32_t* tab, int d) {
  return tab + (d - 1) * 3 * K3_THREADS + threadIdx.x;
}

__device__ __forceinline__ void c_put(uint32_t* e, const CPt& v) {
  e[0] = v.x;
  e[K3_THREADS] = v.y;
  e[2 * K3_THREADS] = v.z;
}

__device__ __forceinline__ CPt c_get(const uint32_t* e) {
  return CPt{e[0], e[K3_THREADS], e[2 * K3_THREADS]};
}

// Threads 16l .. 16l + 7 of a block run GLV half 0 of the block's lane l,
// 16l + 8 .. 16l + 15 half 1, thread k of a group holding word k of every
// element; half 0 writes M0 + t, half 1 M0 - t.
__global__ void __launch_bounds__(K3_THREADS)
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
  __shared__ uint32_t tab[45 * K3_THREADS];
  CMod C;
  C.k = threadIdx.x & 7;
  C.base = threadIdx.x & 24;
  C.n = M.n[C.k];
  C.one = M.one[C.k];
  C.ninv = M.ninv;
  int k = C.k;
  int h = (threadIdx.x >> 3) & 1;
  int64_t lane = blockIdx.x * (int64_t)(K3_THREADS / 16) + (threadIdx.x >> 4);
  bool live = lane < B;               // the others compute lane 0 unseen:
  int64_t i = live ? lane : 0;        // every thread votes and shuffles
  CPt q{c_word(m1x + 16 * i, k), c_word(m1y + 16 * i, k),
        c_word(m1z + 16 * i, k)};
  uint32_t xb = c_mul(q.x, beta.w[k], C);
  if (h) q.x = xb;
  CPt nq = c_neg(q, C);
  q = c_sel((h ? g2[i] : g1[i]) != 0, nq, q);
  const int64_t* s = (h ? k2 : k1) + 16 * i;
  c_put(c_entry(tab, 1), q);
  for (int d = 2; d < 16; d++) {
    CPt v = (d & 1) ? c_padd(c_get(c_entry(tab, d - 1)), q, C)
                    : c_dbl(c_get(c_entry(tab, d >> 1)), C);
    c_put(c_entry(tab, d), v);
  }
  CPt acc = c_inf(C);
  for (int w = 31; w >= 0; w--) {
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    int d = nibble(s, w);
    CPt e = d ? c_get(c_entry(tab, d)) : c_inf(C);
    acc = c_padd(acc, e, C);
  }
  CPt o{__shfl_xor_sync(FULL, acc.x, 8), __shfl_xor_sync(FULL, acc.y, 8),
        __shfl_xor_sync(FULL, acc.z, 8)};
  CPt tt = c_padd(c_sel(h, o, acc), c_sel(h, acc, o), C);   // half 0 first
  CPt m0{c_word(m0x + 16 * i, k), c_word(m0y + 16 * i, k),
         c_word(m0z + 16 * i, k)};
  CPt nt = c_neg(tt, C);
  CPt r = c_padd(m0, h ? nt : tt, C);
  if (!live) return;
  int64_t* ox = h ? lx : hx;
  int64_t* oy = h ? ly : hy;
  int64_t* oz = h ? lz : hz;
  c_store(ox + 16 * lane, k, r.x);
  c_store(oy + 16 * lane, k, r.y);
  c_store(oz + 16 * lane, k, r.z);
}

__global__ void __launch_bounds__(128)
window_butterfly_kernel(const int64_t* __restrict__ m0x,
                        const int64_t* __restrict__ m0y,
                        const int64_t* __restrict__ m0z,
                        const int64_t* __restrict__ m1x,
                        const int64_t* __restrict__ m1y,
                        const int64_t* __restrict__ m1z,
                        const int64_t* __restrict__ s, int nbits, int64_t* hx,
                        int64_t* hy, int64_t* hz, int64_t* lx, int64_t* ly,
                        int64_t* lz, int64_t B, Mod M) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= B) return;
  Pt t = pt_smul_window(pt_load(m1x, m1y, m1z, i), s + 16 * i, nbits, M);
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
  int per_block = K3_THREADS / 16;
  glv_butterfly_kernel<<<(unsigned)((B + per_block - 1) / per_block),
                         K3_THREADS, 0, (cudaStream_t)stream>>>(
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
  unsigned blocks = (unsigned)((B + 127) / 128);
  window_butterfly_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      m0x, m0y, m0z, m1x, m1y, m1z, s, nbits, hx, hy, hz, lx, ly, lz, B, M);
  return (int)cudaGetLastError();
}
