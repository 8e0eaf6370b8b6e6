// Cooperative field and point arithmetic of the curve kernels K2, K3, K7
// and group_sum: one field element on 8 neighbouring threads (a group),
// thread k holding its 32-bit word k, so that a chain of dependent field
// products, which is the time of a scalar mul at the protocol's lane counts
// (and of a tree of adds), runs at the latency of a few warp shuffles a row
// instead of one thread's 16 carry chains.
//
// - A product is fe_mul's CIOS with the operand's words and the reduction
//   factor passed by warp shuffles; a carry chain is resolved at once from
//   two warp votes (the words that generate a carry and those that pass one
//   on); a zero test is one vote. Every value stays canonical, so the words
//   are those of the one-thread formulas (porla_field.cuh) and of the plain
//   torch versions.
// - A group's 15-entry window table (1d .. 15d; 0d is infinity; the TPU
//   kernels' _build_table and _lookup) lies in shared memory, word-major
//   with the thread fastest, so that the groups' digit-dependent reads do
//   not conflict.
// - Every shuffle and vote names the whole warp, so no call that holds one
//   may sit under a condition that splits a warp: a ragged block computes
//   lane 0 unseen in its dead lanes, and the doubling case of an add runs
//   where any lane of the warp needs it and is selected where its own does.
//
// Kernels that include this header run COOP_THREADS threads a block.
#pragma once
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define FULL 0xffffffffu
#define COOP_THREADS 128

// A thread's share of the modulus: its word k of n and of R mod n, -n^-1
// mod 2^32, and the warp lane of its group's word 0
struct CMod {
  uint32_t n, one, ninv;
  int k, base;
};

__device__ __forceinline__ CMod c_mod(const Mod& M) {
  CMod C;
  C.k = threadIdx.x & 7;
  C.base = threadIdx.x & 24;
  C.n = M.n[C.k];
  C.one = M.one[C.k];
  C.ninv = M.ninv;
  return C;
}

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

// Word k of an element in the port's (…, 16) int64 limb layout, and back
__device__ __forceinline__ uint32_t c_word(const int64_t* p, int k) {
  return (uint32_t)p[2 * k] | ((uint32_t)p[2 * k + 1] << 16);
}

__device__ __forceinline__ void c_store(int64_t* p, int k, uint32_t w) {
  p[2 * k] = (int64_t)(w & 0xFFFFu);
  p[2 * k + 1] = (int64_t)(w >> 16);
}

__device__ __forceinline__ CPt c_load_pt(const int64_t* x, const int64_t* y,
                                         const int64_t* z, int64_t i, int k) {
  return CPt{c_word(x + 16 * i, k), c_word(y + 16 * i, k),
             c_word(z + 16 * i, k)};
}

__device__ __forceinline__ void c_store_pt(int64_t* x, int64_t* y, int64_t* z,
                                           int64_t i, int k, const CPt& v) {
  c_store(x + 16 * i, k, v.x);
  c_store(y + 16 * i, k, v.y);
  c_store(z + 16 * i, k, v.z);
}

// Entry d (1..15) of the calling group's table: word-major, thread fastest.
// A table is 45 * COOP_THREADS words of shared memory.
__device__ __forceinline__ uint32_t* c_entry(uint32_t* tab, int d) {
  return tab + (d - 1) * 3 * COOP_THREADS + threadIdx.x;
}

__device__ __forceinline__ void c_put(uint32_t* e, const CPt& v) {
  e[0] = v.x;
  e[COOP_THREADS] = v.y;
  e[2 * COOP_THREADS] = v.z;
}

__device__ __forceinline__ CPt c_get(const uint32_t* e) {
  return CPt{e[0], e[COOP_THREADS], e[2 * COOP_THREADS]};
}

// CurveOps.scalar_mul's windowed (4-bit, MSB-first) scalar mul over the low
// nbits of s (16 int64 limbs): the table 1q .. 15q (odd entries by a
// full-cased add, even ones by a doubling), then nbits/4 windows of 4
// doublings and one full-cased add of the digit's entry. nbits must be
// uniform across the warp.
__device__ __forceinline__ CPt c_smul_window(CPt q, const int64_t* s,
                                             int nbits, uint32_t* tab,
                                             const CMod& C) {
  c_put(c_entry(tab, 1), q);
  for (int d = 2; d < 16; d++) {
    CPt v = (d & 1) ? c_padd(c_get(c_entry(tab, d - 1)), q, C)
                    : c_dbl(c_get(c_entry(tab, d >> 1)), C);
    c_put(c_entry(tab, d), v);
  }
  CPt acc = c_inf(C);
  for (int w = nbits / 4 - 1; w >= 0; w--) {
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    acc = c_dbl(acc, C);
    int d = nibble(s, w);
    CPt e = d ? c_get(c_entry(tab, d)) : c_inf(C);
    acc = c_padd(acc, e, C);
  }
  return acc;
}

// k*q for a GLV split k = (±k1) + lambda (±k2), on a lane's 16 threads:
// group h = 0 runs k1 * (±q), group h = 1 runs k2 * (±phi(q)), phi(x, y) =
// (beta x, y), each by the windowed scalar mul over 128 bits (its own chain
// and table); the halves then meet by a shuffle across the two groups and
// both add them, half 0 first, so both groups return the same point
// (cuda_curve.glv_halves_plain's order). beta_k is word k of beta's
// Montgomery form; s is the group's half (k1 or k2), g its sign flag.
__device__ __forceinline__ CPt c_glv_halves(CPt q, const int64_t* s, int64_t g,
                                            uint32_t beta_k, int h,
                                            uint32_t* tab, const CMod& C) {
  uint32_t xb = c_mul(q.x, beta_k, C);
  if (h) q.x = xb;
  CPt nq = c_neg(q, C);
  q = c_sel(g != 0, nq, q);
  CPt acc = c_smul_window(q, s, 128, tab, C);
  CPt o{__shfl_xor_sync(FULL, acc.x, 8), __shfl_xor_sync(FULL, acc.y, 8),
        __shfl_xor_sync(FULL, acc.z, 8)};
  return c_padd(c_sel(h, o, acc), c_sel(h, acc, o), C);
}
