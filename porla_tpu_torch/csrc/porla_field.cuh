// Shared device functions of the port's Hopper kernels: 256-bit Montgomery
// field arithmetic over 8 x 32-bit words and branchless Jacobian point ops
// for a = 0 short-Weierstrass curves (secp256k1, BN254 G1).
//
// Replaces the in-kernel helpers of the TPU kernels
// (porla_tpu/curves/pallas_curve.py: _f_mul, _p_dbl, _p_add, _p_madd,
// _build_table, _lookup; porla_tpu/ntt/pallas_stage.py: _add_mod, _sub_mod,
// _cond_sub). The TPU computed a field product as a bf16 Toeplitz matrix
// product over byte digits because its matrix unit is its only fast
// multiplier; Hopper has a native 32x32->64-bit integer multiply-add, so a
// product is plain CIOS Montgomery over 8 words (64 word products for a*b
// plus 64 for the reduction) held entirely in registers.
//
// The public tensor layout is the port's (…, 16) int64 limbs of 16 bits;
// fe_load/fe_store pack and unpack them. R = 2^256 in both layouts, so a
// Montgomery value is the same integer in the kernel and in the plain
// torch arithmetic (fields/mont.py).
//
// The header also compiles as plain C++ (no __CUDACC__), which lets the
// arithmetic be exercised on a host without a GPU.
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#define __device__
#define __host__
#define __forceinline__ inline
#endif

#define PORLA_HD __host__ __device__ __forceinline__
// Point operations stay out of line on the device: inlining every field
// product of every point op would make each kernel tens of thousands of
// instructions, past the instruction cache and slow to compile.
#ifdef __CUDACC__
#define PORLA_PT static __device__ __noinline__
#else
#define PORLA_PT static
#endif

struct Mod {
  uint32_t n[8];   // modulus, little-endian words
  uint32_t ninv;   // -n^-1 mod 2^32
  uint32_t one[8]; // R mod n (Montgomery form of 1): infinity is (one, one, 0)
};

struct Fe {
  uint32_t w[8];
};

struct Pt {
  Fe x, y, z;
};

PORLA_HD Fe fe_load(const int64_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++)
    r.w[i] = (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 16);
  return r;
}

PORLA_HD void fe_store(int64_t* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p[2 * i] = (int64_t)(a.w[i] & 0xFFFFu);
    p[2 * i + 1] = (int64_t)(a.w[i] >> 16);
  }
}

PORLA_HD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0;
  return r;
}

PORLA_HD Fe fe_from_words(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = w[i];
  return r;
}

PORLA_HD bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i];
  return acc == 0;
}

PORLA_HD bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

PORLA_HD Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
  uint32_t m = 0u - (uint32_t)c;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
  return r;
}

// r = a - n; returns the borrow out (1 when a < n)
PORLA_HD uint32_t sub_n(Fe& r, const Fe& a, const uint32_t* n) {
  uint64_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.w[i] - n[i] - bw;
    r.w[i] = (uint32_t)d;
    bw = (d >> 32) & 1;
  }
  return (uint32_t)bw;
}

// value = top*2^256 + a < 2n  ->  value mod n
PORLA_HD Fe cond_sub(const Fe& a, uint32_t top, const Mod& M) {
  Fe d;
  uint32_t bw = sub_n(d, a, M.n);
  return fe_sel(top != 0 || bw == 0, d, a);
}

PORLA_HD Fe fe_add(const Fe& a, const Fe& b, const Mod& M) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return cond_sub(s, (uint32_t)c, M);
}

PORLA_HD Fe fe_sub(const Fe& a, const Fe& b, const Mod& M) {
  Fe d;
  uint64_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - bw;
    d.w[i] = (uint32_t)t;
    bw = (t >> 32) & 1;
  }
  Fe f;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)d.w[i] + M.n[i];
    f.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_sel(bw != 0, f, d);
}

#ifdef __CUDA_ARCH__
// The device form of fe_mul keeps its running sum T as two 9-word arrays,
// T = X + 2^32 * Y, and adds a row a * b as two independent carry chains of
// multiply-adds: the even words' products land on (x0,x1) .. (x6,x7), the odd
// words' on (y0,y1) .. (y6,y7). A product's low and high word are then
// neighbours in an aligned register pair of its chain, so each pair compiles
// to one wide multiply-add with carry and no moves; the 64-bit C form of the
// same row costs three instructions a product.
__device__ __forceinline__ void mac_pair(uint32_t (&x)[9], uint32_t (&y)[9],
                                         const uint32_t* a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8])
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]),
        "+r"(y[5]), "+r"(y[6]), "+r"(y[7]), "+r"(y[8])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// The same row fused with T's shift down by one word (x0 is 0 after a
// reduction row): the old Y becomes the new X in place, taking the old X's
// word 1 into its word 0, whose carry has the weight of the new Y's word 0
// and starts that chain; the new Y is the old X from word 2 on.
__device__ __forceinline__ void mac_shift(uint32_t (&x)[9], uint32_t (&yn)[9],
                                          const uint32_t (&o)[9],
                                          const uint32_t* a, uint32_t b) {
  asm("add.cc.u32 %9, %9, %10;\n\t"
      "madc.lo.cc.u32 %0, %18, %22, %11;\n\t"
      "madc.hi.cc.u32 %1, %18, %22, %12;\n\t"
      "madc.lo.cc.u32 %2, %19, %22, %13;\n\t"
      "madc.hi.cc.u32 %3, %19, %22, %14;\n\t"
      "madc.lo.cc.u32 %4, %20, %22, %15;\n\t"
      "madc.hi.cc.u32 %5, %20, %22, %16;\n\t"
      "madc.lo.cc.u32 %6, %21, %22, %17;\n\t"
      "madc.hi.cc.u32 %7, %21, %22, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(yn[0]), "=&r"(yn[1]), "=&r"(yn[2]), "=&r"(yn[3]), "=&r"(yn[4]),
        "=&r"(yn[5]), "=&r"(yn[6]), "=&r"(yn[7]), "=&r"(yn[8]), "+r"(x[0])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
        "r"(o[7]), "r"(o[8]), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]),
        "r"(b));
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8])
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
}
#endif

// Montgomery product a*b*2^-256 mod n (CIOS). One operand may be any
// 256-bit value, the other canonical: the result is then < 2n before the
// final conditional subtract, and canonical after it. The device and the
// host form compute the same integers word for word.
PORLA_HD Fe fe_mul(const Fe& a, const Fe& b, const Mod& M) {
#ifdef __CUDA_ARCH__
  uint32_t x[9], y[9];
#pragma unroll
  for (int j = 0; j < 9; j++) x[j] = y[j] = 0;
  mac_pair(x, y, a.w, b.w[0]);
  mac_pair(x, y, M.n, x[0] * M.ninv);      // x0 becomes 0
#pragma unroll
  for (int i = 1; i < 8; i++) {
    uint32_t yn[9];
    mac_shift(y, yn, x, a.w, b.w[i]);
#pragma unroll
    for (int j = 0; j < 9; j++) x[j] = y[j], y[j] = yn[j];
    mac_pair(x, y, M.n, x[0] * M.ninv);
  }
  // T / 2^32 = Y + X from word 1 on
  uint32_t t[9];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (uint64_t)y[j] + x[j + 1];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[8] = y[8] + (uint32_t)c;
#else
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * M.ninv;
    c = ((uint64_t)t[0] + (uint64_t)m * M.n[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * M.n[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
#endif
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = t[j];
  return cond_sub(r, t[8], M);
}

// --- points -------------------------------------------------------------

PORLA_HD Pt pt_sel(bool c, const Pt& a, const Pt& b) {
  Pt r;
  r.x = fe_sel(c, a.x, b.x);
  r.y = fe_sel(c, a.y, b.y);
  r.z = fe_sel(c, a.z, b.z);
  return r;
}

PORLA_HD Pt pt_inf(const Mod& M) {
  Pt r;
  r.x = fe_from_words(M.one);
  r.y = r.x;
  r.z = fe_zero();
  return r;
}

PORLA_HD Pt pt_neg(const Pt& p, const Mod& M) {
  Pt r = p;
  r.y = fe_sub(fe_zero(), p.y, M);
  return r;
}

// dbl-2009-l (a = 0); infinity -> infinity and y = 0 -> infinity (Z3 = 2YZ)
PORLA_PT Pt pt_dbl(const Pt& p, const Mod& M) {
  Fe A = fe_mul(p.x, p.x, M);
  Fe B = fe_mul(p.y, p.y, M);
  Fe C = fe_mul(B, B, M);
  Fe xb = fe_add(p.x, B, M);
  Fe xb2 = fe_mul(xb, xb, M);
  Fe YZ = fe_mul(p.y, p.z, M);
  Fe D = fe_sub(fe_sub(xb2, A, M), C, M);
  D = fe_add(D, D, M);
  Fe E = fe_add(fe_add(A, A, M), A, M);
  Fe F = fe_mul(E, E, M);
  Pt r;
  r.x = fe_sub(F, fe_add(D, D, M), M);
  Fe C2 = fe_add(C, C, M);
  Fe C4 = fe_add(C2, C2, M);
  Fe C8 = fe_add(C4, C4, M);
  r.y = fe_sub(fe_mul(E, fe_sub(D, r.x, M), M), C8, M);
  r.z = fe_add(YZ, YZ, M);
  return r;
}

// The degenerate cases of an addition, resolved branchlessly: the doubling
// is computed for every lane and selected where P == Q.
PORLA_PT Pt pt_cases(const Pt& raw, const Pt& p1, const Pt& p2,
                     const Fe& U1, const Fe& U2, const Fe& S1, const Fe& S2,
                     const Mod& M) {
  bool p1_inf = fe_is_zero(p1.z);
  bool p2_inf = fe_is_zero(p2.z);
  bool h_zero = fe_eq(U1, U2);
  bool r_zero = fe_eq(S1, S2);
  bool both = !p1_inf && !p2_inf;
  bool dbl_case = both && h_zero && r_zero;
  bool inf_case = both && h_zero && !r_zero;
  Pt out = pt_sel(dbl_case, pt_dbl(p1, M), raw);
  out = pt_sel(inf_case, pt_inf(M), out);
  out = pt_sel(p2_inf, p1, out);
  out = pt_sel(p1_inf, p2, out);
  return out;
}

// The products of an addition, shared by its raw and its full-cased form.
struct AddTerms {
  Fe U1, U2, S1, S2;
};

// add-2007-bl without any case handling (12M + 4S): wrong where either side
// is infinity or P == +-Q
PORLA_HD Pt add_core(const Pt& p1, const Pt& p2, AddTerms& t, const Mod& M) {
  Fe Z1Z1 = fe_mul(p1.z, p1.z, M);
  Fe Z2Z2 = fe_mul(p2.z, p2.z, M);
  Fe A1 = fe_mul(p1.y, p2.z, M);
  Fe A2 = fe_mul(p2.y, p1.z, M);
  t.U1 = fe_mul(p1.x, Z2Z2, M);
  t.U2 = fe_mul(p2.x, Z1Z1, M);
  t.S1 = fe_mul(A1, Z2Z2, M);
  t.S2 = fe_mul(A2, Z1Z1, M);
  Fe H = fe_sub(t.U2, t.U1, M);
  Fe R = fe_sub(t.S2, t.S1, M);
  Fe HH = fe_mul(H, H, M);
  Fe RR = fe_mul(R, R, M);
  Fe Z1Z2 = fe_mul(p1.z, p2.z, M);
  Fe HHH = fe_mul(H, HH, M);
  Fe V = fe_mul(t.U1, HH, M);
  Pt raw;
  raw.z = fe_mul(Z1Z2, H, M);
  raw.x = fe_sub(fe_sub(RR, HHH, M), fe_add(V, V, M), M);
  raw.y = fe_sub(fe_mul(R, fe_sub(V, raw.x, M), M), fe_mul(t.S1, HHH, M), M);
  return raw;
}

// Mixed add without case handling (8M + 3S): p2 is affine (its z is not
// read), so the products by Z2 collapse to identities
PORLA_HD Pt madd_core(const Pt& p1, const Pt& p2, AddTerms& t, const Mod& M) {
  Fe Z1Z1 = fe_mul(p1.z, p1.z, M);
  Fe A2 = fe_mul(p2.y, p1.z, M);
  t.U1 = p1.x;
  t.S1 = p1.y;
  t.U2 = fe_mul(p2.x, Z1Z1, M);
  t.S2 = fe_mul(A2, Z1Z1, M);
  Fe H = fe_sub(t.U2, t.U1, M);
  Fe R = fe_sub(t.S2, t.S1, M);
  Fe HH = fe_mul(H, H, M);
  Fe RR = fe_mul(R, R, M);
  Fe HHH = fe_mul(H, HH, M);
  Fe V = fe_mul(t.U1, HH, M);
  Pt raw;
  raw.z = fe_mul(p1.z, H, M);
  raw.x = fe_sub(fe_sub(RR, HHH, M), fe_add(V, V, M), M);
  raw.y = fe_sub(fe_mul(R, fe_sub(V, raw.x, M), M), fe_mul(t.S1, HHH, M), M);
  return raw;
}

// The raw adds of the bucket kernels: the caller guarantees that neither
// operand is infinity and that P != +-Q (blinded buckets)
PORLA_PT Pt pt_add_raw(const Pt& p1, const Pt& p2, const Mod& M) {
  AddTerms t;
  return add_core(p1, p2, t, M);
}

PORLA_PT Pt pt_madd_raw(const Pt& p1, const Pt& p2, const Mod& M) {
  AddTerms t;
  return madd_core(p1, p2, t, M);
}

// add-2007-bl with every case handled (infinity on either side, P == Q,
// P == -Q)
PORLA_PT Pt pt_add(const Pt& p1, const Pt& p2, const Mod& M) {
  AddTerms t;
  Pt raw = add_core(p1, p2, t, M);
  return pt_cases(raw, p1, p2, t.U1, t.U2, t.S1, t.S2, M);
}

// Mixed add with every case handled: p2 affine or infinity (Z2 in {0, R}),
// 11 field products instead of 16
PORLA_PT Pt pt_madd(const Pt& p1, const Pt& p2, const Mod& M) {
  AddTerms t;
  Pt raw = madd_core(p1, p2, t, M);
  return pt_cases(raw, p1, p2, t.U1, t.U2, t.S1, t.S2, M);
}

// T[d] = d*P for d in 0..15 (T[0] = infinity)
PORLA_PT void pt_table16(Pt* tbl, const Pt& p, const Mod& M) {
  tbl[0] = pt_inf(M);
  tbl[1] = p;
  for (int d = 2; d < 16; d++)
    tbl[d] = (d & 1) ? pt_add(tbl[d - 1], p, M) : pt_dbl(tbl[d >> 1], M);
}

PORLA_HD Pt pt_load(const int64_t* x, const int64_t* y, const int64_t* z,
                    int64_t i) {
  Pt r;
  r.x = fe_load(x + 16 * i);
  r.y = fe_load(y + 16 * i);
  r.z = fe_load(z + 16 * i);
  return r;
}

PORLA_HD void pt_store(int64_t* x, int64_t* y, int64_t* z, int64_t i,
                       const Pt& p) {
  fe_store(x + 16 * i, p.x);
  fe_store(y + 16 * i, p.y);
  fe_store(z + 16 * i, p.z);
}

// Field elements held as 8 x 32-bit words `stride` words apart, and points
// as x, y, z of 8 such words each (24 words): the lane-fastest layouts of the
// MSM kernels' packed points and lane partials, where a warp's accesses to
// one word are contiguous
PORLA_HD Fe fe_load_words(const uint32_t* p, int64_t stride) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = p[i * stride];
  return r;
}

PORLA_HD void fe_store_words(uint32_t* p, int64_t stride, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i * stride] = a.w[i];
}

PORLA_HD Pt pt_load_strided(const uint32_t* p, int64_t stride) {
  Pt r;
  r.x = fe_load_words(p, stride);
  r.y = fe_load_words(p + 8 * stride, stride);
  r.z = fe_load_words(p + 16 * stride, stride);
  return r;
}

PORLA_HD void pt_store_strided(uint32_t* p, int64_t stride, const Pt& v) {
  fe_store_words(p, stride, v.x);
  fe_store_words(p + 8 * stride, stride, v.y);
  fe_store_words(p + 16 * stride, stride, v.z);
}

// Bucket (window w, slot s) of lane `lane` in the MSM kernels' bucket state
// (nwin, nb, bt, 3, 8): a bucket is 24 contiguous words (96 bytes, 16-byte
// aligned), because the lanes of a warp select different slots: a thread's
// access then fills three 32-byte sectors of device memory, where a
// lane-fastest state would touch 24 sectors for the same 96 bytes. For one
// slot the lanes are neighbours, so initialising and folding coalesce.
PORLA_HD int64_t bucket_offset(int64_t w, int64_t s, int nb, int bt,
                               int lane) {
  return (((w * nb + s) * bt) + lane) * 24;
}

#ifdef __CUDA_ARCH__
// 16-byte accesses: a bucket is six of them
__device__ __forceinline__ Fe fe_load_vec(const uint4* q) {
  uint4 a = q[0], b = q[1];
  Fe r;
  r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void fe_store_vec(uint4* q, const Fe& a) {
  q[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  q[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}
#endif

PORLA_HD Pt bucket_load(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Pt r;
  r.x = fe_load_vec(q);
  r.y = fe_load_vec(q + 2);
  r.z = fe_load_vec(q + 4);
  return r;
#else
  return pt_load_strided(p, 1);
#endif
}

PORLA_HD void bucket_store(uint32_t* p, const Pt& v) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(p);
  fe_store_vec(q, v.x);
  fe_store_vec(q + 2, v.y);
  fe_store_vec(q + 4, v.z);
#else
  pt_store_strided(p, 1, v);
#endif
}

// Sum of one point per thread over the first n threads of a block (n a power
// of two, n <= blockDim.x), paired as the lane-halving sums of the plain torch
// code pair them: at width w thread t takes thread t + w, for w = n/2 .. 1, so
// the Jacobian limbs come out the same. Full-cased adds: partial sums can
// collide or be infinity. Every thread of the block must call it (barriers
// inside; mask the value, not the thread); the total is returned in thread 0.
// `smem` holds 24 * n/2 words, slot-fastest, so a warp's accesses to one word
// do not conflict. A host build that supplies threadIdx and __syncthreads()
// defines PORLA_HOST_BLOCKS to get it.
#if defined(__CUDACC__) || defined(PORLA_HOST_BLOCKS)
PORLA_PT Pt block_tree_sum(Pt v, uint32_t* smem, int n, const Mod& M) {
  int t = threadIdx.x;
  int slots = n / 2;
  for (int w = n / 2; w >= 1; w >>= 1) {
    if (t >= w && t < 2 * w) pt_store_strided(smem + (t - w), slots, v);
    __syncthreads();
    if (t < w) {
      Pt other = pt_load_strided(smem + t, slots);
      v = pt_add(v, other, M);
    }
    __syncthreads();
  }
  return v;
}
#endif

// 4-bit window w (LSB first) of a scalar held as 16 int64 16-bit limbs
PORLA_HD int nibble(const int64_t* s, int w) {
  return (int)((s[w >> 2] >> (4 * (w & 3))) & 0xF);
}

// Windowed (4-bit, MSB-first) scalar mul over the low nbits of s
PORLA_PT Pt pt_smul_window(const Pt& p, const int64_t* s, int nbits,
                           const Mod& M) {
  Pt tbl[16];
  pt_table16(tbl, p, M);
  Pt acc = pt_inf(M);
  for (int w = nbits / 4 - 1; w >= 0; w--) {
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_add(acc, tbl[nibble(s, w)], M);
  }
  return acc;
}

// GLV scalar mul k*P = k1*P + k2*phi(P), phi(x, y) = (beta*x, y), with
// |k1|, |k2| < 2^128 given as magnitudes k1, k2 and sign flags g1, g2.
// 32 windows of (4 doublings + 2 table adds).
PORLA_PT Pt pt_smul_glv(const Pt& p, const int64_t* k1, const int64_t* k2,
                        int64_t g1, int64_t g2, const Fe& beta,
                        const Mod& M) {
  Pt p2;
  p2.x = fe_mul(p.x, beta, M);
  p2.y = p.y;
  p2.z = p.z;
  Pt q1 = pt_sel(g1 != 0, pt_neg(p, M), p);
  Pt q2 = pt_sel(g2 != 0, pt_neg(p2, M), p2);
  Pt t1[16], t2[16];
  pt_table16(t1, q1, M);
  pt_table16(t2, q2, M);
  Pt acc = pt_inf(M);
  for (int w = 31; w >= 0; w--) {
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_dbl(acc, M);
    acc = pt_add(acc, t1[nibble(k1, w)], M);
    acc = pt_add(acc, t2[nibble(k2, w)], M);
  }
  return acc;
}

// Host-side argument packing shared by the C entry points
static inline Mod mod_from_words(const uint32_t* w17) {
  Mod m;
  for (int i = 0; i < 8; i++) m.n[i] = w17[i];
  m.ninv = w17[8];
  for (int i = 0; i < 8; i++) m.one[i] = w17[9 + i];
  return m;
}
