// K1 ntt_stage: radix-2 NTT butterfly stages over one CRT lane, several
// stages in one launch.
//
// Replaces porla_tpu/ntt/pallas_stage.py::_stage_kernel (built by
// _stage_call, one launch a stage, driven by encode_stages_pallas). Stage s
// (half-width m2 = 2^(s-1)) computes, for every pair (k, k + m2) with
// k mod 2*m2 < m2 and every chunk c of an (n, C, 16) limb array,
//   out[k]      = a[k] + tw[j] * a[k + m2]   (mod lane modulus)
//   out[k + m2] = a[k] - tw[j] * a[k + m2]
// with j = k mod m2 and tw in Montgomery form (engine.encode_stages order).
// Every output is canonical, so any number of fused stages gives the plain
// stage loop's limbs.
//
// Bound on this card: operations at the CRebuild shape (a lane at (1024,
// 128) is 10 stages of 65,536 Montgomery products, 136 32x32->64-bit
// products each, against 8.4 MB in and out, packed). One launch a stage
// moved the whole int64 array (16 limbs of 16 bits, 4x the packed bytes)
// through device memory at every stage, for one product a thread. This
// design runs a pass of stages s0 .. s1 on a block's shared memory:
// - The stages s0 .. s1 of a pass pair rows only within groups of
//   len = 2^(s1-s0+1) rows spaced stride = 2^(s0-1) apart, so each group
//   and chunk (an item) is an independent transform. A block loads whole
//   items into shared memory as packed 32-bit words (16 threads read an
//   element's 128 bytes, one limb each), runs the pass's stages with a
//   barrier between them, and writes the result once.
// - A block holds BLOCK_ELEMS elements (32 KB): at n <= 1024 every stage of
//   a lane is one pass (one chunk column a block), and a larger n takes a
//   second pass over strided rows (cuda_stage.pass_plan).
// - The twiddles of every stage are one packed word table per lane, built
//   once on the host and read through the read-only cache.
// - A one-stage call (ntt_stage) is a pass with len = 2 and its own table.
// The TPU version's bf16 Toeplitz products and byte-digit tiles are not
// carried over: Hopper multiplies 32-bit words natively.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define NTT_THREADS 256
#define NTT_BLOCK_LG 10
#define NTT_BLOCK_ELEMS (1 << NTT_BLOCK_LG)
#define LOAD_UNROLL 8

// A block's items: item t = blockIdx.x * (BLOCK_ELEMS >> lg) + q is group
// g = t / C of chunk c = t % C; group g = (hi, lo) = (g / stride, g % stride)
// holds rows hi * stride * len + lo + stride * i, i < len. Shared memory is
// word-major: word w of the block's element e = q * len + i at w * SP + e,
// SP = E + 4 so that the 32 words a warp loads or stores at once (four
// elements) fall in 32 banks. a and out must be 16-byte aligned.
// a and out may be the same array: a block reads only what it writes, all
// of it before its first store.
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const int64_t* a, int64_t* out,
                const uint32_t* __restrict__ tw, int64_t tw_off, int C,
                int64_t stride, int lg, int64_t items, Mod M) {
  const int E = NTT_BLOCK_ELEMS;
  const int SP = E + 4;
  __shared__ uint32_t sm[8 * SP];
  __shared__ int64_t base[E / 2];       // item q's limb offset at i = 0; -1 past the end
  __shared__ int64_t lo_of[E / 2];      // and its group's lo
  const int len = 1 << lg;
  const int nq = E >> lg;
  const int64_t first = (int64_t)blockIdx.x * nq;
  const int64_t rstep = stride * C * 16;  // limbs from row i to row i + 1

  for (int q = threadIdx.x; q < nq; q += NTT_THREADS) {
    int64_t t = first + q;
    int64_t g = t / C;
    int64_t c = t - g * C;
    int64_t hi = g / stride, lo = g - hi * stride;
    base[q] = t < items ? ((hi * stride * len + lo) * C + c) * 16 : -1;
    lo_of[q] = lo;
  }
  __syncthreads();

  // 8 threads an element, 16 bytes (two limbs, one packed word) each;
  // LOAD_UNROLL loads in flight a thread before their words are stored
  for (int v0 = threadIdx.x; v0 < 8 * E; v0 += LOAD_UNROLL * NTT_THREADS) {
    longlong2 r[LOAD_UNROLL];
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; u++) {
      int v = v0 + u * NTT_THREADS, e = v >> 3;
      int64_t off = base[e >> lg];
      r[u] = off >= 0 ? __ldg(reinterpret_cast<const longlong2*>(
                            a + off + (e & (len - 1)) * rstep) + (v & 7))
                      : longlong2{0, 0};
    }
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; u++) {
      int v = v0 + u * NTT_THREADS;
      sm[(v & 7) * SP + (v >> 3)] =
          (uint32_t)r[u].x | ((uint32_t)r[u].y << 16);
    }
  }
  __syncthreads();

  for (int s = 0; s < lg; s++) {
    const int h = 1 << s;                 // the stage's half-width in a group
    for (int p = threadIdx.x; p < E / 2; p += NTT_THREADS) {
      int q = p >> (lg - 1), ip = p & ((len >> 1) - 1);
      if (base[q] < 0) continue;
      int e0 = (q << lg) + ((ip >> s) << (s + 1)) + (ip & (h - 1));
      int e1 = e0 + h;
      int64_t j = lo_of[q] + stride * (ip & (h - 1));
      const uint4* wp = reinterpret_cast<const uint4*>(
          tw + (stride * h - 1 + j - tw_off) * 8);
      uint4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
      Fe u, x, w = {{w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w}};
#pragma unroll
      for (int k = 0; k < 8; k++) {
        u.w[k] = sm[k * SP + e0];
        x.w[k] = sm[k * SP + e1];
      }
      Fe prod = fe_mul(x, w, M);
      Fe sum = fe_add(u, prod, M);
      Fe dif = fe_sub(u, prod, M);
#pragma unroll
      for (int k = 0; k < 8; k++) {
        sm[k * SP + e0] = sum.w[k];
        sm[k * SP + e1] = dif.w[k];
      }
    }
    __syncthreads();
  }

  for (int v = threadIdx.x; v < 8 * E; v += NTT_THREADS) {
    int e = v >> 3;
    int64_t off = base[e >> lg];
    uint32_t w = sm[(v & 7) * SP + e];
    if (off >= 0)
      reinterpret_cast<longlong2*>(out + off + (e & (len - 1)) * rstep)[v & 7] =
          longlong2{(long long)(w & 0xFFFFu), (long long)(w >> 16)};
  }
}

// Stages s0 .. s0 + lg - 1 (stride = 2^(s0-1), or any m2 for one stage)
// over (n, C, 16) limbs; twiddle (m2, j) at row m2 - 1 + j - tw_off of tw.
// a and out may be the same array.
extern "C" int porla_ntt_pass(const int64_t* a, int64_t* out,
                              const uint32_t* tw, int64_t tw_off, int64_t n,
                              int C, int64_t stride, int lg,
                              const uint32_t* mod17, void* stream) {
  if (lg < 1 || lg > NTT_BLOCK_LG) return (int)cudaErrorInvalidValue;
  Mod M = mod_from_words(mod17);
  int64_t items = (n >> lg) * C;
  int64_t per_block = NTT_BLOCK_ELEMS >> lg;
  unsigned blocks = (unsigned)((items + per_block - 1) / per_block);
  ntt_pass_kernel<<<blocks, NTT_THREADS, 0, (cudaStream_t)stream>>>(
      a, out, tw, tw_off, C, stride, lg, items, M);
  return (int)cudaGetLastError();
}
