// group_sum: the sum of each of nout contiguous groups of g Jacobian points,
// in CurveOps.tree_sum's order (any g >= 1: at width m slot i takes slot
// i + m/2, and an odd level carries its last point to slot m/2), full-cased
// adds.
//
// Replaces the plain-torch trees that followed the curve kernels: the part
// sums of `kernels.msm_parts` after K2 (the server's stacked audit MSM, two
// parts of 1024 lanes at n = 1024), the TPU package's lane-halving reductions
// that it left to XLA (porla_tpu/curves/weierstrass.py::tree_sum), and K4's
// groups that are too wide for one block.
//
// Bound on this card: operations (g - 1 full adds of 16 field products a
// group against 96 bytes a point), in practice the depth: log2(g) levels of
// dependent adds, each the latency of a full add. What the design does:
// - Each add runs on 8 threads, thread k holding word k of every field
//   element (porla_coop.cuh's c_padd: pt_add's formulas, cases and order,
//   so the words are the plain version's), 16 adds at once in a block of
//   COOP_THREADS = 128. A level is then a few rounds of cooperative adds,
//   each the latency of a few warp shuffles a field product.
// - A group's wide levels are spread over nb blocks (nb a power of two, the
//   wrapper's plan: cuda_curve.group_sum_plan). Block b takes the adds
//   into the slots i = b (mod nb). The first level reads only the input
//   (the caller's limbs or K4's packed words, never the scratch), so any
//   split of it works: its odd carry, slot 2(m/2) to m/2, goes to the
//   block of m/2's residue. A later level reads the sums of the level
//   before: while nb divides m/2, slot i takes slot i + m/2 of its own
//   residue and the odd carry moves slot 2(m/2) to m/2, both multiples of
//   nb, in block 0, so block b runs those levels with no dependency on the
//   other blocks. The group's last block to finish (a counter per group,
//   zeroed by the wrapper on the stream, after a __threadfence) runs the
//   remaining levels over the partial sums. One launch a call; a width
//   whose half stops being a multiple of nb early (4094: 2047) leaves more
//   levels to the last block.
// - Every sum goes to the packed (3, 8, B) words of the wrapper's scratch,
//   read and written through L2 (__ldcg / __stcg, so the last block sees
//   the other blocks' sums): one L2 round trip a level against the
//   microseconds of an add, and no limit on g.
#include <cuda_runtime.h>

#include "porla_coop.cuh"

// Word k of x, y and z of slot s in the packed (24, B) words
__device__ __forceinline__ CPt gs_load(const uint32_t* part, int64_t B,
                                       int64_t s, int k) {
  return CPt{__ldcg(part + k * B + s), __ldcg(part + (8 + k) * B + s),
             __ldcg(part + (16 + k) * B + s)};
}

__device__ __forceinline__ void gs_store(uint32_t* part, int64_t B, int64_t s,
                                         int k, const CPt& v) {
  __stcg(part + k * B + s, v.x);
  __stcg(part + (8 + k) * B + s, v.y);
  __stcg(part + (16 + k) * B + s, v.z);
}

// Slot s of the level's operands: the caller's limbs (x not null) or the
// packed words of src (K4's at the first level, the scratch after it)
__device__ __forceinline__ CPt gs_operand(const int64_t* x, const int64_t* y,
                                          const int64_t* z,
                                          const uint32_t* src, int64_t B,
                                          int64_t s, int k) {
  return x ? c_load_pt(x, y, z, s, k) : gs_load(src, B, s, k);
}

// One level of tree_sum at width m over the group's slots from g0, as block
// b of nb shares it, from the operands (x, y, z or src) into part: slot
// i = b + j*nb < m/2 takes slot i + m/2, blockDim.x / 8 adds a round; an
// odd m carries slot 2(m/2) to m/2 in the block of m/2's residue, after
// the add that reads slot m/2 where the level runs in place (then m/2 is
// a multiple of nb: block 0). Every thread of the block calls it.
__device__ void gs_level(const int64_t* x, const int64_t* y, const int64_t* z,
                         const uint32_t* src, uint32_t* part, int64_t B,
                         int64_t g0, int m, int b, int nb, const CMod& C) {
  int h = m >> 1;
  int adds = h > b ? (h - b + nb - 1) / nb : 0;
  int groups = blockDim.x >> 3;
  int q = threadIdx.x >> 3;
  for (int r = 0; r < adds; r += groups) {
    int j = r + q;
    bool live = j < adds;
    if (__any_sync(FULL, live)) {       // a dead group computes j = 0 unseen:
      int64_t i = g0 + b + (int64_t)(live ? j : 0) * nb;   // the warp votes
      CPt s = c_padd(gs_operand(x, y, z, src, B, i, C.k),
                     gs_operand(x, y, z, src, B, i + h, C.k), C);
      if (live) gs_store(part, B, i, C.k, s);
    }
  }
  __syncthreads();
  if ((m & 1) && b == h % nb) {
    if (threadIdx.x < 8)
      gs_store(part, B, g0 + h, C.k,
               gs_operand(x, y, z, src, B, g0 + 2 * h, C.k));
    __syncthreads();
  }
}

// Blocks nb*o .. nb*o + nb - 1 sum group o; thread k of each group of 8
// holds word k. The operands are the input (x, y, z, or `in`) until a
// level has run, then the sums in part.
__global__ void __launch_bounds__(COOP_THREADS)
group_sum_kernel(const int64_t* __restrict__ x,
                 const int64_t* __restrict__ y,
                 const int64_t* __restrict__ z, const uint32_t* in,
                 uint32_t* part, int* count, int64_t* ox, int64_t* oy,
                 int64_t* oz, int64_t B, int g, int nb, Mod M) {
  __shared__ int last;
  CMod C = c_mod(M);
  int64_t grp = blockIdx.x / nb;
  int b = blockIdx.x % nb;
  int64_t g0 = grp * g;
  const uint32_t* src = in;
  // the first level always splits, a later one while nb divides its half
  int m = g;
  for (; m > 1 && (m == g || (m >> 1) % nb == 0); m = (m >> 1) + (m & 1)) {
    gs_level(x, y, z, src, part, B, g0, m, b, nb, C);
    x = y = z = nullptr;
    src = part;
  }
  if (nb > 1) {                         // hand the rest to the last block
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(count + grp, 1) == nb - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (; m > 1; m = (m >> 1) + (m & 1)) {
      gs_level(x, y, z, src, part, B, g0, m, 0, 1, C);
      x = y = z = nullptr;
      src = part;
    }
  }
  if (threadIdx.x < 8)
    c_store_pt(ox, oy, oz, grp, C.k, gs_operand(x, y, z, src, B, g0, C.k));
}

// x, y, z: (B, 16) limbs; or null, and `in` holds the points as packed
// (3, 8, B) words. part: (3, 8, B) words of scratch for the sums. o*:
// (B / g, 16) limbs. nb: blocks a group, a power of two; count: B / g
// zeroed ints when nb > 1.
extern "C" int porla_group_sum(const int64_t* x, const int64_t* y,
                               const int64_t* z, const uint32_t* in,
                               uint32_t* part, int* count, int64_t* ox,
                               int64_t* oy, int64_t* oz, int64_t B, int g,
                               int nb, const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  unsigned blocks = (unsigned)(B / g * nb);
  group_sum_kernel<<<blocks, COOP_THREADS, 0, (cudaStream_t)stream>>>(
      x, y, z, in, part, count, ox, oy, oz, B, g, nb, M);
  return (int)cudaGetLastError();
}
