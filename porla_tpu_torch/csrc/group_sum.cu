// group_sum: the sum of each of nout contiguous groups of g Jacobian points,
// in CurveOps.tree_sum's order (any g >= 1: an odd level carries its last
// point), full-cased adds.
//
// Replaces the plain-torch trees that followed the curve kernels: the part
// sums of `kernels.msm_parts` after K2 (the server's stacked audit MSM, two
// parts of 1024 lanes at n = 1024), the TPU package's lane-halving reductions
// that it left to XLA (porla_tpu/curves/weierstrass.py::tree_sum), and K4's
// groups that are too wide for one block.
//
// Bound on this card: operations (g - 1 full adds of 16 field products a
// group against 96 bytes a point), in practice the latency of log2(g)
// dependent adds. One block per group: the points are packed into (3, 8, B)
// words of scratch (which stays in L2), then every level's adds are shared by
// the block's threads, a barrier between levels (tree_sum_slots).
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define GS_THREADS 256

__global__ void __launch_bounds__(GS_THREADS)
group_sum_kernel(const int64_t* __restrict__ x,
                 const int64_t* __restrict__ y,
                 const int64_t* __restrict__ z, uint32_t* part, int64_t* ox,
                 int64_t* oy, int64_t* oz, int64_t B, int g, Mod M) {
  int64_t grp = blockIdx.x;
  uint32_t* buf = part + grp * g;
  if (x) {
    for (int i = threadIdx.x; i < g; i += blockDim.x)
      pt_store_strided(buf + i, B, pt_load(x, y, z, grp * g + i));
    __syncthreads();
  }
  tree_sum_slots(buf, B, g, M);
  if (threadIdx.x == 0) pt_store(ox, oy, oz, grp, pt_load_strided(buf, B));
}

// x, y, z: (B, 16) limbs, packed into `part` (3, 8, B) words of scratch; or
// null, and `part` already holds the points. o*: (B / g, 16) limbs.
extern "C" int porla_group_sum(const int64_t* x, const int64_t* y,
                               const int64_t* z, uint32_t* part, int64_t* ox,
                               int64_t* oy, int64_t* oz, int64_t B, int g,
                               const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  int threads = 32;
  while (threads < GS_THREADS && 2 * threads < g) threads *= 2;
  group_sum_kernel<<<(unsigned)(B / g), threads, 0, (cudaStream_t)stream>>>(
      x, y, z, part, ox, oy, oz, B, g, M);
  return (int)cudaGetLastError();
}
