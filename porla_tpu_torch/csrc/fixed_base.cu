// K4 fixed_base: scalar_i * G_(i mod ng) from per-window affine tables
// T_w[d] = d * 16^w * G_g, one mixed add per 4-bit window, optionally summed
// within contiguous groups of lanes.
//
// Replaces porla_tpu/curves/pallas_curve.py::_fb_kernel (built by _fb_call)
// and the lane-halving group sum that _fb_msm_call fused into the same
// dispatch. The TPU kernel carried each lane's accumulator across the
// sequential grid axis; Hopper runs blocks in no order, so here the threads
// of a lane walk its windows in a loop and the block adds up the rest.
//
// Bound on this card: operations. A lane does nbits/4 mixed adds (11 field
// products) and a group of g lanes g - 1 full adds more, against one 64-byte
// table entry a window. What the design does about it:
// - The table is packed: x and y as 8 x 32-bit words each, 64 bytes an
//   entry, infinity as all zeros (no affine point of these curves has y = 0:
//   their groups have odd order), 8.4 MB for 128 generators x 64 windows, so
//   it stays in L2. The int64 limb form was six times that.
// - A lane's windows are independent table points (no doublings between
//   them), so where the lanes are few each lane's windows are spread over
//   `split` neighbouring threads, thread j taking windows j, j + split, ...;
//   their partial sums are added in a lane-halving tree inside the block
//   (segment_tree_sum). The wrapper chooses `split` from the lane count.
// - In the group mode a block is one group (group * split threads): the
//   lanes' sums go to shared memory and are added in CurveOps.tree_sum's
//   order (tree_sum_slots), so the group sums leave the kernel as (nout, 16)
//   limbs and no point op follows it in plain torch. A group too wide for a
//   block is summed by group_sum.cu after a per-lane launch that writes
//   packed words.
// - The mixed add is inlined into the window loop; its doubling case (acc ==
//   T, reached only by scalars >= the group order) is a branch, not a select.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define FB_THREADS 512   // the most threads of a group-mode block
#define FB_LANE_THREADS 128

// Table entry e: x then y, 16 words; all zeros is infinity, given the
// limb form's (R, R, 0) so that the kernel and the plain version agree.
PORLA_HD Pt fb_entry(const uint32_t* e, const Mod& M) {
  Pt r;
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(e);
  r.x = fe_load_vec(q);
  r.y = fe_load_vec(q + 2);
#else
  r.x = fe_from_words(e);
  r.y = fe_from_words(e + 8);
#endif
  r.z = fe_from_words(M.one);
  return pt_sel(fe_is_zero(r.y), pt_inf(M), r);
}

template <bool GROUPS>
__global__ void __launch_bounds__(FB_THREADS)
fixed_base_kernel(const uint32_t* __restrict__ tab,
                  const int64_t* __restrict__ s, int64_t* ox, int64_t* oy,
                  int64_t* oz, uint32_t* part, int64_t B, int ng, int nwin,
                  int split, Mod M) {
  extern __shared__ uint32_t smem[];
  int t = threadIdx.x;
  int j = t % split;
  int per_block = blockDim.x / split;
  int64_t lane = blockIdx.x * (int64_t)per_block + t / split;
  bool live = lane < B;               // the others compute lane 0 unseen:
  int64_t li = live ? lane : 0;       // every thread reaches the barriers
  int gen = (int)(li % ng);
  const int64_t* si = s + 16 * li;
  Pt acc = pt_inf(M);
  for (int w = j; w < nwin; w += split) {
    int64_t e = ((int64_t)w * 16 + nibble(si, w)) * ng + gen;
    Pt q = fb_entry(tab + 16 * e, M);
    AddTerms at;
    Pt raw = madd_core(acc, q, at, M);
    acc = pt_cases(raw, acc, q, at.U1, at.U2, at.S1, at.S2, M);
  }
  if (split > 1) acc = segment_tree_sum(acc, smem, split, M);
  if (!GROUPS) {
    if (j == 0 && live) {
      if (part)
        pt_store_strided(part + lane, B, acc);
      else
        pt_store(ox, oy, oz, lane, acc);
    }
    return;
  }
  // the block is one group: its lanes' sums in tree_sum order
  if (j == 0) pt_store_strided(smem + t / split, per_block, acc);
  __syncthreads();
  tree_sum_slots(smem, per_block, per_block, M);
  if (t == 0)
    pt_store(ox, oy, oz, blockIdx.x, pt_load_strided(smem, per_block));
}

// tab: (nwin, 16, ng, 16) words; s: (B, 16) limbs; split: threads a lane,
// a power of two. group == 0: per lane, o* (B, 16) limbs, or `part` (3, 8,
// B) words when it is not null. group > 0: one block per group of `group`
// lanes (group * split <= FB_THREADS), o* (B / group, 16) limbs.
extern "C" int porla_fixed_base(const uint32_t* tab, const int64_t* s,
                                int64_t* ox, int64_t* oy, int64_t* oz,
                                uint32_t* part, int64_t B, int ng, int nwin,
                                int split, int group, const uint32_t* mod17,
                                void* stream) {
  Mod M = mod_from_words(mod17);
  cudaStream_t st = (cudaStream_t)stream;
  if (group > 0) {
    int threads = group * split;
    size_t shm = 24 * sizeof(uint32_t) * threads;
    fixed_base_kernel<true><<<(unsigned)(B / group), threads, shm, st>>>(
        tab, s, ox, oy, oz, nullptr, B, ng, nwin, split, M);
    return (int)cudaGetLastError();
  }
  int per_block = FB_LANE_THREADS / split;
  size_t shm = split > 1 ? 24 * sizeof(uint32_t) * FB_LANE_THREADS : 0;
  fixed_base_kernel<false>
      <<<(unsigned)((B + per_block - 1) / per_block), FB_LANE_THREADS, shm,
         st>>>(tab, s, ox, oy, oz, part, B, ng, nwin, split, M);
  return (int)cudaGetLastError();
}
