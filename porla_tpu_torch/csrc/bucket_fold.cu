// K6 bucket_fold: the suffix-run fold sum_s s*B_s of every (window, lane)
// pair's buckets, and the sum of a window's lanes. Walking s = nb .. 1:
// run += B_s; acc += run, two raw full adds a step (the buckets are blinded,
// so no add meets infinity or its own operand). The lane partials are then
// halved, lane i taking lane i + w for w = bt/2 .. 1, with full-cased adds
// (partials of different lanes can be equal, opposite or, summed, infinity).
//
// Replaces porla_tpu/curves/pallas_msm.py::_fold_kernel (built by
// _fold_call), whose grid (nwin, nb) carried `run` and `acc` in scratch from
// one grid step to the next, and the lane-halving sum that the TPU package
// left to its compiler (_reduce_fn). Blocks here run in no order, so one
// thread per (window, lane) walks all its buckets with `run` and `acc` in
// registers and reads K5's packed state (nwin, nb, bt, 3, 8): for one slot
// the lanes are neighbours, so a warp's loads coalesce.
//
// Bound on this card: operations (2*(nb-1) full adds of 16 field products a
// thread against nb*96 bytes of state), and in practice the latency of one
// thread's dependent chain of products. What the design does about it:
// - The fold is spread over nwin*bt threads in blocks of FOLD_THREADS; one
//   block per window would fill nwin of the card's 132 SMs. The next bucket
//   is loaded before this step's two adds start.
// - The lane sum is a second kernel of the same launch sequence, one block
//   per window, because a block-wide barrier cannot span the fold's blocks.
//   The fold hands it the partials as packed words (nwin, 3, 8, bt), a
//   quarter of the limb layout, which stay in L2. Widths above the block are
//   summed in place by the thread that owns the column (lanes t, t + n, ...
//   pair only among themselves at those widths, so no barrier is needed);
//   the last log2(n) levels run in shared memory (segment_tree_sum over the
//   block).
// - With `lanes` set, the fold writes its per-lane partials as (nwin, bt,
//   16) limbs and no sum is taken: the TPU kernel's own output, for callers
//   and tests that want it.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define FOLD_THREADS 128
#define TREE_THREADS 256

template <bool LANES>
__global__ void __launch_bounds__(FOLD_THREADS)
bucket_fold_kernel(const uint32_t* __restrict__ state, uint32_t* part,
                   int64_t* ox, int64_t* oy, int64_t* oz, int nb, int bt,
                   Mod M) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int64_t w = blockIdx.y;
  if (lane >= bt) return;        // no barrier below
  const uint32_t* mine = state + bucket_offset(w, 0, nb, bt, lane);
  int64_t slot = 24 * (int64_t)bt;      // words from one slot to the next
  Pt run = bucket_load(mine + (nb - 1) * slot);
  Pt acc = run;
  Pt next = run;
  if (nb > 1) next = bucket_load(mine + (nb - 2) * slot);
  for (int s = nb - 2; s >= 0; s--) {
    Pt b = next;
    if (s > 0) next = bucket_load(mine + (s - 1) * slot);
    run = pt_add_raw(run, b, M);
    acc = pt_add_raw(acc, run, M);
  }
  if (LANES)
    pt_store(ox, oy, oz, w * bt + lane, acc);
  else
    pt_store_strided(part + w * 24 * bt + lane, bt, acc);
}

// One block of n = min(bt, TREE_THREADS) threads per window: (nwin, 3, 8,
// bt) packed lane partials (overwritten) -> (nwin, 16)-limb window totals.
__global__ void __launch_bounds__(TREE_THREADS)
lane_sum_kernel(uint32_t* part, int64_t* ox, int64_t* oy, int64_t* oz, int bt,
                Mod M) {
  __shared__ uint32_t smem[24 * TREE_THREADS];
  int t = threadIdx.x;
  int n = blockDim.x;
  int64_t w = blockIdx.x;
  uint32_t* row = part + w * 24 * bt;
  for (int wd = bt / 2; wd >= n; wd >>= 1)
    for (int i = t; i < wd; i += n) {
      Pt a = pt_load_strided(row + i, bt);
      Pt b = pt_load_strided(row + i + wd, bt);
      pt_store_strided(row + i, bt, pt_add(a, b, M));
    }
  Pt v = pt_load_strided(row + t, bt);
  v = segment_tree_sum(v, smem, n, M);
  if (t == 0) pt_store(ox, oy, oz, w, v);
}

// lanes != 0: o* are (nwin, bt, 16) limbs and `part` is not used.
// lanes == 0: `part` is (nwin, 3, 8, bt) words of scratch, o* are (nwin, 16)
// limbs; bt must be a power of two.
extern "C" int porla_bucket_fold(const uint32_t* state, uint32_t* part,
                                 int64_t* ox, int64_t* oy, int64_t* oz,
                                 int nwin, int nb, int bt, int lanes,
                                 const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((bt + FOLD_THREADS - 1) / FOLD_THREADS),
            (unsigned)nwin);
  if (lanes) {
    bucket_fold_kernel<true><<<grid, FOLD_THREADS, 0, s>>>(
        state, part, ox, oy, oz, nb, bt, M);
    return (int)cudaGetLastError();
  }
  bucket_fold_kernel<false><<<grid, FOLD_THREADS, 0, s>>>(
      state, part, ox, oy, oz, nb, bt, M);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  int n = bt < TREE_THREADS ? bt : TREE_THREADS;
  lane_sum_kernel<<<(unsigned)nwin, n, 0, s>>>(part, ox, oy, oz, bt, M);
  return (int)cudaGetLastError();
}
