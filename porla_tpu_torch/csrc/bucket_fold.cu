// K6 bucket_fold: the suffix-run fold sum_s s*B_s of every (window, lane)
// pair's buckets. Walking s = nb .. 1: run += B_s; acc += run, two raw full
// adds a step (the buckets are blinded, so no add meets infinity or its own
// operand).
//
// Replaces porla_tpu/curves/pallas_msm.py::_fold_kernel (built by
// _fold_call), whose grid (nwin, nb) carried `run` and `acc` in scratch from
// one grid step to the next. Blocks here run in no order, so one thread per
// (window, lane) walks all its buckets with `run` and `acc` in registers,
// reads K5's packed state (nwin, nb, 3, 8, bt) and writes (nwin, bt) points
// in the (…, 16) limb layout for the lane-halving sum that follows.
//
// Bound on this card: operations (2*(nb-1) full adds of 16 field products a
// thread against nb*96 bytes of state); with nwin*bt threads it is bound by
// latency like K5.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define FOLD_THREADS 32

__global__ void __launch_bounds__(FOLD_THREADS)
bucket_fold_kernel(const uint32_t* __restrict__ state, int64_t* ox,
                   int64_t* oy, int64_t* oz, int nb, int bt, Mod M) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int64_t w = blockIdx.y;
  if (lane >= bt) return;
  Pt run = bucket_load(state, bucket_offset(w, nb - 1, nb, bt, lane), bt);
  Pt acc = run;
  for (int s = nb - 2; s >= 0; s--) {
    Pt b = bucket_load(state, bucket_offset(w, s, nb, bt, lane), bt);
    run = pt_add_raw(run, b, M);
    acc = pt_add_raw(acc, run, M);
  }
  pt_store(ox, oy, oz, w * bt + lane, acc);
}

extern "C" int porla_bucket_fold(const uint32_t* state, int64_t* ox,
                                 int64_t* oy, int64_t* oz, int nwin, int nb,
                                 int bt, const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  dim3 grid((unsigned)((bt + FOLD_THREADS - 1) / FOLD_THREADS),
            (unsigned)nwin);
  bucket_fold_kernel<<<grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      state, ox, oy, oz, nb, bt, M);
  return (int)cudaGetLastError();
}
