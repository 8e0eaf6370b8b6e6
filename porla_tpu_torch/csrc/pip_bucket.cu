// K5 pip_bucket: the bucket accumulation of the blinded signed-window
// Pippenger MSM. For every (window, lane) pair, nb = 2^(c-1) buckets start at
// the blinding points d_s*G; each step adds the lane's next point, y negated
// where the digit is negative, into the bucket that |digit| selects. Digit 0
// (a zero window, a point at infinity, padding) adds nowhere.
//
// Replaces porla_tpu/curves/pallas_msm.py::_pip_kernel_v3 (built by
// _pip_call). The TPU kernel chose the bucket with an nb-way masked select
// for the read and again for the write, because its lanes cannot address
// memory on their own, and kept the buckets in on-chip scratch with one copy
// per window. Here a thread addresses memory itself: a thread owns one
// (window, lane) pair, loops over the steps, takes bucket |digit| - 1 of its
// own lane from device memory, does one raw add and stores it back. The state
// is (nwin, nb, bt, 3, 8) 32-bit words, a bucket 96 contiguous bytes; the
// points arrive as (steps, 2 or 3, 8, bt) words with the lane as the fastest
// axis (cuda_msm.pack_points), so a warp reads 128 contiguous bytes per word
// and an affine point costs 64 bytes.
//
// The adds are raw (no infinity, doubling or inverse case): a bucket starts
// at a secret blinding point and is owned by one lane, so it never is
// infinity and never meets its own value except with negligible probability.
// AFFINE: mixed add over (x, y), 8M + 3S; otherwise the full add over
// (x, y, z), 12M + 4S. `first`: initialise the buckets from the blinding
// points; otherwise go on from the state in place (streamed chunks).
//
// Bound on this card: operations (11 field products of 136 word products a
// step against 64 bytes of point, a digit and 192 bytes of bucket). Measured
// (PERF.md), two things held it far from that bound and one still does:
// - Sectors. The lanes of a warp select different slots, so with the lane as
//   the state's fastest axis every 4-byte word of a bucket came from another
//   32-byte sector of device memory, and the kernel ran at the rate of
//   scattered sector reads whatever the number of threads. A bucket is now 96
//   contiguous bytes, read and written as six 16-byte accesses.
// - Chains in flight. A step is one dependent chain of 11 products, each a
//   chain of carries. The add is inlined here (the shared point functions are
//   calls through local memory), blocks are PIP_THREADS wide, and
//   __launch_bounds__ caps the registers so that PIP_MIN_BLOCKS blocks stay
//   resident on an SM (168 registers; a cap of 128 spills and measured
//   slower, and the block width does not matter at equal registers). The
//   lane width bt is the caller's (cuda_msm.DEFAULT_BT) and sets the number
//   of threads, nwin*bt. Two windows of a lane in one thread, the point
//   loaded once, measured 27-50 % slower than twice the lanes (220-255
//   registers leave two blocks an SM) and is not kept.
// - The next step's operands ahead of this step's products: step k+1's
//   digit, point and bucket are loaded into registers before step k's add
//   starts (worth 2-9 % measured). Where both steps select the same bucket
//   the loaded value is stale, and the sum just computed takes its place.
// - No divergence: a zero digit computes on bucket 0 and stores nothing.
// What still bounds it is the multiply-add carry chains of fe_mul with two
// to three warps a scheduler to hide them.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define PIP_THREADS 128
#define PIP_MIN_BLOCKS 3

// Step k's point of lane `lane` from the packed (steps, NC, 8, bt) words
template <int NC>
__device__ __forceinline__ Pt point_load(const uint32_t* __restrict__ pts,
                                         int64_t k, int bt, int lane,
                                         const Fe& one) {
  const uint32_t* p = pts + k * NC * 8 * bt + lane;
  Pt r;
  r.x = fe_load_words(p, bt);
  r.y = fe_load_words(p + 8 * (int64_t)bt, bt);
  r.z = NC == 3 ? fe_load_words(p + 16 * (int64_t)bt, bt) : one;
  return r;
}

template <bool AFFINE>
__global__ void __launch_bounds__(PIP_THREADS, PIP_MIN_BLOCKS)
pip_bucket_kernel(const uint32_t* __restrict__ pts,
                  const int32_t* __restrict__ digits, uint32_t* state,
                  const int64_t* __restrict__ dx,
                  const int64_t* __restrict__ dy, int nwin, int nb, int bt,
                  int steps, int first, Mod M) {
  constexpr int NC = AFFINE ? 2 : 3;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= bt) return;
  int64_t w = blockIdx.y;
  Fe one = fe_from_words(M.one);
  const int32_t* d = digits + w * steps * (int64_t)bt + lane;
  uint32_t* base = state + bucket_offset(w, 0, nb, bt, lane);
  int64_t stride = 24 * (int64_t)bt;    // words from one slot to the next
  if (first) {
    Pt b;
    b.z = one;
    for (int s = 0; s < nb; s++) {
      b.x = fe_load(dx + 16 * s);
      b.y = fe_load(dy + 16 * s);
      bucket_store(base + s * stride, b);
    }
  }

  // the coming step's packed digit, point and bucket
  int v = d[0];
  Pt p_ahead = point_load<NC>(pts, 0, bt, lane, one);
  Pt ahead = bucket_load(base + ((v & 255) ? (v & 255) - 1 : 0) * stride);
  for (int k = 0; k < steps; k++) {
    Pt p = p_ahead;
    Pt cur = ahead;
    int now = v;
    if (k + 1 < steps) {
      p_ahead = point_load<NC>(pts, k + 1, bt, lane, one);
      v = d[(k + 1) * (int64_t)bt];
      ahead = bucket_load(base + ((v & 255) ? (v & 255) - 1 : 0) * stride);
    }
    int slot = now & 255;      // |digit|; the sign is bit 8, since |digit|
    //                            reaches 128 at c = 8
    Pt q = p;
    q.y = fe_sel((now >> 8) != 0, fe_sub(fe_zero(), p.y, M), p.y);
    AddTerms t;
    Pt sum = AFFINE ? madd_core(cur, q, t, M) : add_core(cur, q, t, M);
    if (slot) {
      bucket_store(base + (slot - 1) * stride, sum);
      // the bucket loaded ahead was read before this store
      if (slot == (v & 255)) ahead = sum;
    }
  }
}

extern "C" int porla_pip_bucket(const uint32_t* pts, const int32_t* digits,
                                uint32_t* state, const int64_t* dx,
                                const int64_t* dy, int nwin, int nb, int bt,
                                int steps, int affine, int first,
                                const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  dim3 grid((unsigned)((bt + PIP_THREADS - 1) / PIP_THREADS), (unsigned)nwin);
  cudaStream_t s = (cudaStream_t)stream;
  if (affine)
    pip_bucket_kernel<true><<<grid, PIP_THREADS, 0, s>>>(
        pts, digits, state, dx, dy, nwin, nb, bt, steps, first, M);
  else
    pip_bucket_kernel<false><<<grid, PIP_THREADS, 0, s>>>(
        pts, digits, state, dx, dy, nwin, nb, bt, steps, first, M);
  return (int)cudaGetLastError();
}
