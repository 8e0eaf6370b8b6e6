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
// per window. Here a thread addresses memory itself: one thread per (window,
// lane) loops over the steps, loads bucket |digit| - 1 of its own lane from
// device memory, does one raw add and stores it back. The state is
// (nwin, nb, 3, 8, bt) 32-bit words with the lane as the fastest axis, so a
// warp's loads of one word are contiguous; the points come straight from the
// (N, 16) limb arrays, step k of lane l being point k*bt + l.
//
// The adds are raw (no infinity, doubling or inverse case): a bucket starts
// at a secret blinding point and is owned by one lane, so it never is
// infinity and never meets its own value except with negligible probability.
// AFFINE: mixed add over (x, y), 8M + 3S; otherwise the full add over
// (x, y, z), 12M + 4S. `first`: initialise the buckets from the blinding
// points; otherwise go on from the state in place (streamed chunks).
//
// Bound on this card: operations (11 field products of 136 word products a
// step against 64 bytes of point and a digit). With nwin*bt threads (18,944
// at c = 7, bt = 512) the card holds about one warp per scheduler, each a
// long dependent chain, so this first version is bound by latency.
#include <cuda_runtime.h>

#include "porla_field.cuh"

#define PIP_THREADS 32

template <bool AFFINE>
__global__ void __launch_bounds__(PIP_THREADS)
pip_bucket_kernel(const int64_t* __restrict__ px,
                  const int64_t* __restrict__ py,
                  const int64_t* __restrict__ pz,
                  const int32_t* __restrict__ digits, uint32_t* state,
                  const int64_t* __restrict__ dx,
                  const int64_t* __restrict__ dy, int nb, int bt, int steps,
                  int first, Mod M) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int64_t w = blockIdx.y;
  if (lane >= bt) return;
  Fe one = fe_from_words(M.one);
  if (first) {
    Pt b;
    b.z = one;
    for (int s = 0; s < nb; s++) {
      b.x = fe_load(dx + 16 * s);
      b.y = fe_load(dy + 16 * s);
      bucket_store(state, bucket_offset(w, s, nb, bt, lane), bt, b);
    }
  }
  const int32_t* d = digits + w * steps * (int64_t)bt + lane;
  for (int k = 0; k < steps; k++) {
    int v = d[k * (int64_t)bt];
    int slot = v & 255;            // |digit|; the sign is bit 8, since
    if (slot == 0) continue;       // |digit| reaches 128 at c = 8
    int64_t i = k * (int64_t)bt + lane;
    Pt p;
    p.x = fe_load(px + 16 * i);
    p.y = fe_load(py + 16 * i);
    p.z = AFFINE ? one : fe_load(pz + 16 * i);
    if (v >> 8) p.y = fe_sub(fe_zero(), p.y, M);
    int64_t off = bucket_offset(w, slot - 1, nb, bt, lane);
    Pt cur = bucket_load(state, off, bt);
    Pt sum = AFFINE ? pt_madd_raw(cur, p, M) : pt_add_raw(cur, p, M);
    bucket_store(state, off, bt, sum);
  }
}

extern "C" int porla_pip_bucket(const int64_t* px, const int64_t* py,
                                const int64_t* pz, const int32_t* digits,
                                uint32_t* state, const int64_t* dx,
                                const int64_t* dy, int nwin, int nb, int bt,
                                int steps, int affine, int first,
                                const uint32_t* mod17, void* stream) {
  Mod M = mod_from_words(mod17);
  dim3 grid((unsigned)((bt + PIP_THREADS - 1) / PIP_THREADS), (unsigned)nwin);
  cudaStream_t s = (cudaStream_t)stream;
  if (affine)
    pip_bucket_kernel<true><<<grid, PIP_THREADS, 0, s>>>(
        px, py, pz, digits, state, dx, dy, nb, bt, steps, first, M);
  else
    pip_bucket_kernel<false><<<grid, PIP_THREADS, 0, s>>>(
        px, py, pz, digits, state, dx, dy, nb, bt, steps, first, M);
  return (int)cudaGetLastError();
}
