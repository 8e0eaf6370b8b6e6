// point_add: out[i] = a[i] + b[i], or a[i] + (-b[i]), for B lanes of
// Jacobian points in the port's (B, 16) int64 Montgomery limb layout, with
// CurveOps.add's formulas (add-2007-bl), cases (infinity on either side,
// P == Q, P == -Q) and order, so the limbs are point_add_plain's.
//
// Replaces the protocol's general point add, which ran as plain torch limb
// arithmetic (CurveOps.add: hundreds of small launches an add, the doubling
// always computed): the MAC sums of the client's updates and initialize, its
// complement deltas, the server's delta absorb, align_MAC and the streamed
// fold's alignment sums. No Pallas kernel: the TPU package left the add to
// XLA (porla_tpu/curves/weierstrass.py:127, CurveOps.add).
//
// Bound on this card: the latency of one full add, 16 dependent cooperative
// field products (plus the doubling's 7 where a warp needs it) at every B
// the protocol uses (1 to 2048 lanes): the operations (16 products a lane)
// and bytes (9 field elements a lane) take the card under a microsecond even
// at 2048 lanes. What the design does:
// - Each lane runs on one group of 8 threads, thread k holding word k of
//   every field element (porla_coop.cuh's c_padd, shared with K2, K3, K7 and
//   group_sum), so a product is a few warp shuffles a row instead of one
//   thread's 16 carry chains; a block of COOP_THREADS = 128 threads runs 16
//   lanes, the grid ceil(B / 16) blocks, one launch a call.
// - Every shuffle and vote names the whole warp, so a ragged block's dead
//   groups compute lane 0 unseen and store nothing; the doubling runs where
//   any lane of the warp needs it and is selected where its own does.
// - `neg` negates b on the card (c_neg, fe_sub from 0, as CurveOps.neg), so
//   a difference a - b is one launch too.
#include <cuda_runtime.h>

#include "porla_coop.cuh"

#define PA_LANES (COOP_THREADS / 8)

__global__ void __launch_bounds__(COOP_THREADS)
point_add_kernel(const int64_t* __restrict__ ax,
                 const int64_t* __restrict__ ay,
                 const int64_t* __restrict__ az,
                 const int64_t* __restrict__ bx,
                 const int64_t* __restrict__ by,
                 const int64_t* __restrict__ bz, int64_t* __restrict__ ox,
                 int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                 int64_t B, int neg, Mod M) {
  CMod C = c_mod(M);
  int64_t i = (int64_t)blockIdx.x * PA_LANES + (threadIdx.x >> 3);
  bool live = i < B;
  int64_t j = live ? i : 0;
  CPt p = c_load_pt(ax, ay, az, j, C.k);
  CPt q = c_load_pt(bx, by, bz, j, C.k);
  if (neg) q = c_neg(q, C);             // uniform over the launch
  CPt s = c_padd(p, q, C);
  if (live) c_store_pt(ox, oy, oz, i, C.k, s);
}

// a*, b*, o*: (B, 16) limbs, B >= 1; neg: 1 to add -b. mod17: n, -n^-1 mod
// 2^32 and R mod n as 32-bit words (native.mod_words).
extern "C" int porla_point_add(const int64_t* ax, const int64_t* ay,
                               const int64_t* az, const int64_t* bx,
                               const int64_t* by, const int64_t* bz,
                               int64_t* ox, int64_t* oy, int64_t* oz,
                               int64_t B, int neg, const uint32_t* mod17,
                               void* stream) {
  Mod M = mod_from_words(mod17);
  unsigned blocks = (unsigned)((B + PA_LANES - 1) / PA_LANES);
  point_add_kernel<<<blocks, COOP_THREADS, 0, (cudaStream_t)stream>>>(
      ax, ay, az, bx, by, bz, ox, oy, oz, B, neg, M);
  return (int)cudaGetLastError();
}
