// TAS phase-1 leaf pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kueue_oss_tpu/solver/pallas_tas.py
// (_leaf_states_kernel, launched by leaf_states at pallas_tas.py:99).
// For every leaf domain d of a [D, R] int32 capacity matrix:
//   st[d]  = min(BIG, min over r with per_pod[r] > 0 of floor(cap[d,r] / per_pod[r]))
//   ls[d]  = has_leader && cap[d,r] >= leader[r] for every r with leader[r] > 0
//   swl[d] = the same min as st over cap[d,r] - (ls[d] ? leader[r] : 0)
// with BIG = 1 << 30 (also the value when no request is nonzero).
//
// Bound: the pass is a handful of integer ops per element; it moves
// 4*D*R bytes in and 12*D bytes out, so at the drain's shapes (D = 640
// leaves, R <= 2 resources: ~13 KB) it is bounded by the launch, not by
// HBM bandwidth (~4 ns at 3.35 TB/s).
//
// Design: one thread per leaf row, 256 threads per block, ceil(D/256)
// blocks, a loop over R inside the thread (R is any value >= 1; the TPU
// kernel's one-lane-row limit of R <= 128 does not apply). Every thread
// of a block reads the same R request words, so they are served from
// cache after the first warp. has_leader is a device int32 scalar, like
// the Pallas flags_ref, so a placer loop never synchronises with the
// host. The row arithmetic (floor division, wrapping leader
// subtraction) is kueue_tas::leaf_row in tas_leaf.cuh, which the
// sequential placer (tas_place.cu) runs too.

#include <cuda_runtime.h>

#include "tas_leaf.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void leaf_states_kernel(const int* __restrict__ cap,
                                   const int* __restrict__ per_pod,
                                   const int* __restrict__ leader,
                                   const int* __restrict__ has_leader,
                                   int D, int R,
                                   int* __restrict__ st,
                                   int* __restrict__ swl,
                                   int* __restrict__ ls) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const kueue_tas::LeafState s = kueue_tas::leaf_row(
      cap + static_cast<long long>(d) * R, per_pod, leader,
      __ldg(has_leader) > 0, R);
  st[d] = s.st;
  swl[d] = s.swl;
  ls[d] = s.ls;
}

}  // namespace

// Plain C entry bound with ctypes. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() so a refused
// launch is reported to the caller.
extern "C" int kueue_leaf_states(const int* cap, const int* per_pod,
                                 const int* leader, const int* has_leader,
                                 int D, int R, int* st, int* swl, int* ls,
                                 void* stream) {
  if (D <= 0) return 0;
  const int blocks = (D + kThreads - 1) / kThreads;
  leaf_states_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      cap, per_pod, leader, has_leader, D, R, st, swl, ls);
  return static_cast<int>(cudaGetLastError());
}
