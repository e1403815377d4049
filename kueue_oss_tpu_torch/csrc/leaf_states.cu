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
// kernel's one-lane-row limit of R <= 128 does not apply). The request
// vectors are read through the read-only cache (__ldg): every thread of
// a block reads the same R words, so they are served from cache after
// the first warp. has_leader is a device int32 scalar, like the Pallas
// flags_ref, so a placer loop never synchronises with the host.
// Division floors (JAX's //), also for negative numerators; the leader
// subtraction wraps in two's complement like the int32 JAX program.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int floor_div(int a, int b) {
  // b >= 1 here, so a / b cannot overflow
  int q = a / b;
  int r = a - q * b;
  return (r != 0 && (r < 0)) ? q - 1 : q;
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) -
                          static_cast<unsigned int>(b));
}

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
  const int* row = cap + static_cast<long long>(d) * R;

  bool fits = __ldg(has_leader) > 0;
  int m_st = kBig;
  for (int r = 0; r < R; ++r) {
    const int c = row[r];
    const int req = __ldg(per_pod + r);
    const int lead = __ldg(leader + r);
    if (lead > 0 && c < lead) fits = false;
    if (req > 0) m_st = min(m_st, floor_div(c, req));
  }
  int m_swl = kBig;
  for (int r = 0; r < R; ++r) {
    const int req = __ldg(per_pod + r);
    if (req <= 0) continue;
    const int rem = fits ? wrap_sub(row[r], __ldg(leader + r)) : row[r];
    m_swl = min(m_swl, floor_div(rem, req));
  }
  st[d] = m_st;
  swl[d] = m_swl;
  ls[d] = fits ? 1 : 0;
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
