// TAS fill-in counts for Hopper (sm_90a): phase 1 of a TAS placement,
// every level of the domain tree, in one launch.
//
// Replaces, on the host placement's device fill (TASDeviceFillCounts,
// kueue_oss_tpu_torch/tas/snapshot.py _device_fill), the JAX program
// kueue_oss_tpu/solver/tas_kernels.py:289-344 fill_counts_ext: the Pallas
// leaf pass (kueue_oss_tpu/solver/pallas_tas.py:99 leaf_states) followed
// by a segment_sum / segment_min / segment_max roll-up over the levels.
// The port ran that as the leaf_states launch plus ~8 eager ops a level
// and a stack of 5 x L tensors; this kernel computes the same
// [5, total_domains] int32 block (rows st, swl, ls, ss, sswl; columns
// level 0 first, each level's domains in order) with the arithmetic of
// kueue_tas::fill_counts_block (tas_fill.cuh), which the sequential
// placer (tas_place.cu) runs once per podset.
//
// Inputs: the tree as cuda_tas.PlacerTree flattens it ([sizes L]
// [parents N][cbeg N][cend N]), the [D, R] leaf capacity and one int32
// vector [per_pod R][leader_per_pod R][has_leader][slice_size]
// [slice_level], so the host uploads capacity and request in one copy
// and never reads a device value to learn the flags.
//
// Bound: at phase 14's fill (the 1 x 10 x 64 tree, R = 2) the function
// moves ~20 KB (capacity, parents, the [5, 651] output): a few
// nanoseconds of HBM time. It is bounded by its launch and its chain of
// L block barriers.
//
// Design: one block (up to 1024 threads, strided loops, so any tree);
// the leaf pass a thread per leaf, the up-pass a warp per parent domain
// with shuffle reductions. The five states live in dynamic shared memory
// when they fit (cuda_tas.PlacerTree.fill_uses_shared); otherwise the
// same code runs on the output buffer itself (L2-resident) and the copy
// out is skipped.

#include <cuda_runtime.h>

#include "tas_fill.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads, 1)
    fill_counts_kernel(const int* __restrict__ tree, int L, int N, int D,
                       int R, const int* __restrict__ cap,
                       const int* __restrict__ vec, int* __restrict__ out,
                       int in_shared) {
  extern __shared__ int smem[];
  int* sizes = smem;
  int* base = sizes + L;
  int* state = in_shared ? base + L + 1 : out;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L; i += nt) sizes[i] = tree[i];
  if (tid == 0) {
    int acc = 0;
    for (int l = 0; l < L; ++l) {
      base[l] = acc;
      acc += tree[l];
    }
    base[L] = acc;
  }
  __syncthreads();
  const kueue_tas::FillState s{state, state + N, state + 2 * N,
                               state + 3 * N, state + 4 * N};
  const kueue_tas::FillTree t{sizes, base, tree + L + N, tree + L + 2 * N,
                              L};
  const kueue_tas::FillReq q{vec, vec + R, vec[2 * R] > 0,
                             kueue_tas::imax(vec[2 * R + 1], 1),
                             vec[2 * R + 2]};
  kueue_tas::fill_counts_block(s, t, cap, D, R, q);
  if (in_shared)
    for (int i = tid; i < 5 * N; i += nt) out[i] = state[i];
}

}  // namespace

// Plain C entry bound with ctypes. Launches one block on `stream`,
// allocates nothing, does not synchronise. `in_shared` keeps the state in
// dynamic shared memory (4 * (2 L + 1 + 5 N) bytes); otherwise it lives
// in `out`. Returns cudaErrorInvalidValue when the sizes cannot describe
// a tree, else cudaGetLastError() after the launch.
extern "C" int kueue_fill_counts(const int* tree, int L, int N, int D,
                                 int Dmax, int R, const int* cap,
                                 const int* vec, int* out, int in_shared,
                                 void* stream) {
  if (L < 1 || N < L || D < 1 || R < 1 || Dmax < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      Dmax >= kMaxThreads ? kMaxThreads : ((Dmax + 31) / 32) * 32;
  const size_t smem =
      static_cast<size_t>(2 * L + 1 + (in_shared ? 5LL * N : 0)) *
      sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fill_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fill_counts_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tree, L, N, D, R, cap, vec, out, in_shared);
  return static_cast<int>(cudaGetLastError());
}
