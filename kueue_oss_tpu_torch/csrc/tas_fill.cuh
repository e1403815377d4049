// TAS phase 1 for one block: the leaf pass and every level's up-pass of
// pods, slices and leader states (fillInCounts + fillInCountsHelper,
// tas_flavor_snapshot.go:1568-1719; the JAX package's fill_counts_ext,
// kueue_oss_tpu/solver/tas_kernels.py:289-344). Shared by the fill-in
// counts kernel (fill_counts.cu) and the sequential placer (tas_place.cu,
// once per placed podset), so the wrapping adds and subtracts, the
// empty-segment identities and the floor division exist once.
//
// For a parent domain d of level l-1 with children [cbeg, cend) of level l:
//   st   = sum of the children's st (wrapping), 0 when empty
//   ss   = floor(st / slice_size) at the slice level, else the sum of ss
//   ls   = max of the children's ls, INT32_MIN when empty
//   swl  = st - min over contributors of (st - swl), 0 without contributors
//   sswl = floor(swl / slice_size) at the slice level, else
//          ss - min over contributors of (ss - sswl), 0 without them
// where a contributor is a child with ls > 0, or any child when no leader
// is requested (ops.segment_* identities: 0, INT32_MAX, INT32_MIN).

#pragma once

#include "tas_leaf.cuh"

namespace kueue_tas {

constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// warp reductions: every lane gets the result
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = imin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = imax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = wrap_add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The five states of every domain, each an array over all levels'
// domains: level l's domain i at base[l] + i.
struct FillState {
  int *st, *swl, *ls, *ss, *sswl;
};

// The tree: per level its size and first index, per domain its
// children's range [cbeg, cend) in the next level.
struct FillTree {
  const int* sizes;
  const int* base;
  const int* cbeg;
  const int* cend;
  int levels;
};

// One request: per-pod and leader requests [R], the leader flag, the
// slice divisor (slice_size clamped to >= 1) and the slice level.
struct FillReq {
  const int* per_pod;
  const int* leader;
  bool has_leader;
  int ss_div, slice_level;
};

// Every thread of the block calls it (it holds block barriers);
// blockDim.x is a multiple of 32. cap is the [D, R] leaf capacity.
__device__ __forceinline__ void fill_counts_block(const FillState& s,
                                                  const FillTree& t,
                                                  const int* cap, int D,
                                                  int R, const FillReq& q) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int leaf = t.levels - 1;
  {
    const int b = t.base[leaf];
    const bool at_sl = q.slice_level == leaf;
    for (int i = tid; i < D; i += nt) {
      const LeafState v =
          leaf_row(cap + i * R, q.per_pod, q.leader, q.has_leader, R);
      s.st[b + i] = v.st;
      s.swl[b + i] = v.swl;
      s.ls[b + i] = v.ls;
      s.ss[b + i] = at_sl ? floor_div(v.st, q.ss_div) : 0;
      s.sswl[b + i] = at_sl ? floor_div(v.swl, q.ss_div) : 0;
    }
    __syncthreads();
  }
  for (int l = leaf; l >= 1; --l) {
    const int b = t.base[l], pb = t.base[l - 1];
    const bool at_sl = q.slice_level == l - 1;
    for (int d = warp; d < t.sizes[l - 1]; d += nw) {
      const int a = t.cbeg[pb + d], e = t.cend[pb + d];
      int total = 0, s_total = 0, any_contrib = 0;
      int min_sd = kIntMax, min_ssd = kIntMax, ls_up = kIntMin;
      for (int i = b + a + lane; i < b + e; i += 32) {
        const int st = s.st[i], ls = s.ls[i], ss = s.ss[i];
        total = wrap_add(total, st);
        s_total = wrap_add(s_total, ss);
        const bool contrib = !q.has_leader || ls > 0;
        any_contrib |= contrib ? 1 : 0;
        min_sd = imin(min_sd, contrib ? wrap_sub(st, s.swl[i]) : kBig);
        min_ssd = imin(min_ssd, contrib ? wrap_sub(ss, s.sswl[i]) : kBig);
        ls_up = imax(ls_up, ls);
      }
      total = warp_sum(total);
      s_total = warp_sum(s_total);
      any_contrib = warp_max(any_contrib);
      min_sd = warp_min(min_sd);
      min_ssd = warp_min(min_ssd);
      ls_up = warp_max(ls_up);
      if (lane == 0) {
        const int swl_up = any_contrib ? wrap_sub(total, min_sd) : 0;
        const int sswl_up = any_contrib ? wrap_sub(s_total, min_ssd) : 0;
        s.st[pb + d] = total;
        s.swl[pb + d] = swl_up;
        s.ls[pb + d] = ls_up;
        s.ss[pb + d] = at_sl ? floor_div(total, q.ss_div) : s_total;
        s.sswl[pb + d] = at_sl ? floor_div(swl_up, q.ss_div) : sswl_up;
      }
    }
    __syncthreads();
  }
}

}  // namespace kueue_tas
