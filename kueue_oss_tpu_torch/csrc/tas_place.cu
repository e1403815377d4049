// TAS sequential placement for Hopper (sm_90a): the drain's whole
// sequential TAS placement in one launch.
//
// Replaces, as a redesign for this card, the Pallas TPU kernel
// kueue_oss_tpu/solver/pallas_tas.py (_leaf_states_kernel, launched by
// leaf_states at pallas_tas.py:99) together with the jitted lax.scan
// around it (kueue_oss_tpu/solver/tas_kernels.py:250-283,
// make_sequential_placer_ext). On the TPU XLA fuses the leaf pass into
// one device program with the scan; on Hopper the standalone leaf kernel
// (leaf_states.cu) sat alone among ~350 eager PyTorch ops per placed
// podset, so its 13 KB of work was hidden behind launch overhead. This
// kernel computes exactly what the port's plain sequential placer
// computes (kueue_oss_tpu_torch/solver/tas_kernels.py
// make_sequential_placer_ext): for m = 0..M-1, with the leaf-capacity
// carry between steps,
//   phase 1 (fill_counts_ext): the leaf pass (kueue_tas::leaf_row, shared
//     with leaf_states.cu) and every level's up-pass of pods, slices and
//     leader states;
//   phase 2: the level choice (findLevelWithFitDomains), the seed (one
//     domain, or the greedy over the whole start level), the descent
//     (_greedy_segment_lead + _consume_in_order per sibling group), the
//     feasibility test and the carry update.
// Outputs are bit-identical to the plain version: every int32 add,
// subtract, negate and multiply wraps (kueue_tas::wrap_*), division
// floors, BIG = 1 << 30 is both sentinel and clamp, empty reductions
// give the identities of ops.segment_* (0, INT32_MAX, INT32_MIN), and
// argmin / argmax take the first index on ties.
//
// Bound: the work is tiny (the drain's 651-domain tree, R = 2) and
// strictly sequential across steps, because step m+1 reads the capacity
// that step m left. The bytes the function must move are its inputs and
// outputs (~0.28 MB for the drain, dominated by sels [M, D]); the kernel
// is bounded instead by its chain of block barriers, a few dozen per
// step.
//
// Design:
// - One thread block (up to 1024 threads, strided loops, so any D). The
//   parallelism is across the domains of a level inside a step.
// - The whole tree state lives in one int32 region: the capacity carry,
//   per level st/swl/ls/ss/sswl/sel/lead, the parent and child-range
//   (CSR) arrays and the greedy's scratch. It is dynamic shared memory
//   when it fits (opted in above 48 KB with cudaFuncSetAttribute); when
//   the wrapper computes a footprint above 227 KB it passes a global
//   scratch buffer instead and the same code runs on it (L2-resident).
// - Segment reductions are loops over child ranges: build_levels orders
//   every level lexicographically, so each parent's children are one
//   contiguous range [cbeg, cend). One warp per sibling group runs the
//   group's dependent chain of reductions (leader choice, prefix scan,
//   cover, best fit) with shuffles and no block barrier.
// - The sort of _greedy_segment_lead (lexsort keys (seg, key, +-ss, st,
//   idx); idx last, so keys are unique) is a rank by counting inside each
//   child range; the in-segment exclusive prefix of _consume_in_order is
//   a warp scan. The plain version's prefix runs over the whole level
//   (cumsum, then a cummax of segment starts); its per-group offset is
//   kept exactly (delta below) so wrapped sums agree too.
// - Only what the plain version keeps is computed: the greedy seed only
//   at the start level, the descent only below it, the leader passes only
//   for groups that route a leader.

#include <cuda_runtime.h>

#include "tas_leaf.cuh"

namespace {

using kueue_tas::floor_div;
using kueue_tas::kBig;
using kueue_tas::wrap_add;
using kueue_tas::wrap_mul;
using kueue_tas::wrap_neg;
using kueue_tas::wrap_sub;

constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;
constexpr long long kLongMax = 0x7fffffffffffffffLL;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

struct Params {
  const int* tree;  // [sizes L][parents N][cbeg N][cend N]
  const int* cap_in;
  const int* per_pod;
  const int* count;
  const int* level;
  const unsigned char* required;
  const unsigned char* unconstrained;
  const unsigned char* least_free;
  const int* slice_size;
  const int* slice_level;
  const int* leader_per_pod;
  const unsigned char* has_leader;
  int* sels;
  int* leads;
  unsigned char* oks;
  int* cap_out;
  int* gstate;  // null: the state is in dynamic shared memory
  int L, N, D, R, M, Dmax, Smax;
};

// State words: sizes L, base L+1, cap D*R, 10 per-domain arrays of N,
// 3 per-domain scratch arrays of Dmax, 5 per-group arrays of Smax.
// cuda_tas.PlacerTree.state_words computes the same count.
long long state_words(int L, int N, int D, int R, int Dmax, int Smax) {
  return 2LL * L + 1 + static_cast<long long>(D) * R + 10LL * N +
         3LL * Dmax + 5LL * Smax;
}

struct State {
  int *sizes, *base, *cap;
  int *st, *swl, *ls, *ss, *sswl, *sel, *lead, *parent, *cbeg, *cend;
  int *at_pos, *s_sorted, *rem;
  int *lead_idx, *lead_take, *rest_need, *total, *delta;
};

__device__ State carve(int* q, const Params& p) {
  State s;
  s.sizes = q; q += p.L;
  s.base = q; q += p.L + 1;
  s.cap = q; q += p.D * p.R;
  int** per_domain[] = {&s.st, &s.swl, &s.ls, &s.ss, &s.sswl,
                        &s.sel, &s.lead, &s.parent, &s.cbeg, &s.cend};
  for (int** a : per_domain) { *a = q; q += p.N; }
  s.at_pos = q; q += p.Dmax;
  s.s_sorted = q; q += p.Dmax;
  s.rem = q; q += p.Dmax;
  int** per_group[] = {&s.lead_idx, &s.lead_take, &s.rest_need, &s.total,
                       &s.delta};
  for (int** a : per_group) { *a = q; q += p.Smax; }
  return s;
}

// One podset's request, as every thread of the block reads it.
struct Req {
  const int* pp;
  const int* lpp;
  int count, level, ss_div, slice_level, slice_count;
  bool required, unconstrained, least_free, hl;
  // placement units at level l: slices at or above the slice level
  __device__ int units_at(int l) const {
    return slice_level >= l ? slice_count : count;
  }
};

// ---- warp and block reductions (every lane / thread gets the result) --

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
// inclusive prefix sum over the lanes, wrapping
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = wrap_add(v, y);
  }
  return v;
}

struct MinOp {
  static constexpr long long kId = kLongMax;
  __device__ static long long f(long long a, long long b) {
    return a < b ? a : b;
  }
};
struct SumOp {
  static constexpr long long kId = 0;
  __device__ static long long f(long long a, long long b) { return a + b; }
};

template <class Op>
__device__ __forceinline__ long long warp_reduce64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v = Op::f(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Two block-wide reductions at once; red holds 64 words of shared memory.
template <class OpA, class OpB>
__device__ void block_reduce2(long long& a, long long& b, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_reduce64<OpA>(a);
  b = warp_reduce64<OpB>(b);
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = warp_reduce64<OpA>(lane < nw ? red[lane] : OpA::kId);
  b = warp_reduce64<OpB>(lane < nw ? red[32 + lane] : OpB::kId);
}

// (value, index) packed so that the minimum is the smallest value and,
// among equal values, the first index (torch.argmin's tie rule)
__device__ __forceinline__ long long pack(int v, int i) {
  return static_cast<long long>(v) * 4294967296LL + i;
}
__device__ __forceinline__ int packed_value(long long x) {
  return static_cast<int>(x >> 32);
}
__device__ __forceinline__ int packed_index(long long x) {
  return static_cast<int>(x & 0xffffffffLL);
}
// sum_i32: an int64 sum cast to int32, i.e. the wrapped int32 sum
__device__ __forceinline__ int to_i32(long long x) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<unsigned long long>(x)));
}

// ---- _greedy_segment_lead + _consume_in_order --------------------------

// Sibling groups of level `lev`: in the seed one group, the whole level
// (need `seed_need`, leader flag req.hl); in the descent one group per
// domain p of level lev-1, its children [cbeg, cend), with the parent's
// selection as need (in the children's units) and its lead flag.
struct Groups {
  const State& s;
  const Req& q;
  int lev, seed_need, pb, n;
  bool seed;
  __device__ void range(int p, int& a, int& e) const {
    if (seed) {
      a = 0;
      e = s.sizes[lev];
    } else {
      a = s.cbeg[pb + p];
      e = s.cend[pb + p];
    }
  }
  __device__ int need(int p) const {
    if (seed) return seed_need;
    const int v = s.sel[pb + p];
    // parents at or above the slice level hold slices, children below pods
    const bool crosses = q.slice_level < lev && q.slice_level >= lev - 1;
    return crosses ? wrap_mul(v, q.ss_div) : v;
  }
  __device__ bool leads(int p) const {
    return seed ? q.hl : s.lead[pb + p] != 0;
  }
  __device__ int group_of(int i) const {
    return seed ? 0 : s.parent[s.base[lev] + i];
  }
};

__device__ void greedy(const State& s, const Req& q, int lev, bool seed,
                       int seed_need) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int b = s.base[lev], D = s.sizes[lev];
  const bool in_sl = q.slice_level >= lev;
  const int* u_state = in_sl ? s.ss : s.st;
  const int* u_swl = in_sl ? s.sswl : s.swl;
  const Groups g{s, q, lev, seed_need, seed ? 0 : s.base[lev - 1],
                 seed ? 1 : s.sizes[lev - 1], seed};

  // A. the leader's domain per group (sortedDomainsWithLeader order, then
  //    the best-fit swap), its take, and the group's remaining need
  for (int p = warp; p < g.n; p += nw) {
    int a, e;
    g.range(p, a, e);
    const int need = g.need(p);
    int li = -1, lt = 0;
    if (g.leads(p) && a < e) {
      int m1 = kIntMax, ls_max = kIntMin;
      for (int i = a + lane; i < e; i += 32) {
        const int v = s.ls[b + i];
        m1 = imin(m1, wrap_neg(v));
        ls_max = imax(ls_max, v);
      }
      m1 = warp_min(m1);
      ls_max = warp_max(ls_max);
      int m2 = kIntMax;
      for (int i = a + lane; i < e; i += 32) {
        const bool c1 = wrap_neg(s.ls[b + i]) == m1;
        const int key = q.least_free ? s.sswl[b + i] : wrap_neg(s.sswl[b + i]);
        m2 = imin(m2, c1 ? key : kBig);
      }
      m2 = warp_min(m2);
      int m3 = kIntMax;
      for (int i = a + lane; i < e; i += 32) {
        const bool c1 = wrap_neg(s.ls[b + i]) == m1;
        const int key = q.least_free ? s.sswl[b + i] : wrap_neg(s.sswl[b + i]);
        m3 = imin(m3, (c1 && key == m2) ? s.swl[b + i] : kBig);
      }
      m3 = warp_min(m3);
      int top = kIntMax;
      for (int i = a + lane; i < e; i += 32) {
        const bool c1 = wrap_neg(s.ls[b + i]) == m1;
        const int key = q.least_free ? s.sswl[b + i] : wrap_neg(s.sswl[b + i]);
        const bool c3 = c1 && key == m2 && s.swl[b + i] == m3;
        top = imin(top, c3 ? i : kBig);
      }
      top = warp_min(top);
      // the plain version clamps and reads row D-1 when no domain leads
      const int top_of = imin(top, D - 1);
      const bool top_fits = u_swl[b + top_of] >= need && s.ls[b + top_of] > 0;
      int bf_first = kBig;
      if (top_fits && !q.least_free) {
        int bf_min = kIntMax;
        for (int i = a + lane; i < e; i += 32) {
          const bool elig = s.ls[b + i] > 0 && u_swl[b + i] >= need;
          bf_min = imin(bf_min, elig ? u_swl[b + i] : kBig);
        }
        bf_min = warp_min(bf_min);
        for (int i = a + lane; i < e; i += 32) {
          const bool elig = s.ls[b + i] > 0 && u_swl[b + i] >= need;
          bf_first = imin(bf_first, (elig && u_swl[b + i] == bf_min) ? i : kBig);
        }
        bf_first = warp_min(bf_first);
      }
      const int lead_dom = bf_first < kBig ? bf_first : top;
      if (lead_dom < kBig && ls_max > 0) {
        li = lead_dom;
        lt = imin(u_swl[b + li], need);
      }
    }
    if (lane == 0) {
      s.lead_idx[p] = li;
      s.lead_take[p] = lt;
      s.rest_need[p] = imax(wrap_sub(need, lt), 0);
    }
  }
  __syncthreads();

  // B. order each group by (key, +-ss, st, idx): rank by counting
  for (int i = tid; i < D; i += nt) {
    const int p = g.group_of(i);
    int a, e;
    g.range(p, a, e);
    const int li = s.lead_idx[p];
    const int k0 = i == li ? kBig : 0;
    const int k1 = q.least_free ? s.ss[b + i] : wrap_neg(s.ss[b + i]);
    const int k2 = s.st[b + i];
    int rank = 0;
    for (int j = a; j < e; ++j) {
      const int j0 = j == li ? kBig : 0;
      const int j1 = q.least_free ? s.ss[b + j] : wrap_neg(s.ss[b + j]);
      const int j2 = s.st[b + j];
      const bool less = j0 != k0   ? j0 < k0
                        : j1 != k1 ? j1 < k1
                        : j2 != k2 ? j2 < k2
                                   : j < i;
      rank += less ? 1 : 0;
    }
    const int pos = a + rank;
    s.at_pos[pos] = i;
    s.s_sorted[pos] = i == li ? 0 : u_state[b + i];
  }
  __syncthreads();

  // C. _consume_in_order. Its prefix is the level-wide cumsum minus the
  //    running maximum of the group starts' exclusive sums; per group that
  //    is the in-group exclusive prefix plus delta = start - running max.
  for (int p = warp; p < g.n; p += nw) {
    int a, e;
    g.range(p, a, e);
    int t = 0;
    for (int pos = a + lane; pos < e; pos += 32) t = wrap_add(t, s.s_sorted[pos]);
    t = warp_sum(t);
    if (lane == 0) s.total[p] = t;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0, run_max = kIntMin;
    for (int c0 = 0; c0 < g.n; c0 += 32) {
      const int p = c0 + lane;
      const int t = p < g.n ? s.total[p] : 0;
      const int incl = warp_scan(t, lane);
      const int start = wrap_add(carry, wrap_sub(incl, t));
      int m = start;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, m, o);
        if (lane >= o) m = imax(m, y);
      }
      m = imax(m, run_max);
      if (p < g.n) s.delta[p] = wrap_sub(start, m);
      carry = wrap_add(carry, __shfl_sync(kFull, incl, 31));
      run_max = __shfl_sync(kFull, m, 31);
    }
  }
  __syncthreads();
  for (int p = warp; p < g.n; p += nw) {
    int a, e;
    g.range(p, a, e);
    if (a >= e) continue;
    const int need = s.rest_need[p], delta = s.delta[p];
    // take whole domains until the remainder fits one (position q) ...
    int carry = 0, q_pos = kBig, r = 0;
    for (int c0 = a; c0 < e; c0 += 32) {
      const int pos = c0 + lane;
      const int sv = pos < e ? s.s_sorted[pos] : 0;
      const int incl = warp_scan(sv, lane);
      const int prefix = wrap_add(wrap_add(carry, wrap_sub(incl, sv)), delta);
      const int remaining = imax(wrap_sub(need, prefix), 0);
      if (pos < e) s.rem[pos] = remaining;
      const unsigned covers =
          __ballot_sync(kFull, pos < e && sv >= remaining && remaining > 0);
      if (q_pos == kBig && covers != 0) {
        const int first = __ffs(covers) - 1;
        q_pos = c0 + first;
        r = __shfl_sync(kFull, remaining, first);
      }
      carry = wrap_add(carry, __shfl_sync(kFull, incl, 31));
    }
    // ... then best-fit the remainder r at or after q
    int best = kBig;
    if (r > 0) {
      int s_min = kIntMax;
      for (int pos = a + lane; pos < e; pos += 32) {
        const int sv = s.s_sorted[pos];
        s_min = imin(s_min, (pos >= q_pos && sv >= r) ? sv : kBig);
      }
      s_min = warp_min(s_min);
      for (int pos = a + lane; pos < e; pos += 32) {
        const int sv = s.s_sorted[pos];
        best = imin(best, (pos >= q_pos && sv >= r && sv == s_min) ? pos : kBig);
      }
      best = warp_min(best);
    }
    const int li = s.lead_idx[p], lt = s.lead_take[p];
    for (int pos = a + lane; pos < e; pos += 32) {
      const int i = s.at_pos[pos];
      int take = (pos < q_pos && s.rem[pos] > 0) ? s.s_sorted[pos] : 0;
      take = wrap_add(take, pos == best ? r : 0);
      s.sel[b + i] = wrap_add(take, i == li ? lt : 0);
      s.lead[b + i] = i == li ? 1 : 0;
    }
  }
  __syncthreads();
}

// ---- one podset: make_placer_ext.place + the capacity carry -----------

__device__ void place_step(const State& s, const Params& p, int m,
                           long long* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int L = p.L, R = p.R, leaf = L - 1;
  Req q;
  q.pp = p.per_pod + static_cast<long long>(m) * R;
  q.lpp = p.leader_per_pod + static_cast<long long>(m) * R;
  q.count = p.count[m];
  q.level = p.level[m];
  q.required = p.required[m] != 0;
  q.unconstrained = p.unconstrained[m] != 0;
  q.least_free = p.least_free[m] != 0;
  q.hl = p.has_leader[m] != 0;
  q.ss_div = imax(p.slice_size[m], 1);
  q.slice_level = p.slice_level[m];
  q.slice_count = floor_div(q.count, q.ss_div);

  // ---- phase 1: leaf pass, then the up-pass level by level -------------
  {
    const int b = s.base[leaf];
    const bool at_sl = q.slice_level == leaf;
    for (int i = tid; i < p.D; i += nt) {
      const kueue_tas::LeafState v =
          kueue_tas::leaf_row(s.cap + i * R, q.pp, q.lpp, q.hl, R);
      s.st[b + i] = v.st;
      s.swl[b + i] = v.swl;
      s.ls[b + i] = v.ls;
      s.ss[b + i] = at_sl ? floor_div(v.st, q.ss_div) : 0;
      s.sswl[b + i] = at_sl ? floor_div(v.swl, q.ss_div) : 0;
    }
    __syncthreads();
  }
  for (int l = leaf; l >= 1; --l) {
    const int b = s.base[l], pb = s.base[l - 1];
    const bool at_sl = q.slice_level == l - 1;
    for (int d = warp; d < s.sizes[l - 1]; d += nw) {
      const int a = s.cbeg[pb + d], e = s.cend[pb + d];
      int total = 0, s_total = 0, any_contrib = 0;
      int min_sd = kIntMax, min_ssd = kIntMax, ls_up = kIntMin;
      for (int i = b + a + lane; i < b + e; i += 32) {
        const int st = s.st[i], ls = s.ls[i], ss = s.ss[i];
        total = wrap_add(total, st);
        s_total = wrap_add(s_total, ss);
        // leader contributors: children able to host the leader (or no
        // leader requested at all)
        const bool contrib = !q.hl || ls > 0;
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

  // ---- findLevelWithFitDomains: the lowest allowed level with a fit,
  //      walking up for preferred requests ---------------------------------
  int chosen_level = -1, chosen_dom = 0;
  for (int l = imin(q.level, leaf); l >= 0; --l) {
    if ((q.required || q.unconstrained) && q.level != l) continue;
    const int b = s.base[l];
    const bool in_sl = q.slice_level >= l;
    const int nd = q.units_at(l);
    long long first_fit = kLongMax, best_fit = kLongMax;
    for (int i = tid; i < s.sizes[l]; i += nt) {
      const int ust = in_sl ? s.ss[b + i] : s.st[b + i];
      const int uswl = in_sl ? s.sswl[b + i] : s.swl[b + i];
      const bool ok_lead = s.ls[b + i] > 0 || !q.hl;
      // least-free still must hold the leader when one exists
      const bool fits = (q.least_free && !q.hl) ? ust >= nd
                                                : (uswl >= nd && ok_lead);
      first_fit = MinOp::f(first_fit, pack(fits ? i : kBig, i));
      best_fit = MinOp::f(best_fit, pack(fits ? uswl : kBig, i));
    }
    block_reduce2<MinOp, MinOp>(first_fit, best_fit, red);
    if (packed_value(first_fit) < kBig) {  // some domain fits
      chosen_level = l;
      chosen_dom = packed_index(q.least_free ? first_fit : best_fit);
      break;
    }
  }

  // ---- seed at the start level, then descend ----------------------------
  const bool single_fit = chosen_level >= 0;
  const int greedy_level = q.unconstrained ? q.level : 0;
  const int start = single_fit ? chosen_level : greedy_level;
  const int s0 = imax(start, 0);  // the first level the descent reads
  bool feasible = false;
  if (s0 <= leaf) {
    const int b = s.base[s0];
    if (single_fit) {
      const int units = q.units_at(s0);
      for (int i = tid; i < s.sizes[s0]; i += nt) {
        s.sel[b + i] = i == chosen_dom ? units : 0;
        s.lead[b + i] = (i == chosen_dom && q.hl) ? 1 : 0;
      }
      feasible = true;
      __syncthreads();
    } else if (!q.required && greedy_level == s0) {
      const int units = q.units_at(s0);
      greedy(s, q, s0, true, units);
      const bool in_sl = q.slice_level >= s0;
      long long sum = 0, any_lead = 0;
      for (int i = tid; i < s.sizes[s0]; i += nt) {
        const bool gl = s.lead[b + i] != 0;
        const bool use_swl = q.hl && gl;
        sum += use_swl ? (in_sl ? s.sswl[b + i] : s.swl[b + i])
                       : (in_sl ? s.ss[b + i] : s.st[b + i]);
        any_lead = gl ? 1 : any_lead;
      }
      block_reduce2<SumOp, SumOp>(sum, any_lead, red);
      const bool cap_ok = to_i32(sum) >= units && (any_lead > 0 || !q.hl);
      if (!cap_ok) {
        for (int i = tid; i < s.sizes[s0]; i += nt) {
          s.sel[b + i] = 0;
          s.lead[b + i] = 0;
        }
        __syncthreads();
      }
      feasible = cap_ok;
    } else {
      for (int i = tid; i < s.sizes[s0]; i += nt) {
        s.sel[b + i] = 0;
        s.lead[b + i] = 0;
      }
      __syncthreads();
    }
    for (int lev = s0 + 1; lev <= leaf; ++lev) greedy(s, q, lev, false, 0);
  }

  // ---- feasibility, leader leaf, carry ----------------------------------
  const bool placed = s0 <= leaf;  // else every leaf selection is 0
  const int bl = s.base[leaf];
  const bool leaf_sl = q.slice_level >= leaf;
  long long total = 0, first_lead = kLongMax;
  for (int i = tid; i < p.D; i += nt) {
    const int v = placed ? s.sel[bl + i] : 0;
    total += leaf_sl ? wrap_mul(v, q.ss_div) : v;
    if (placed && s.lead[bl + i] != 0) first_lead = MinOp::f(first_lead, i);
  }
  block_reduce2<SumOp, MinOp>(total, first_lead, red);
  const bool any_lead = first_lead != kLongMax;
  feasible = feasible && to_i32(total) == q.count && (!q.hl || any_lead);
  const int lead_leaf = (q.hl && feasible) ? static_cast<int>(first_lead) : -1;
  int* sels = p.sels + static_cast<long long>(m) * p.D;
  for (int i = tid; i < p.D; i += nt) {
    const int v = placed ? s.sel[bl + i] : 0;
    const int take = feasible ? (leaf_sl ? wrap_mul(v, q.ss_div) : v) : 0;
    int* row = s.cap + i * R;
    for (int r = 0; r < R; ++r) row[r] = wrap_sub(row[r], wrap_mul(take, q.pp[r]));
    if (i == lead_leaf)
      for (int r = 0; r < R; ++r) row[r] = wrap_sub(row[r], q.lpp[r]);
    sels[i] = take;
  }
  if (tid == 0) {
    p.leads[m] = feasible ? lead_leaf : -1;
    p.oks[m] = feasible ? 1 : 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    tas_place_kernel(const Params p) {
  extern __shared__ int smem[];
  __shared__ long long red[64];
  const State s = carve(p.gstate != nullptr ? p.gstate : smem, p);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < p.L; i += nt) s.sizes[i] = p.tree[i];
  for (int i = tid; i < p.N; i += nt) {
    s.parent[i] = p.tree[p.L + i];
    s.cbeg[i] = p.tree[p.L + p.N + i];
    s.cend[i] = p.tree[p.L + 2 * p.N + i];
  }
  for (int i = tid; i < p.D * p.R; i += nt) s.cap[i] = p.cap_in[i];
  if (tid == 0) {
    int acc = 0;
    for (int l = 0; l < p.L; ++l) {
      s.base[l] = acc;
      acc += p.tree[l];
    }
    s.base[p.L] = acc;
  }
  __syncthreads();
  for (int m = 0; m < p.M; ++m) place_step(s, p, m, red);
  for (int i = tid; i < p.D * p.R; i += nt) p.cap_out[i] = s.cap[i];
}

}  // namespace

// Plain C entry bound with ctypes. Launches one block on `stream`,
// allocates nothing, does not synchronise. `gstate` is null when the
// state fits in shared memory, else a device buffer of `state_words`
// int32 words. Returns cudaErrorInvalidValue when the sizes disagree with
// the state layout, else cudaGetLastError() after the launch.
extern "C" int kueue_tas_place_sequential(
    const int* tree, int L, int N, int D, int Dmax, int Smax, int R, int M,
    const int* cap_in, const int* per_pod, const int* count,
    const int* level, const unsigned char* required,
    const unsigned char* unconstrained, const unsigned char* least_free,
    const int* slice_size, const int* slice_level, const int* leader_per_pod,
    const unsigned char* has_leader, int* sels, int* leads,
    unsigned char* oks, int* cap_out, int* gstate, long long words,
    void* stream) {
  if (L < 1 || N < L || D < 1 || R < 1 || M < 0 || Dmax < D || Smax < 1 ||
      words != state_words(L, N, D, R, Dmax, Smax) || words > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      Dmax >= kMaxThreads ? kMaxThreads : ((Dmax + 31) / 32) * 32;
  const size_t smem =
      gstate != nullptr ? 0 : static_cast<size_t>(words) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tas_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params p{tree, cap_in, per_pod, count, level, required, unconstrained,
                 least_free, slice_size, slice_level, leader_per_pod,
                 has_leader, sels, leads, oks, cap_out, gstate,
                 L, N, D, R, M, Dmax, Smax};
  tas_place_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
