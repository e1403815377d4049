// Relaxed admission LP for Hopper (sm_90a): the projected-gradient loop
// of the relaxed solver arm, every iteration of every scenario in one
// launch, each scenario on one thread-block cluster.
//
// Replaces no Pallas kernel: it is the JAX package's XLA program
// kueue_oss_tpu/solver/relax.py lp_loop (:144-152, the fori_loop of
// lp_step_body :107-142), run as jit(lp_loop) by solve_relaxed and as
// jit(vmap(lp_loop)) by sim/batch.py solve_scenarios_relax. It is a
// hand kernel because the step's segment sums must add in one fixed
// order: float index_add_ / scatter_add on CUDA add in any order, and the
// rounding after the LP thresholds x at 0.5 and sorts by -x, so one last
// bit can change the plan.
//
// Per scenario and iteration i (x starts at 0.5 on live rows, 0 else):
//   load[c,f]  = sum over rows w of CQ c, ascending w, of r[w,f] * x[w]
//   u[n,f]     = load of the CQ at node n (0 elsewhere), then for each
//                level d = D-1 .. 1 every node adds its depth-d children,
//                ascending child index, to its value from before the level
//   over[n,f]  = clamp((u - slack) / scale, 0, 1)
//   price[c,f] = sum over the CQ's ancestor path k = 0 .. D-1 of over
//   pull[w]    = sum over f of (r[w,f] / max(max_f r[w,:], 1)) * price[c(w),f]
//                in XLA:CPU's order (relax.sum_order: for F <= 32, V lanes,
//                lane j adds f = j, j + V, ... below E, lanes folded by
//                halves, then f = E .. F-1 in order; above 32, windows of
//                32 over F padded with P in front, each summed in order,
//                then the windows in order)
//   rho        = i * rho_c + 1, rho_c = 3 * (1 / iters) in float32 (XLA's
//                folding of RHO0 * (1 + RHO_GROWTH * i / iters))
//   x[w]       = live ? clamp(x + 0.5 * (0.05 * s - rho * pull), 0, 1) : 0
// Every operation is an explicitly rounded float32 intrinsic, so nvcc
// contracts nothing into a fused multiply-add (tier-1 compiles the JAX
// program for AVX, which has none), and x is bit for bit relax.lp_loop's
// on the CPU.
//
// Bound (each input read once, x written once, as chip_smoke.py counts
// it): at drain_large_scale's LP (W+1 = 65,537, C = 1,000) about 1.1 MB,
// a third of a microsecond of HBM time. The LP is a chain of 32
// dependent iterations, each a chain of dependent sums (a ClusterQueue's
// rows, a cohort's children), so it is bound by latency, not bytes.
//
// Design (cuda_relax.py picks the cluster size, partitions the rows and
// the layout):
// - One cluster of K blocks (1, 2, 4 or 8, the portable sizes) per
//   scenario. The host cuts the CQ-sorted row list into K contiguous,
//   row-balanced ranges of whole ClusterQueues; block j owns CQs
//   [part[j], part[j+1]) and their rows.
// - A block copies its rows' r and s into shared memory once (cp.async,
//   gathered in CQ order), with x, 0.05 * s, r / max(r, 1) and the row ->
//   local CQ map (-1 for a row that is not live); x stays there for all
//   iterations and is written back once, scattered to the original row
//   order. When the rows do not fit in 227 KB, r and r / max(r, 1) (and,
//   past that, the rest) live in a global scratch buffer, L2-resident:
//   the same code on generic pointers, a layout the host chooses and
//   counts.
// - One thread per (CQ, f) sums the CQ's rows in ascending row order from
//   that memory into the block's load buffer (two, by iteration parity).
// - The tree is computed redundantly by every block: after one
//   cluster.sync() each block gathers all C loads over distributed shared
//   memory into its own u, runs the levels from its shared copy of the
//   child lists, and prices only its own CQs. That saves a second cluster
//   barrier a iteration; the parity buffers keep the next iteration's
//   loads from overwriting what a slower block still reads.
// - Everything else is block-local: __syncthreads() between the steps.
// - Padding rows (wl_cqid outside [0, C)) are never live (the host checks
//   it) and get x = 0; the price gather clamps the id to [0, C-1] as JAX
//   does.
//
// Index layout (every array with a leading scenario axis b): rows[b]
// lists all W+1 rows sorted stably by CQ (the padding id C last), with
// CSR offsets row_off[b, C+1]; kids[b] lists the nodes whose parent is in
// [0, N+1) sorted stably by parent, with offsets kid_off[b, N+2];
// node_cq[b, N+1] is the CQ at each node or -1; part[b, K+1] the blocks'
// CQ ranges.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 8;
constexpr int kMaxCluster = 8;
constexpr int kWindow = 32;  // relax.WINDOW
constexpr int kMaxColumns = 1024;  // relax.MAX_SUM_COLUMNS

struct Params {
  int K, W1, F, C, N1, D, iters;
  float rho_c;
  int lanes, lane_end;     // relax.sum_order(F): (V, E), or (0, P)
  int max_rows, max_cqs;   // the largest block's rows and CQs
  int r_global, x_global;  // where the row arrays live
  long long scratch_words;  // per block, in `scratch`
  const float* r;
  const float* s;
  const unsigned char* live;
  const int* wl_cqid;
  const int* path_cq;
  const int* depth;
  const float* slack;
  const float* scale;
  const int* rows;
  const int* row_off;
  const int* kids;
  const int* kid_off;
  const int* node_cq;
  const int* part;
  float* scratch;
  float* x;
};

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// one word from global memory: an asynchronous copy into shared memory,
// or a plain copy into the global scratch
__device__ __forceinline__ void copy_word(float* dst, const float* src,
                                          bool to_shared) {
  if (to_shared) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

// sum over f of rn[f] * pr[f] in relax.sum_order's order
__device__ __forceinline__ float pull_sum(const float* rn, const float* pr,
                                          int F, int lanes, int lane_end) {
  if (lanes == 0) {
    // F > 32: XLA's reduce-window of 32 (lane_end = the front padding P),
    // each window in order from +0, then the windows in order from +0
    float acc = 0.0f;
    for (int lo = -lane_end; lo < F; lo += kWindow) {
      float w = 0.0f;
      const int z = min(lo + kWindow, F);
      for (int f = max(lo, 0); f < z; ++f)
        w = __fadd_rn(w, __fmul_rn(rn[f], pr[f]));
      acc = __fadd_rn(acc, w);
    }
    return acc;
  }
  float lane[kMaxLanes];
#pragma unroll
  for (int j = 0; j < kMaxLanes; ++j) {
    lane[j] = j == 0 ? 0.0f : -0.0f;
    if (j < lanes)
      for (int f = j; f < lane_end; f += lanes)
        lane[j] = __fadd_rn(lane[j], __fmul_rn(rn[f], pr[f]));
  }
#pragma unroll
  for (int h = kMaxLanes / 2; h >= 1; h >>= 1) {
    if (h < lanes) {
#pragma unroll
      for (int i = 0; i < h; ++i) lane[i] = __fadd_rn(lane[i], lane[i + h]);
    }
  }
  float acc = lane[0];
  for (int f = lane_end; f < F; ++f)
    acc = __fadd_rn(acc, __fmul_rn(rn[f], pr[f]));
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    relax_lp_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ int s_part[kMaxCluster + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, F = p.F, C = p.C, N1 = p.N1, D = p.D;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / K;
  const int tid = threadIdx.x, nt = blockDim.x;

  const float* r = p.r + b * p.W1 * F;
  const float* s = p.s + b * p.W1;
  const unsigned char* live = p.live + b * p.W1;
  const int* wl_cqid = p.wl_cqid + b * p.W1;
  const int* path_cq = p.path_cq + b * C * D;
  const int* depth_g = p.depth + b * N1;
  const float* slack = p.slack + b * N1 * F;
  const float* scale = p.scale + b * N1 * F;
  const int* rows = p.rows + b * p.W1;
  const int* row_off = p.row_off + b * (C + 1);
  const int* kids_g = p.kids + b * N1;
  const int* kid_off_g = p.kid_off + b * (N1 + 1);
  const int* node_cq = p.node_cq + b * N1;
  float* x_out = p.x + b * p.W1;
  if (tid <= K) s_part[tid] = p.part[b * (K + 1) + tid];
  __syncthreads();
  const int c_lo = s_part[rank], nc = s_part[rank + 1] - c_lo;
  const int k_lo = row_off[c_lo], n = row_off[c_lo + nc] - k_lo;

  // shared: loads (two parities), price, u, u_next, the child lists and
  // depths; then the row arrays unless the host put them in `scratch`
  const int cf = p.max_cqs * F;
  float* load2 = smem;
  float* price = load2 + 2 * cf;
  float* u = price + cf;
  float* u_next = u + N1 * F;
  int* kids = reinterpret_cast<int*>(u_next + N1 * F);
  int* kid_off = kids + N1;
  int* depth = kid_off + N1 + 1;
  float* rest = reinterpret_cast<float*>(depth + N1);
  float* gblock = p.scratch + (b * K + rank) * p.scratch_words;
  float* xr;  // x, 0.05 * s, the local CQ map: 3 * max_rows words
  float* rr;  // r, r / max(r, 1): 2 * F * max_rows words
  if (p.x_global) {
    xr = gblock;
    rr = gblock + 3LL * p.max_rows;
  } else {
    xr = rest;
    rr = p.r_global ? gblock : rest + 3LL * p.max_rows;
  }
  float* x = xr;
  float* as = xr + p.max_rows;
  int* cq_of = reinterpret_cast<int*>(xr + 2LL * p.max_rows);
  float* rv = rr;
  float* rn = rr + static_cast<long long>(p.max_rows) * F;

  // ---- prologue: the block's rows in CQ order, the tree's lists --------
  for (int i = tid; i < N1; i += nt) {
    kids[i] = kids_g[i];
    depth[i] = depth_g[i];
  }
  for (int i = tid; i <= N1; i += nt) kid_off[i] = kid_off_g[i];
  for (int e = tid; e < n * F; e += nt) {
    const int k = e / F, f = e - k * F;
    const int w = rows[k_lo + k];
    copy_word(rv + e, r + static_cast<long long>(w) * F + f, !p.r_global);
  }
  for (int k = tid; k < n; k += nt) {
    const int w = rows[k_lo + k];
    copy_word(as + k, s + w, !p.x_global);
    const bool lv = live[w] != 0;
    cq_of[k] = lv ? wl_cqid[w] - c_lo : -1;
    x[k] = lv ? 0.5f : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int k = tid; k < n; k += nt) {
    as[k] = __fmul_rn(as[k], 0.05f);
    const float* rw = rv + static_cast<long long>(k) * F;
    float mx = rw[0];
    for (int f = 1; f < F; ++f) mx = fmaxf(mx, rw[f]);
    mx = fmaxf(mx, 1.0f);
    float* nw = rn + static_cast<long long>(k) * F;
    for (int f = 0; f < F; ++f) nw[f] = __fdiv_rn(rw[f], mx);
  }
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    float* load = load2 + (it & 1) * cf;
    // per-CQ load, each CQ's rows in ascending row order
    for (int e = tid; e < nc * F; e += nt) {
      const int i = e / F, f = e - i * F;
      const int a = row_off[c_lo + i] - k_lo;
      const int z = row_off[c_lo + i + 1] - k_lo;
      float acc = 0.0f;
      // unrolled so the loads run ahead of the chain of adds, which
      // stays in row order
#pragma unroll 8
      for (int k = a; k < z; ++k)
        acc = __fadd_rn(acc, __fmul_rn(rv[static_cast<long long>(k) * F + f],
                                       x[k]));
      load[e] = acc;
    }
    cluster.sync();
    // u: every CQ's load at its node, read from its block (the CQs'
    // nodes are distinct, checked by the host)
    for (int e = tid; e < N1 * F; e += nt) {
      const int nd = e / F, f = e - nd * F;
      const int c = node_cq[nd];
      float v = 0.0f;
      if (c >= 0) {
        int j = 0;
        while (c >= s_part[j + 1]) ++j;
        const float* src = cluster.map_shared_rank(load, j);
        v = __fadd_rn(0.0f, src[(c - s_part[j]) * F + f]);
      }
      u[e] = v;
    }
    __syncthreads();
    // full-charge accumulation, one level a step, from the old values
    for (int d = D - 1; d > 0; --d) {
      for (int e = tid; e < N1 * F; e += nt) {
        const int nd = e / F, f = e - nd * F;
        float acc = u[e];
#pragma unroll 8
        for (int k = kid_off[nd]; k < kid_off[nd + 1]; ++k) {
          const int ch = kids[k];
          if (depth[ch] == d) acc = __fadd_rn(acc, u[ch * F + f]);
        }
        u_next[e] = acc;
      }
      __syncthreads();
      float* t = u;
      u = u_next;
      u_next = t;
    }
    // price of the block's CQs: over summed along each CQ's path
    for (int e = tid; e < nc * F; e += nt) {
      const int i = e / F, f = e - i * F;
      const int* path = path_cq + static_cast<long long>(c_lo + i) * D;
      float pr = 0.0f;
      for (int k = 0; k < D; ++k) {
        const int o = path[k] * F + f;
        const float over =
            clamp01(__fdiv_rn(__fsub_rn(u[o], slack[o]), scale[o]));
        pr = k == 0 ? over : __fadd_rn(pr, over);
      }
      price[e] = pr;
    }
    __syncthreads();
    const float rho =
        __fadd_rn(__fmul_rn(static_cast<float>(it), p.rho_c), 1.0f);
    for (int k = tid; k < n; k += nt) {
      const int m = cq_of[k];
      if (m < 0) continue;  // not live: x stays 0
      const float pull =
          pull_sum(rn + static_cast<long long>(k) * F, price + m * F, F,
                   p.lanes, p.lane_end);
      const float g = __fsub_rn(as[k], __fmul_rn(rho, pull));
      x[k] = clamp01(__fadd_rn(x[k], __fmul_rn(g, 0.5f)));
    }
    __syncthreads();
  }
  // no block may leave while another still reads its loads
  cluster.sync();
  for (int k = tid; k < n; k += nt) x_out[rows[k_lo + k]] = x[k];
  if (rank == 0)
    for (int k = row_off[C] + tid; k < p.W1; k += nt) x_out[rows[k]] = 0.0f;
}

// ---- the mesh-sharded LP: two entries a shard and iteration -----------
//
// The JAX package's shard_map of lp_loop (kueue_oss_tpu/solver/sharded.py
// make_sharded_relax_lp, lp_step_body's psum at relax.py:124-125) splits
// every iteration at its one collective. relax_shard_load_kernel sums one
// shard's [C, F] load over its own rows (one thread per (CQ, f), the
// shard's rows of each CQ in ascending row order, from a host-built CSR
// list); the host adds the shards' loads in shard order
// (meshutil.psum); relax_shard_step_kernel then runs the rest of the
// iteration for one shard: the tree's full charge from the summed load,
// the price, and the shard's x update, every operation rounded as in
// relax_lp_kernel. One block does the whole step (u, u_next and the price
// in a global scratch the host gives it): a simple kernel, correct first.

__global__ void relax_shard_load_kernel(int F, int C, const float* r,
                                        const float* x, const int* rows,
                                        const int* row_off, float* load) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * F) return;
  const int c = e / F, f = e - c * F;
  float acc = 0.0f;
  for (int k = row_off[c]; k < row_off[c + 1]; ++k) {
    const int w = rows[k];
    acc = __fadd_rn(acc, __fmul_rn(r[static_cast<long long>(w) * F + f],
                                   x[w]));
  }
  load[e] = acc;
}

// pull_sum with r / max(r, 1) computed on the fly from one row of r
__device__ __forceinline__ float pull_sum_row(const float* rw, float mx,
                                              const float* pr, int F,
                                              int lanes, int lane_end) {
  if (lanes == 0) {
    float acc = 0.0f;
    for (int lo = -lane_end; lo < F; lo += kWindow) {
      float w = 0.0f;
      const int z = min(lo + kWindow, F);
      for (int f = max(lo, 0); f < z; ++f)
        w = __fadd_rn(w, __fmul_rn(__fdiv_rn(rw[f], mx), pr[f]));
      acc = __fadd_rn(acc, w);
    }
    return acc;
  }
  float lane[kMaxLanes];
#pragma unroll
  for (int j = 0; j < kMaxLanes; ++j) {
    lane[j] = j == 0 ? 0.0f : -0.0f;
    if (j < lanes)
      for (int f = j; f < lane_end; f += lanes)
        lane[j] = __fadd_rn(lane[j], __fmul_rn(__fdiv_rn(rw[f], mx), pr[f]));
  }
#pragma unroll
  for (int h = kMaxLanes / 2; h >= 1; h >>= 1) {
    if (h < lanes) {
#pragma unroll
      for (int i = 0; i < h; ++i) lane[i] = __fadd_rn(lane[i], lane[i + h]);
    }
  }
  float acc = lane[0];
  for (int f = lane_end; f < F; ++f)
    acc = __fadd_rn(acc, __fmul_rn(__fdiv_rn(rw[f], mx), pr[f]));
  return acc;
}

struct StepParams {
  int B, F, C, N1, D;
  float rho;
  int lanes, lane_end;
  const float* r;
  const float* s;
  const unsigned char* live;
  const int* wl_cqid;
  const int* path_cq;
  const int* depth;
  const float* slack;
  const float* scale;
  const int* kids;
  const int* kid_off;
  const int* node_cq;
  const float* load;
  float* scratch;
  float* x;
};

__global__ void __launch_bounds__(kMaxThreads, 1)
    relax_shard_step_kernel(const StepParams p) {
  const int F = p.F, C = p.C, N1 = p.N1, D = p.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* u = p.scratch;
  float* u_next = u + static_cast<long long>(N1) * F;
  float* price = u_next + static_cast<long long>(N1) * F;
  for (int e = tid; e < N1 * F; e += nt) {
    const int nd = e / F, f = e - nd * F;
    const int c = p.node_cq[nd];
    u[e] = c >= 0 ? __fadd_rn(0.0f, p.load[c * F + f]) : 0.0f;
  }
  __syncthreads();
  for (int d = D - 1; d > 0; --d) {
    for (int e = tid; e < N1 * F; e += nt) {
      const int nd = e / F, f = e - nd * F;
      float acc = u[e];
      for (int k = p.kid_off[nd]; k < p.kid_off[nd + 1]; ++k) {
        const int ch = p.kids[k];
        if (p.depth[ch] == d) acc = __fadd_rn(acc, u[ch * F + f]);
      }
      u_next[e] = acc;
    }
    __syncthreads();
    float* t = u;
    u = u_next;
    u_next = t;
  }
  for (int e = tid; e < C * F; e += nt) {
    const int c = e / F, f = e - c * F;
    const int* path = p.path_cq + static_cast<long long>(c) * D;
    float pr = 0.0f;
    for (int k = 0; k < D; ++k) {
      const int o = path[k] * F + f;
      const float over =
          clamp01(__fdiv_rn(__fsub_rn(u[o], p.slack[o]), p.scale[o]));
      pr = k == 0 ? over : __fadd_rn(pr, over);
    }
    price[e] = pr;
  }
  __syncthreads();
  for (int w = tid; w < p.B; w += nt) {
    if (!p.live[w]) {
      p.x[w] = 0.0f;
      continue;
    }
    const float* rw = p.r + static_cast<long long>(w) * F;
    float mx = rw[0];
    for (int f = 1; f < F; ++f) mx = fmaxf(mx, rw[f]);
    mx = fmaxf(mx, 1.0f);
    const int c = min(max(p.wl_cqid[w], 0), C - 1);
    const float pull =
        pull_sum_row(rw, mx, price + c * F, F, p.lanes, p.lane_end);
    const float g =
        __fsub_rn(__fmul_rn(p.s[w], 0.05f), __fmul_rn(p.rho, pull));
    p.x[w] = clamp01(__fadd_rn(p.x[w], __fmul_rn(g, 0.5f)));
  }
}

}  // namespace

// Plain C entry bound with ctypes: S clusters of K blocks of `threads`
// threads, one cluster per scenario (the host sizes the blocks to the
// widest step, so a small LP's barriers wait on few warps). `smem_bytes`
// is the dynamic shared memory a block takes (the host sizes it from the
// layout), `scratch` a device buffer of
// S * K * scratch_words floats when r_global or x_global. Launches on
// `stream`, allocates nothing, does not synchronise; returns the first
// CUDA error of the set-up or the launch, so a refused launch is reported
// to the caller.
extern "C" int kueue_relax_lp(
    int S, int K, int threads, int W1, int F, int C, int N1, int D, int iters,
    float rho_c, int lanes, int lane_end, int max_rows, int max_cqs,
    int r_global, int x_global, long long scratch_words, int smem_bytes,
    const float* r, const float* s, const unsigned char* live,
    const int* wl_cqid, const int* path_cq, const int* depth,
    const float* slack, const float* scale, const int* rows,
    const int* row_off, const int* kids, const int* kid_off,
    const int* node_cq, const int* part, float* scratch, float* x,
    void* stream) {
  if (S <= 0 || W1 <= 0) return 0;
  if (K < 1 || K > kMaxCluster || (K & (K - 1)) != 0 || C < K || F < 1 ||
      D < 1 || lanes < 0 || lanes > kMaxLanes || lane_end > F ||
      (lanes == 0 && (F <= kWindow || F > kMaxColumns ||
                      lane_end >= kWindow)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      relax_lp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{K, W1, F, C, N1, D, iters, rho_c, lanes, lane_end,
                 max_rows, max_cqs, r_global, x_global, scratch_words,
                 r, s, live, wl_cqid, path_cq, depth, slack, scale, rows,
                 row_off, kids, kid_off, node_cq, part, scratch, x};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S) * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, relax_lp_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One shard's [C, F] load of the mesh-sharded LP (B rows, CSR `rows` /
// `row_off` of the shard's rows by CQ). Launches on `stream`; returns the
// first CUDA error.
extern "C" int kueue_relax_shard_load(int B, int F, int C, const float* r,
                                      const float* x, const int* rows,
                                      const int* row_off, float* load,
                                      void* stream) {
  if (B < 0 || F < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = C * F, threads = 256;
  relax_shard_load_kernel<<<(n + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      F, C, r, x, rows, row_off, load);
  return static_cast<int>(cudaGetLastError());
}

// The rest of one iteration for one shard of B rows: `load` is the [C, F]
// sum of every shard's load, `scratch` holds 2 * N1 * F + C * F floats,
// `x` is updated in place. One block of `threads` threads.
extern "C" int kueue_relax_shard_step(
    int B, int F, int C, int N1, int D, float rho, int lanes, int lane_end,
    int threads, const float* r, const float* s, const unsigned char* live,
    const int* wl_cqid, const int* path_cq, const int* depth,
    const float* slack, const float* scale, const int* kids,
    const int* kid_off, const int* node_cq, const float* load,
    float* scratch, float* x, void* stream) {
  if (B < 0 || F < 1 || C < 1 || D < 1 || lanes < 0 || lanes > kMaxLanes ||
      lane_end > F ||
      (lanes == 0 && (F <= kWindow || F > kMaxColumns ||
                      lane_end >= kWindow)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepParams p{B, F, C, N1, D, rho, lanes, lane_end, r, s, live,
                     wl_cqid, path_cq, depth, slack, scale, kids, kid_off,
                     node_cq, load, scratch, x};
  relax_shard_step_kernel<<<1, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
