// Relaxed admission LP for Hopper (sm_90a): the projected-gradient loop
// of the relaxed solver arm, every iteration of every scenario in one
// launch.
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
//                with c(w) clamped to [0, C-1] (JAX clamps the padding id),
//                summed in XLA:CPU's lane order (relax.lane_width: V lanes,
//                lane j adds f = j, j + V, ...; then the lanes in order)
//   rho        = i * rho_c + 1, rho_c = 3 * (1 / iters) in float32 (XLA's
//                folding of RHO0 * (1 + RHO_GROWTH * i / iters))
//   x[w]       = live ? clamp(x + 0.5 * (0.05 * s - rho * pull), 0, 1) : 0
// Every operation is an explicitly rounded float32 intrinsic, so nvcc
// contracts nothing into a fused multiply-add (tier-1 compiles the JAX
// program for AVX, which has none), and x is bit for bit relax.lp_loop's
// on the CPU.
//
// Bound (each input read once, x written once, as chip_smoke.py counts
// it): at drain_large_scale's LP (W+1 = 65,537, C = 1,000) that is about
// 1.1 MB, a third of a microsecond of HBM time; the 32 iterations re-read
// r and x from L2, not HBM. The kernel is latency bound instead: one
// block per scenario walks the iterations in order with a barrier
// between the steps, each CQ's rows are summed by one thread in row
// order (~65 rows a CQ there), and each level of the tree is one step.
// That is slow but exact; a faster design (a warp per CQ with a fixed
// shuffle order, the tables in shared memory) is later work.
//
// Layout (one block per scenario b, every array with a leading S axis):
// rows[b] lists the rows with 0 <= wl_cqid < C sorted stably by CQ, with
// CSR offsets row_off[b, C+1]; kids[b] lists the nodes whose parent is in
// [0, N+1) sorted stably by parent, with offsets kid_off[b, N+2]. The host
// builds both once per problem. scratch holds (2 C + 3 (N+1)) * F floats
// per scenario.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
relax_lp_kernel(int W1, int F, int C, int N1, int D, int iters,
                float rho_c, const float* __restrict__ r,
                const float* __restrict__ s,
                const unsigned char* __restrict__ live,
                const int* __restrict__ wl_cqid,
                const int* __restrict__ cq_node,
                const int* __restrict__ path_cq,
                const int* __restrict__ depth,
                const float* __restrict__ slack,
                const float* __restrict__ scale,
                const int* __restrict__ rows,
                const int* __restrict__ row_off,
                const int* __restrict__ kids,
                const int* __restrict__ kid_off,
                float* __restrict__ scratch, float* __restrict__ x) {
  const long long b = blockIdx.x;
  r += b * W1 * F;
  s += b * W1;
  live += b * W1;
  wl_cqid += b * W1;
  cq_node += b * C;
  path_cq += b * C * D;
  depth += b * N1;
  slack += b * N1 * F;
  scale += b * N1 * F;
  rows += b * W1;
  row_off += b * (C + 1);
  kids += b * N1;
  kid_off += b * (N1 + 1);
  x += b * W1;
  float* load = scratch + b * (2LL * C + 3LL * N1) * F;
  float* u = load + C * F;
  float* u_next = u + N1 * F;
  float* over = u_next + N1 * F;
  float* price = over + N1 * F;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int lanes = 1;  // relax.lane_width(F)
  while (lanes * 2 <= min(F, 8)) lanes *= 2;

  for (int w = tid; w < W1; w += nt) x[w] = live[w] ? 0.5f : 0.0f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // per-CQ load, each CQ's rows in ascending row order
    for (int c = tid; c < C; c += nt) {
      const int k0 = row_off[c], k1 = row_off[c + 1];
      for (int f = 0; f < F; ++f) {
        float acc = 0.0f;
        for (int k = k0; k < k1; ++k) {
          const int w = rows[k];
          acc = __fadd_rn(acc, __fmul_rn(r[(long long)w * F + f], x[w]));
        }
        load[c * F + f] = acc;
      }
    }
    for (int e = tid; e < N1 * F; e += nt) u[e] = 0.0f;
    __syncthreads();
    // the CQs' nodes are distinct (checked by the host)
    for (int e = tid; e < C * F; e += nt) {
      const int n = cq_node[e / F];
      u[n * F + e % F] = __fadd_rn(u[n * F + e % F], load[e]);
    }
    __syncthreads();
    // full-charge accumulation, one level a step, from the old values
    for (int d = D - 1; d > 0; --d) {
      for (int n = tid; n < N1; n += nt) {
        const int k0 = kid_off[n], k1 = kid_off[n + 1];
        for (int f = 0; f < F; ++f) {
          float acc = u[n * F + f];
          for (int k = k0; k < k1; ++k) {
            const int ch = kids[k];
            if (depth[ch] == d) acc = __fadd_rn(acc, u[ch * F + f]);
          }
          u_next[n * F + f] = acc;
        }
      }
      __syncthreads();
      float* t = u;
      u = u_next;
      u_next = t;
    }
    for (int e = tid; e < N1 * F; e += nt)
      over[e] = clamp01(__fdiv_rn(__fsub_rn(u[e], slack[e]), scale[e]));
    __syncthreads();
    for (int e = tid; e < C * F; e += nt) {
      const int c = e / F, f = e % F;
      float p = over[path_cq[c * D] * F + f];
      for (int k = 1; k < D; ++k)
        p = __fadd_rn(p, over[path_cq[c * D + k] * F + f]);
      price[e] = p;
    }
    __syncthreads();
    const float rho =
        __fadd_rn(__fmul_rn(static_cast<float>(it), rho_c), 1.0f);
    for (int w = tid; w < W1; w += nt) {
      if (!live[w]) {
        x[w] = 0.0f;
        continue;
      }
      const int c = min(max(wl_cqid[w], 0), C - 1);
      const float* rw = r + (long long)w * F;
      float mx = rw[0];
      for (int f = 1; f < F; ++f) mx = fmaxf(mx, rw[f]);
      mx = fmaxf(mx, 1.0f);
      float pull = 0.0f;
      for (int j = 0; j < lanes; ++j) {
        float lane = __fmul_rn(__fdiv_rn(rw[j], mx), price[c * F + j]);
        for (int f = j + lanes; f < F; f += lanes)
          lane = __fadd_rn(lane, __fmul_rn(__fdiv_rn(rw[f], mx),
                                           price[c * F + f]));
        pull = j == 0 ? lane : __fadd_rn(pull, lane);
      }
      const float g = __fsub_rn(__fmul_rn(s[w], 0.05f), __fmul_rn(rho, pull));
      x[w] = clamp01(__fadd_rn(x[w], __fmul_rn(g, 0.5f)));
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry bound with ctypes: S blocks, one per scenario. Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int kueue_relax_lp(int S, int W1, int F, int C, int N1, int D,
                              int iters, float rho_c, const float* r,
                              const float* s, const unsigned char* live,
                              const int* wl_cqid, const int* cq_node,
                              const int* path_cq, const int* depth,
                              const float* slack, const float* scale,
                              const int* rows, const int* row_off,
                              const int* kids, const int* kid_off,
                              float* scratch, float* x, void* stream) {
  if (S <= 0 || W1 <= 0) return 0;
  relax_lp_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      W1, F, C, N1, D, iters, rho_c, r, s, live, wl_cqid, cq_node, path_cq,
      depth, slack, scale, rows, row_off, kids, kid_off, scratch, x);
  return static_cast<int>(cudaGetLastError());
}
