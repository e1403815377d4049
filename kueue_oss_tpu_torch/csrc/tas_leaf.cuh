// TAS phase-1 leaf pass for one leaf row, shared by the standalone
// leaf_states kernel (leaf_states.cu) and the sequential placer
// (tas_place.cu), so the arithmetic exists once.
//
// For a leaf with capacities row[0..R):
//   st  = min(BIG, min over r with per_pod[r] > 0 of floor(row[r] / per_pod[r]))
//   ls  = has_leader && row[r] >= leader[r] for every r with leader[r] > 0
//   swl = the same min as st over row[r] - (ls ? leader[r] : 0)
// with BIG = 1 << 30 (also the value when no request is nonzero).
// Division floors (JAX's //), also for negative numerators; the leader
// subtraction wraps in two's complement like the int32 JAX program.

#pragma once

namespace kueue_tas {

constexpr int kBig = 1 << 30;

__device__ __forceinline__ int floor_div(int a, int b) {
  // b >= 1 at every call, so a / b cannot overflow
  const int q = a / b;
  const int r = a - q * b;
  return r < 0 ? q - 1 : q;
}

// int32 arithmetic that wraps like the JAX and PyTorch programs (signed
// overflow is undefined in C++, unsigned arithmetic is not)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_neg(int a) {
  return static_cast<int>(0u - static_cast<unsigned>(a));
}

struct LeafState {
  int st, swl, ls;
};

__device__ __forceinline__ LeafState leaf_row(const int* row,
                                              const int* per_pod,
                                              const int* leader,
                                              bool has_leader, int R) {
  bool fits = has_leader;
  int m_st = kBig;
  for (int r = 0; r < R; ++r) {
    const int c = row[r];
    const int req = per_pod[r];
    const int lead = leader[r];
    if (lead > 0 && c < lead) fits = false;
    if (req > 0) m_st = min(m_st, floor_div(c, req));
  }
  int m_swl = kBig;
  for (int r = 0; r < R; ++r) {
    const int req = per_pod[r];
    if (req <= 0) continue;
    const int rem = fits ? wrap_sub(row[r], leader[r]) : row[r];
    m_swl = min(m_swl, floor_div(rem, req));
  }
  return {m_st, m_swl, fits ? 1 : 0};
}

}  // namespace kueue_tas
