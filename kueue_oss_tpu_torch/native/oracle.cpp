// Native scalar quota oracle.
//
// A copy of kueue_oss_tpu/native/oracle.cpp: the C++ form of the
// QuotaNode fits/add_usage walk (kueue_oss_tpu_torch/core/quota.py,
// reference pkg/cache/scheduler/resource_node.go:104-158). It verifies a
// batch of admissions in order against the hierarchical quota algebra
// and charges the ones that fit. The walk is sequential (each
// admission's feasibility depends on the usage charged by the previous
// ones), so it is host code beside the device drain, not a kernel: the
// drain's plan is re-checked here before it is committed. Built with g++
// at first use and loaded through ctypes (see __init__.py); the Python
// walk there is the reference behaviour and the fallback.

#include <cstdint>

namespace {

struct View {
    int n_nodes;
    int F;
    const int32_t* parent;          // [n_nodes], -1 = root
    const int64_t* local_quota;     // [n_nodes * F]
    const int64_t* subtree;         // [n_nodes * F]
    const uint8_t* has_borrow;      // [n_nodes * F]
    const int64_t* borrow_limit;    // [n_nodes * F]
    int64_t* usage;                 // [n_nodes * F] (mutated)

    int64_t lq(int n, int f) const { return local_quota[n * F + f]; }
    int64_t st(int n, int f) const { return subtree[n * F + f]; }
    int64_t us(int n, int f) const { return usage[n * F + f]; }
};

int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }
int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// quota.py QuotaNode.available (resource_node.go:104-118)
int64_t available(const View& v, int node, int f) {
    if (v.parent[node] < 0) {
        return v.st(node, f) - v.us(node, f);
    }
    int64_t parent_avail = available(v, v.parent[node], f);
    if (v.has_borrow[node * v.F + f]) {
        int64_t stored_in_parent = v.st(node, f) - v.lq(node, f);
        int64_t used_in_parent = max64(0, v.us(node, f) - v.lq(node, f));
        int64_t with_max = stored_in_parent - used_in_parent
                           + v.borrow_limit[node * v.F + f];
        parent_avail = min64(with_max, parent_avail);
    }
    int64_t local_avail = max64(0, v.lq(node, f) - v.us(node, f));
    return local_avail + parent_avail;
}

// quota.py QuotaNode.add_usage (resource_node.go:137-146)
void add_usage(View& v, int node, int f, int64_t val) {
    while (true) {
        int64_t local_avail = max64(0, v.lq(node, f) - v.us(node, f));
        v.usage[node * v.F + f] += val;
        int p = v.parent[node];
        if (p < 0 || val <= local_avail) return;
        val -= local_avail;
        node = p;
    }
}

}  // namespace

extern "C" {

// Verify-and-charge a batch of admissions in order.
//
// Admission i requests, at node adm_node[i], quantities adm_qty[j] of
// flavor-resource adm_fr[j] for j in [adm_ptr[i], adm_ptr[i+1]).
// ok_out[i] = 1 and usage is charged iff every quantity fits the
// available() capacity at that point; otherwise 0 and no charge.
// Returns the number of admissions that fit.
int64_t verify_plan(
    int32_t n_nodes, int32_t F,
    const int32_t* parent,
    const int64_t* local_quota,
    const int64_t* subtree,
    const uint8_t* has_borrow,
    const int64_t* borrow_limit,
    int64_t* usage,
    int64_t n_adm,
    const int32_t* adm_node,
    const int64_t* adm_ptr,
    const int32_t* adm_fr,
    const int64_t* adm_qty,
    uint8_t* ok_out) {
    View v{n_nodes, F, parent, local_quota, subtree,
           has_borrow, borrow_limit, usage};
    int64_t fit_count = 0;
    for (int64_t i = 0; i < n_adm; ++i) {
        int node = adm_node[i];
        bool ok = true;
        for (int64_t j = adm_ptr[i]; j < adm_ptr[i + 1]; ++j) {
            if (adm_qty[j] > available(v, node, adm_fr[j])) {
                ok = false;
                break;
            }
        }
        ok_out[i] = ok ? 1 : 0;
        if (!ok) continue;
        for (int64_t j = adm_ptr[i]; j < adm_ptr[i + 1]; ++j) {
            add_usage(v, node, adm_fr[j], adm_qty[j]);
        }
        ++fit_count;
    }
    return fit_count;
}

}  // extern "C"
