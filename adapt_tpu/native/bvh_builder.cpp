// Binned-SAH BVH builder with a stackless skip-offset linearization.
//
// Native counterpart of the reference's pybind11/Eigen accelerator
// (tracer/bvh/bvh.cpp) but an independent design shaped for wavefront
// traversal: the output is a flat array of nodes in DFS order where
// each node carries a `skip` index (next node when its AABB test fails).
// A vectorized traversal then needs only a per-lane cursor: hit -> +1,
// miss -> skip; leaves reference a contiguous range of reordered prims.
//
// C ABI for ctypes. Input is per-primitive AABBs (+centroids derived here),
// so triangles and spheres are handled uniformly by the host wrapper.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kLeafMax = 4;
constexpr float kTraverseCost = 0.6f;

struct Aabb {
    float lo[3], hi[3];
    void reset() {
        for (int a = 0; a < 3; ++a) {
            lo[a] = 3.4e38f;
            hi[a] = -3.4e38f;
        }
    }
    void grow(const Aabb &o) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], o.lo[a]);
            hi[a] = std::max(hi[a], o.hi[a]);
        }
    }
    float area() const {
        float d0 = std::max(hi[0] - lo[0], 0.f);
        float d1 = std::max(hi[1] - lo[1], 0.f);
        float d2 = std::max(hi[2] - lo[2], 0.f);
        return 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
    }
};

struct BuildNode {
    Aabb box;
    int left = -1, right = -1;  // children (internal)
    int base = 0, count = 0;    // prim range (leaf)
};

struct Builder {
    const float *aabbs;  // (P, 6) lo/hi
    std::vector<float> centroid;
    std::vector<int> order;
    std::vector<BuildNode> nodes;

    Aabb prim_box(int p) const {
        Aabb b;
        std::memcpy(b.lo, aabbs + p * 6, 12);
        std::memcpy(b.hi, aabbs + p * 6 + 3, 12);
        return b;
    }

    // One node: bbox/leaf decision/partition. Returns the node id and
    // sets *split_mid >= 0 when children [begin,mid) [mid,end) follow.
    int make_node(int begin, int end, int *split_mid) {
        BuildNode node;
        node.box.reset();
        Aabb cbox;
        cbox.reset();
        for (int i = begin; i < end; ++i) {
            Aabb pb = prim_box(order[i]);
            node.box.grow(pb);
            Aabb cb;
            for (int a = 0; a < 3; ++a)
                cb.lo[a] = cb.hi[a] = centroid[order[i] * 3 + a];
            cbox.grow(cb);
        }
        int n = end - begin;
        int node_id = (int)nodes.size();
        nodes.push_back(node);
        *split_mid = -1;
        if (n <= kLeafMax) {
            nodes[node_id].base = begin;
            nodes[node_id].count = n;
            return node_id;
        }
        // binned SAH over the largest centroid extent
        int axis = 0;
        float ext[3];
        for (int a = 0; a < 3; ++a) ext[a] = cbox.hi[a] - cbox.lo[a];
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        if (ext[axis] < 1e-12f) {  // degenerate: median split
            *split_mid = begin + n / 2;
            return node_id;
        }
        float inv_ext = kBins / ext[axis];
        Aabb bin_box[kBins];
        int bin_cnt[kBins] = {0};
        for (auto &b : bin_box) b.reset();
        auto bin_of = [&](int p) {
            int b = (int)((centroid[p * 3 + axis] - cbox.lo[axis]) * inv_ext);
            return std::min(std::max(b, 0), kBins - 1);
        };
        for (int i = begin; i < end; ++i) {
            int b = bin_of(order[i]);
            bin_box[b].grow(prim_box(order[i]));
            bin_cnt[b]++;
        }
        // prefix/suffix sweeps
        float right_area[kBins];
        Aabb acc;
        acc.reset();
        int right_n[kBins];
        int rn = 0;
        for (int b = kBins - 1; b > 0; --b) {
            acc.grow(bin_box[b]);
            rn += bin_cnt[b];
            right_area[b] = acc.area();
            right_n[b] = rn;
        }
        acc.reset();
        int ln = 0;
        float best_cost = 3.4e38f;
        int best_split = -1;
        float inv_root = 1.f / std::max(nodes[node_id].box.area(), 1e-12f);
        for (int b = 0; b < kBins - 1; ++b) {
            acc.grow(bin_box[b]);
            ln += bin_cnt[b];
            if (ln == 0 || right_n[b + 1] == 0) continue;
            float cost = kTraverseCost +
                         inv_root * (acc.area() * ln +
                                     right_area[b + 1] * right_n[b + 1]);
            if (cost < best_cost) {
                best_cost = cost;
                best_split = b;
            }
        }
        if (best_split < 0 || best_cost >= (float)n) {
            // SAH prefers a leaf, but leaves are HARD-capped at kLeafMax:
            // the flat traversal (ops/bvh.py LEAF_MAX) tests exactly that
            // many slots per leaf — an oversize leaf would silently skip
            // prims 4..7 (found by review: clumpy scenes produced 5-6
            // prim leaves through the old 2*kLeafMax allowance).
            best_split = kBins / 2 - 1;  // forced split
        }
        auto mid_it = std::partition(
            order.begin() + begin, order.begin() + end,
            [&](int p) { return bin_of(p) <= best_split; });
        int mid = (int)(mid_it - order.begin());
        if (mid == begin || mid == end) mid = begin + n / 2;
        *split_mid = mid;
        return node_id;
    }

    // Explicit work stack (recursion depth is O(P) on adversarial split
    // sequences — a native stack overflow is a SIGSEGV, not an error).
    // Pushing the right task first keeps DFS-preorder node ids, so
    // children ids always exceed the parent's (linearize relies on it).
    int build(int P) {
        struct Task { int begin, end, parent, which; };
        std::vector<Task> tasks{{0, P, -1, 0}};
        int root = -1;
        while (!tasks.empty()) {
            Task t = tasks.back();
            tasks.pop_back();
            int mid;
            int node_id = make_node(t.begin, t.end, &mid);
            if (t.parent < 0) root = node_id;
            else if (t.which == 0) nodes[t.parent].left = node_id;
            else nodes[t.parent].right = node_id;
            if (mid >= 0) {
                tasks.push_back({mid, t.end, node_id, 1});
                tasks.push_back({t.begin, mid, node_id, 0});
            }
        }
        return root;
    }

    // DFS linearization with skip offsets, iteratively: recursion depth
    // is O(tree depth) = O(P) on adversarial splits (stack overflow is a
    // SIGSEGV, not an error). Children are pushed after their parent in
    // build(), so a reverse pass computes subtree sizes without
    // recursion; skip = flat index + subtree size.
    void linearize(int root, std::vector<int> &out_order,
                   std::vector<int> &skip_of) {
        std::vector<int> size(nodes.size(), 1);
        for (int i = (int)nodes.size() - 1; i >= 0; --i)
            if (nodes[i].left >= 0)
                size[i] = 1 + size[nodes[i].left] + size[nodes[i].right];
        std::vector<int> stack{root};
        while (!stack.empty()) {
            int id = stack.back();
            stack.pop_back();
            int flat = (int)out_order.size();
            out_order.push_back(id);
            skip_of.push_back(flat + size[id]);
            if (nodes[id].left >= 0) {
                stack.push_back(nodes[id].right);  // left pops first
                stack.push_back(nodes[id].left);
            }
        }
    }
};

}  // namespace

extern "C" {

// aabbs: (P, 6) float32 per-prim lo/hi. Outputs (caller-allocated):
//   node_f: (max_nodes, 6) float32  lo/hi per flat node
//   node_i: (max_nodes, 3) int32    [prim_base, prim_count, skip]
//   prim_order: (P,) int32          traversal-order -> original prim id
// Returns number of flat nodes, or negative on error (-1 overflow).
int bvh_build(const float *aabbs, int64_t P, int32_t max_nodes,
              float *node_f, int32_t *node_i, int32_t *prim_order) {
    if (P <= 0) return 0;
    Builder b;
    b.aabbs = aabbs;
    b.centroid.resize(P * 3);
    for (int64_t p = 0; p < P; ++p)
        for (int a = 0; a < 3; ++a)
            b.centroid[p * 3 + a] =
                0.5f * (aabbs[p * 6 + a] + aabbs[p * 6 + 3 + a]);
    b.order.resize(P);
    std::iota(b.order.begin(), b.order.end(), 0);
    b.nodes.reserve(2 * P);
    int root = b.build((int)P);

    std::vector<int> flat_order, skip_of;
    flat_order.reserve(b.nodes.size());
    b.linearize(root, flat_order, skip_of);
    int M = (int)flat_order.size();
    if (M > max_nodes) return -1;

    for (int f = 0; f < M; ++f) {
        const BuildNode &nd = b.nodes[flat_order[f]];
        std::memcpy(node_f + f * 6, nd.box.lo, 12);
        std::memcpy(node_f + f * 6 + 3, nd.box.hi, 12);
        node_i[f * 3 + 0] = nd.base;
        node_i[f * 3 + 1] = nd.count;  // 0 for internal nodes
        node_i[f * 3 + 2] = skip_of[f];
    }
    std::memcpy(prim_order, b.order.data(), P * 4);
    return M;
}

}  // extern "C"
