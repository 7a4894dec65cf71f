// The BVH build for Hopper (sm_90a): ops/bvh.py's binned-SAH tree, built
// on the card from the triangle table that is already there.
//
// What it replaces: the host build of ops/bvh.py (_build_host: the table
// copied to the host, a numpy build level by level, the tree copied back),
// which every scene path of the port ran once a call or frame ahead of the
// culled B1 (csrc/mega_default.cu) and B4 (csrc/closest_hit.cu).  The JAX
// package has no tree: its culled megakernel (rlrpt_tpu/ops/megakernel.py
// :411-472) skips 256-triangle chunks whose boxes the jitted launcher
// computes on the device (chunk_aabbs, megakernel.py:164).  This kernel is
// the port's counterpart of that set-up, so the culled frame, like JAX's,
// never waits for the host.
//
// The tree is the numpy build's bit for bit, so every walk, image and
// count downstream is unchanged: per level, binned SAH over the nodes'
// centroid bounds (16 bins an axis, the cost n_l * area_l + n_r * area_r
// in float64 in numpy's order, the lowest (axis, cut) on ties), a split by
// index where every centroid of a node coincides, the stable left/right
// order, breadth-first node numbers, leaves of at most 4 triangles coded
// ~(first << 3 | count), and boxes grown by the scene's margin in float64
// and rounded outward to float32.  Every reduction is order-free, so the
// tree does not depend on how the blocks run: integer counts by atomics,
// minima and maxima by integer atomics on order-preserving images of the
// float64 bits, the stable partition by a prefix sum of the right sides,
// and the numbering by prefix sums over the level's children.
//
// What bounds it on this card: latency, not bytes or operations.  At 4,980
// triangles it reads the table (239 KB) and writes the tree (~0.6 MB):
// about 0.2 us at 3.35 TB/s, and a few million float64 operations; but its
// 16 levels run one after another, each a chain of dependent steps.
//
// What the design does about it: one cooperative launch walks every level
// with grid barriers (six a level) and never returns to the host; the
// only host read is the tree's size and depth after it (ops/bvh.py).  The
// grid is small (a block of 256 threads per 128 triangles, at most 256
// blocks: the triangle steps use half its threads, the node steps' warps
// twice as many), so a barrier is cheap; a node's SAH is one warp's
// shuffle scans over its 16 bins, and those scans give the children's
// boxes too, so no triangle adds to them by atomics; a warp merges its
// triangles' centroid atomics by node, where a run of up to 32 would
// queue on the same address.  At 4,980 triangles (16 levels) a level
// takes ~34 us: the bins' atomics about 40% of it, the six barriers and
// each step's dependent loads the rest (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;
using u64 = unsigned long long;

constexpr int kBins = 16;                 // ops/bvh.py BINS
constexpr int kCuts = kBins - 1;
constexpr int kNodeBins = 3 * kBins;      // (axis, bin) pairs of a node
constexpr int kLeafMax = 4;               // LEAF_MAX
constexpr int kEmpty = -1;                // EMPTY
constexpr double kMargin = 1.0 / 1024.0;  // MARGIN, 2^-10
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxGrid = kBlock;          // block totals: one block's scan
constexpr int kTrisPerBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
// key_of(+inf) and key_of(-inf): the empty minimum and maximum
constexpr u64 kKeyPlusInf = 0xfff0000000000000ull;
constexpr u64 kKeyMinusInf = 0x000fffffffffffffull;

// The build's scratch, carved from one byte buffer (layout).  K = n / 5
// + 1 bounds a level's inner nodes (each holds at least 5 triangles).
struct Work {
  double* geo;    // (n, 9): box lo xyz, box hi xyz, centroid xyz
  u64* ncm;       // (K, 6): a node's centroid min xyz, max xyz (keys)
  u64* bbox;      // (K, 48, 6): each (axis, bin)'s box lo, hi (keys)
  u64* cbox;      // (2K, 6): each child's box (keys)
  u64* margin;    // (1,): the bits of the largest |corner|
  int* cnt;       // (K, 48): each (axis, bin)'s triangles
  int* items;     // (n,): the level's triangles, node after node
  int* node;      // (n,): the node of each of them
  int* part;      // (n,): the triangles partitioned, left then right
  int* child;     // (n,): the child (2 node + side) of each of those
  int* binp;      // (n,): bins on the three axes (4 bits each), side bit 12
  int* scan;      // (n,): right sides before, within the block's chunk
  int* start;     // (2, K): the nodes' first position, two levels
  int* count;     // (2, K): the nodes' triangles, two levels
  int* split;     // (K,): axis * 16 + cut, or -1 for a split by index
  int* nright;    // (K,): triangles that go right
  int* cscan;     // (3, 2K): leaf triangles, inner children and inner
                  // triangles before each child, within the block's chunk
  int* cbase;     // (2K,): a leaf's first position in order, an inner
                  // child's first position in the next level
  int* cnext;     // (2K,): an inner child's node in the next level, or -1
  int* btot;      // (kMaxGrid,): the blocks' right sides
  int* ctot;      // (3, kMaxGrid): the blocks' children sums
  int k_cap;      // K
};

Work layout(int n, char* base, size_t& bytes) {
  const size_t nn = static_cast<size_t>(n), k = nn / 5 + 1, c = 2 * k;
  size_t off = 0;
  auto take = [&](size_t count, size_t size) -> void* {
    void* p = base ? static_cast<void*>(base + off) : nullptr;
    off += (count * size + 255) / 256 * 256;
    return p;
  };
  Work w;
  w.geo = static_cast<double*>(take(9 * nn, 8));
  w.ncm = static_cast<u64*>(take(6 * k, 8));
  w.bbox = static_cast<u64*>(take(6 * kNodeBins * k, 8));
  w.cbox = static_cast<u64*>(take(6 * c, 8));
  w.margin = static_cast<u64*>(take(1, 8));
  w.cnt = static_cast<int*>(take(kNodeBins * k, 4));
  w.items = static_cast<int*>(take(nn, 4));
  w.node = static_cast<int*>(take(nn, 4));
  w.part = static_cast<int*>(take(nn, 4));
  w.child = static_cast<int*>(take(nn, 4));
  w.binp = static_cast<int*>(take(nn, 4));
  w.scan = static_cast<int*>(take(nn, 4));
  w.start = static_cast<int*>(take(2 * k, 4));
  w.count = static_cast<int*>(take(2 * k, 4));
  w.split = static_cast<int*>(take(k, 4));
  w.nright = static_cast<int*>(take(k, 4));
  w.cscan = static_cast<int*>(take(3 * c, 4));
  w.cbase = static_cast<int*>(take(c, 4));
  w.cnext = static_cast<int*>(take(c, 4));
  w.btot = static_cast<int*>(take(kMaxGrid, 4));
  w.ctot = static_cast<int*>(take(3 * kMaxGrid, 4));
  w.k_cap = static_cast<int>(k);
  bytes = off;
  return w;
}

// Order-preserving images of float64 bits: for a, b not NaN, a < b iff
// key_of(a) < key_of(b) (and -0 < +0, which the build never meets).
__device__ __forceinline__ u64 key_of(double x) {
  const u64 b = static_cast<u64>(__double_as_longlong(x));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double of_key(u64 k) {
  return __longlong_as_double(static_cast<long long>(
      (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}

// numpy's corners + 0.0: -0 becomes +0, so no minimum or maximum depends
// on which zero it meets first.
__device__ __forceinline__ double pos_zero(double x) {
  return x == 0.0 ? 0.0 : x;
}

// ops/bvh.py:_round_out of one bound.
__device__ __forceinline__ float round_down(double d) {
  const float f = __double2float_rn(d);
  return static_cast<double>(f) > d ? nextafterf(f, -INFINITY) : f;
}

__device__ __forceinline__ float round_up(double d) {
  const float f = __double2float_rn(d);
  return static_cast<double>(f) < d ? nextafterf(f, INFINITY) : f;
}

// The surface-area measure of ops/bvh.py:_split's area, in its order.
__device__ __forceinline__ double area(const double* lo, const double* hi) {
  const double e0 = fmax(hi[0] - lo[0], 0.0);
  const double e1 = fmax(hi[1] - lo[1], 0.0);
  const double e2 = fmax(hi[2] - lo[2], 0.0);
  return e0 * e1 + e1 * e2 + e2 * e0;
}

// The three corners of table row i in float64 (v0, v0 + e1, v0 + e2:
// exact sums of the f32 values), -0 made +0.
__device__ __forceinline__ void corners(const float* __restrict__ tris,
                                        int i, double c[3][3]) {
  const float* r = tris + 12 * static_cast<size_t>(i);
  for (int a = 0; a < 3; ++a) {
    const double v0 = r[a];
    c[0][a] = pos_zero(v0);
    c[1][a] = pos_zero(v0 + static_cast<double>(r[4 + a]));
    c[2][a] = pos_zero(v0 + static_cast<double>(r[8 + a]));
  }
}

// Exclusive scan of v over the block (every thread calls it); total gets
// the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < kWarps ? s_warp[lane] : 0;
    int y = mine;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane < kWarps) s_warp[lane] = y - mine;
    if (lane == kWarps - 1) s_warp[kWarps] = y;
  }
  __syncthreads();
  const int out = s_warp[warp] + x - v;
  total = s_warp[kWarps];
  __syncthreads();   // s_warp is reused by the next call
  return out;
}

// s_pre[0..G) = the exclusive prefix of the blocks' totals tot[0..G),
// s_pre[G] = their sum.
__device__ __forceinline__ void grid_prefix(const int* tot, int* s_pre,
                                            int* s_warp) {
  const int g = gridDim.x;
  const int v = threadIdx.x < g ? __ldcg(tot + threadIdx.x) : 0;
  int total;
  const int ex = block_scan(v, s_warp, total);
  if (threadIdx.x < g) s_pre[threadIdx.x] = ex;
  if (threadIdx.x == 0) s_pre[g] = total;
  __syncthreads();
}

// Adds the centroids of a warp's triangles to their nodes' bounds: lanes
// with one node id sit side by side (positions run node after node), so
// each run is reduced by shuffles and its first lane does the six
// atomics, where a lane each would queue up to 32 on the same address.
// node < 0: the lane has none.  Every lane of the warp calls it.
__device__ __forceinline__ void add_centroid(const Work& w, int node,
                                             const double* cen, int lane) {
  const unsigned same = __match_any_sync(kFull, node);
  const int last = 31 - __clz(same);
  u64 lo[3], hi[3];
  for (int a = 0; a < 3; ++a) lo[a] = hi[a] = node >= 0 ? key_of(cen[a]) : 0;
  for (int o = 1; o < 32; o <<= 1)
    for (int a = 0; a < 3; ++a) {
      const u64 l = __shfl_down_sync(kFull, lo[a], o);
      const u64 h = __shfl_down_sync(kFull, hi[a], o);
      if (lane + o <= last) {
        lo[a] = l < lo[a] ? l : lo[a];
        hi[a] = h > hi[a] ? h : hi[a];
      }
    }
  if (node >= 0 && lane == __ffs(same) - 1)
    for (int a = 0; a < 3; ++a) {
      atomicMin(w.ncm + 6 * static_cast<size_t>(node) + a, lo[a]);
      atomicMax(w.ncm + 6 * static_cast<size_t>(node) + 3 + a, hi[a]);
    }
}

// grid_prefix of the three children sums at once (their loads together).
__device__ __forceinline__ void grid_prefix3(const int* tot,
                                             int (*s_pre)[kMaxGrid + 1],
                                             int* s_warp) {
  const int g = gridDim.x;
  int v[3];
  for (int q = 0; q < 3; ++q)
    v[q] = threadIdx.x < g ? __ldcg(tot + q * kMaxGrid + threadIdx.x) : 0;
  for (int q = 0; q < 3; ++q) {
    int total;
    const int ex = block_scan(v[q], s_warp, total);
    if (threadIdx.x < g) s_pre[q][threadIdx.x] = ex;
    if (threadIdx.x == 0) s_pre[q][g] = total;
  }
  __syncthreads();
}

__device__ __forceinline__ void init_bin(const Work& w, int e) {
  w.cnt[e] = 0;
  u64* b = w.bbox + 6 * static_cast<size_t>(e);
  for (int q = 0; q < 3; ++q) {
    b[q] = kKeyPlusInf;
    b[3 + q] = kKeyMinusInf;
  }
}

__device__ __forceinline__ void init_box(u64* b) {
  for (int q = 0; q < 3; ++q) {
    b[q] = kKeyPlusInf;
    b[3 + q] = kKeyMinusInf;
  }
}

// Node j's cheapest cut, by one warp: each half-warp holds the node's 16
// bins of an axis (lane l bin l; both halves alike), scans them both ways
// (counts summed, boxes' minima and maxima: exact in any order), and the
// lanes l < 15 cost cut l; the lowest cost wins, the lowest (axis, cut)
// on ties, as numpy's argmin.  Writes split[j] and empties the node's two
// children's boxes.
__device__ void sah_split(const Work& w, int j, int n_j, int lane) {
  const int l = lane & (kBins - 1);
  double best = INFINITY;
  int best_i = 0;
  double box[12];   // the best cut's left lo, hi and right lo, hi
  for (int a = 0; a < 3; ++a) {
    const size_t e = static_cast<size_t>(j * 3 + a) * kBins + l;
    int pc = __ldcg(w.cnt + e);
    double plo[3], phi[3], slo[3], shi[3];
    for (int q = 0; q < 3; ++q) {
      plo[q] = slo[q] = of_key(__ldcg(w.bbox + 6 * e + q));
      phi[q] = shi[q] = of_key(__ldcg(w.bbox + 6 * e + 3 + q));
    }
    for (int o = 1; o < kBins; o <<= 1) {
      const int y = __shfl_up_sync(kFull, pc, o, kBins);
      if (l >= o) pc += y;
      for (int q = 0; q < 3; ++q) {
        const double ylo = __shfl_up_sync(kFull, plo[q], o, kBins);
        const double yhi = __shfl_up_sync(kFull, phi[q], o, kBins);
        const double zlo = __shfl_down_sync(kFull, slo[q], o, kBins);
        const double zhi = __shfl_down_sync(kFull, shi[q], o, kBins);
        if (l >= o) {
          plo[q] = fmin(plo[q], ylo);
          phi[q] = fmax(phi[q], yhi);
        }
        if (l + o < kBins) {
          slo[q] = fmin(slo[q], zlo);
          shi[q] = fmax(shi[q], zhi);
        }
      }
    }
    double rlo[3], rhi[3];   // the bins after cut l
    for (int q = 0; q < 3; ++q) {
      rlo[q] = __shfl_down_sync(kFull, slo[q], 1, kBins);
      rhi[q] = __shfl_down_sync(kFull, shi[q], 1, kBins);
    }
    const int nl = pc, nr = n_j - pc;
    double cost = INFINITY;
    if (l < kCuts && nl > 0 && nr > 0)
      cost = static_cast<double>(nl) * area(plo, phi) +
             static_cast<double>(nr) * area(rlo, rhi);
    int idx = l < kCuts ? a * kCuts + l : 3 * kCuts;
    for (int o = kBins / 2; o > 0; o >>= 1) {
      const double oc = __shfl_xor_sync(kFull, cost, o, kBins);
      const int oi = __shfl_xor_sync(kFull, idx, o, kBins);
      if (oc < cost || (oc == cost && oi < idx)) {
        cost = oc;
        idx = oi;
      }
    }
    // the same in every lane; a tie keeps the lower axis
    if (cost < best) {
      const int src = idx - a * kCuts;   // the cut's lane
      for (int q = 0; q < 3; ++q) {
        box[q] = __shfl_sync(kFull, plo[q], src, kBins);
        box[3 + q] = __shfl_sync(kFull, phi[q], src, kBins);
        box[6 + q] = __shfl_sync(kFull, rlo[q], src, kBins);
        box[9 + q] = __shfl_sync(kFull, rhi[q], src, kBins);
      }
      best = cost;
      best_i = idx;
    }
  }
  const bool by_sah = best < INFINITY;
  if (lane == 0)
    w.split[j] = by_sah ? (best_i / kCuts) * kBins + best_i % kCuts : -1;
  // the children's boxes (2j, then 2j + 1: lo xyz, hi xyz each): a SAH
  // cut's are the bins' on either side of it, exactly the minima and
  // maxima over the triangles there; a split by index leaves them empty
  // for D2's atomics
  if (lane < 12)
    w.cbox[12 * static_cast<size_t>(j) + lane] =
        by_sah ? key_of(box[lane])
               : (lane % 6 < 3 ? kKeyPlusInf : kKeyMinusInf);
}

// A tree over n <= LEAF_MAX triangles: one row, a leaf (or, for n = 0, no
// child) on the left and no child on the right.  One thread.
__device__ void root_leaf(int n, const float* __restrict__ tris,
                          float* nodes, int* order, float* tris_sorted,
                          int* info) {
  double lo[3] = {0.0, 0.0, 0.0}, hi[3] = {0.0, 0.0, 0.0}, big = 0.0;
  if (n > 0) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = INFINITY;
      hi[a] = -INFINITY;
    }
  }
  for (int i = 0; i < n; ++i) {
    double c[3][3];
    corners(tris, i, c);
    for (int v = 0; v < 3; ++v)
      for (int a = 0; a < 3; ++a) {
        lo[a] = fmin(lo[a], c[v][a]);
        hi[a] = fmax(hi[a], c[v][a]);
        big = fmax(big, fabs(c[v][a]));
      }
    order[i] = i;
    for (int e = 0; e < 12; ++e)
      tris_sorted[12 * i + e] = tris[12 * static_cast<size_t>(i) + e];
  }
  const double margin = big * kMargin;
  for (int e = 0; e < 16; ++e) nodes[e] = 0.f;
  for (int a = 0; a < 3; ++a) {
    nodes[a] = round_down(lo[a] - margin);
    nodes[4 + a] = round_up(hi[a] + margin);
  }
  nodes[3] = __int_as_float(n ? ~n : kEmpty);   // ~(0 << 3 | n)
  nodes[11] = __int_as_float(kEmpty);
  info[0] = 1;
  info[1] = 1;
}

// The whole build; launched cooperatively (grid.sync).  Each level runs
// six steps with a grid barrier after each:
//   B  each triangle's bins on the three axes: counts and boxes (atomics);
//   C  each node's cheapest cut (a warp a node), and its children's boxes
//      (the bins' on either side of the cut);
//   D1 each triangle's side, and its block chunk's scan of right sides;
//   D2 each triangle's place in the partition (and, in a node split by
//      index, its child's box by atomics); each child's count, and the
//      chunks' scans of leaf triangles, inner children and inner
//      triangles;
//   E  each child's link (leaf range or breadth-first number) and its box
//      rounded outward into the node's row; the next level's nodes;
//   F  each triangle to its leaf's range of order and tris_sorted, or to
//      its inner child's range of the next level, with that node's
//      centroid bounds (a warp's atomics merged by node).
__global__ void __launch_bounds__(kBlock) bvh_build_kernel(
    int n, const float* __restrict__ tris, float* __restrict__ nodes,
    int* __restrict__ order, float* __restrict__ tris_sorted,
    int* __restrict__ info, Work w) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_warp[kWarps + 1];
  __shared__ int s_pre[3][kMaxGrid + 1];
  const int g = gridDim.x;
  const int gt = blockIdx.x * kBlock + threadIdx.x, stride = g * kBlock;
  const int lane = threadIdx.x & 31, warp = gt >> 5, n_warps = stride >> 5;

  if (n <= kLeafMax) {
    if (gt == 0) root_leaf(n, tris, nodes, order, tris_sorted, info);
    return;
  }

  // The root's accumulators, then each triangle's box and centroid.
  const int kc = w.k_cap;
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < kNodeBins; e += kBlock) init_bin(w, e);
    if (threadIdx.x == 0) {
      init_box(w.ncm);
      *w.margin = 0ull;
      w.start[0] = 0;
      w.count[0] = n;
    }
  }
  grid.sync();
  u64 big = 0ull;   // bits of the largest |corner|: non-negative doubles
                    // order as their bits
  for (int i0 = gt - lane; i0 < n; i0 += stride) {   // warp-uniform
    const int i = i0 + lane;
    double cen[3] = {0.0, 0.0, 0.0};
    if (i < n) {
      double c[3][3];
      corners(tris, i, c);
      double* geo = w.geo + 9 * static_cast<size_t>(i);
      for (int a = 0; a < 3; ++a) {
        geo[a] = fmin(fmin(c[0][a], c[1][a]), c[2][a]);
        geo[3 + a] = fmax(fmax(c[0][a], c[1][a]), c[2][a]);
        cen[a] = ((c[0][a] + c[1][a]) + c[2][a]) / 3.0;
        geo[6 + a] = cen[a];
        for (int v = 0; v < 3; ++v) {
          const u64 bits =
              static_cast<u64>(__double_as_longlong(fabs(c[v][a])));
          big = bits > big ? bits : big;
        }
      }
      w.items[i] = i;
      w.node[i] = 0;
    }
    add_centroid(w, i < n ? 0 : -1, cen, lane);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 other = __shfl_xor_sync(kFull, big, o);
    big = other > big ? other : big;
  }
  if (lane == 0) atomicMax(w.margin, big);
  grid.sync();
  const double margin =
      __longlong_as_double(static_cast<long long>(__ldcg(w.margin))) *
      kMargin;

  int k = 1, m = n, cur = 0, base = 0, placed = 0, n_nodes = 1, depth = 0;
  while (k > 0) {
    ++depth;
    const int* start = w.start + cur * kc;
    const int* count = w.count + cur * kc;
    int* start_next = w.start + (cur ^ 1) * kc;
    int* count_next = w.count + (cur ^ 1) * kc;

    // B: bins on the three axes, their counts and boxes
    for (int p = gt; p < m; p += stride) {
      const int it = __ldcg(w.items + p), j = __ldcg(w.node + p);
      const double* geo = w.geo + 9 * static_cast<size_t>(it);
      int packed = 0;
      for (int a = 0; a < 3; ++a) {
        const double mn = of_key(__ldcg(w.ncm + 6 * j + a));
        const double ext = of_key(__ldcg(w.ncm + 6 * j + 3 + a)) - mn;
        const double scale = ext > 0.0 ? static_cast<double>(kBins) / ext
                                       : 0.0;
        int b = static_cast<int>((__ldcg(geo + 6 + a) - mn) * scale);
        b = min(max(b, 0), kBins - 1);
        packed |= b << (4 * a);
        const size_t e = static_cast<size_t>(j * 3 + a) * kBins + b;
        atomicAdd(w.cnt + e, 1);
        for (int q = 0; q < 3; ++q) {
          atomicMin(w.bbox + 6 * e + q, key_of(__ldcg(geo + q)));
          atomicMax(w.bbox + 6 * e + 3 + q, key_of(__ldcg(geo + 3 + q)));
        }
      }
      w.binp[p] = packed;
    }
    grid.sync();

    // C: each node's cut
    for (int j = warp; j < k; j += n_warps)
      sah_split(w, j, __ldcg(count + j), lane);
    grid.sync();

    // D1: sides, and the chunk scans of the right ones
    const int chunk = (m + g - 1) / g;
    {
      const int lo = min(m, static_cast<int>(blockIdx.x) * chunk);
      const int hi = min(m, lo + chunk);
      int carry = 0;
      for (int b0 = lo; b0 < hi; b0 += kBlock) {
        const int p = b0 + threadIdx.x;
        int r = 0;
        if (p < hi) {
          const int j = __ldcg(w.node + p), sp = __ldcg(w.split + j);
          const int packed = __ldcg(w.binp + p);
          r = sp >= 0 ? ((packed >> (4 * (sp >> 4))) & 15) > (sp & 15)
                      : p - __ldcg(start + j) >= __ldcg(count + j) / 2;
          w.binp[p] = packed | (r << 12);
        }
        int total;
        const int ex = block_scan(r, s_warp, total);
        if (p < hi) w.scan[p] = carry + ex;
        carry += total;
      }
      if (threadIdx.x == 0) w.btot[blockIdx.x] = carry;
    }
    grid.sync();

    // D2: the stable partition, the children's boxes and counts, and the
    // chunk scans over the children
    grid_prefix(w.btot, s_pre[0], s_warp);
    // right sides at positions before x
    auto r_before = [&](int x) {
      return x >= m ? s_pre[0][g] : s_pre[0][x / chunk] + __ldcg(w.scan + x);
    };
    for (int p = gt; p < m; p += stride) {
      const int it = __ldcg(w.items + p), j = __ldcg(w.node + p);
      const int s = __ldcg(start + j), c = __ldcg(count + j);
      const int r = (__ldcg(w.binp + p) >> 12) & 1;
      const int rs = r_before(s), nr = r_before(s + c) - rs;
      const int rb = r_before(p) - rs;
      const int q = r ? s + (c - nr) + rb : p - rb;
      w.part[q] = it;
      w.child[q] = 2 * j + r;
      if (__ldcg(w.split + j) < 0) {   // C gave the boxes of a SAH split
        const double* geo = w.geo + 9 * static_cast<size_t>(it);
        u64* cb = w.cbox + 6 * (2 * static_cast<size_t>(j) + r);
        for (int a = 0; a < 3; ++a) {
          atomicMin(cb + a, key_of(__ldcg(geo + a)));
          atomicMax(cb + 3 + a, key_of(__ldcg(geo + 3 + a)));
        }
      }
    }
    const int n_ch = 2 * k, chunk2 = (n_ch + g - 1) / g, cc_cap = 2 * kc;
    {
      const int lo = min(n_ch, static_cast<int>(blockIdx.x) * chunk2);
      const int hi = min(n_ch, lo + chunk2);
      int carry0 = 0, carry1 = 0, carry2 = 0;
      for (int b0 = lo; b0 < hi; b0 += kBlock) {
        const int ch = b0 + threadIdx.x;
        int v0 = 0, v1 = 0, v2 = 0;
        if (ch < hi) {
          const int j = ch >> 1, s = __ldcg(start + j);
          const int nr = r_before(s + __ldcg(count + j)) - r_before(s);
          const int cc = (ch & 1) ? nr : __ldcg(count + j) - nr;
          const bool leaf = cc <= kLeafMax;
          v0 = leaf ? cc : 0;
          v1 = leaf ? 0 : 1;
          v2 = leaf ? 0 : cc;
          if (!(ch & 1)) w.nright[j] = nr;
        }
        int t0, t1, t2;
        const int e0 = block_scan(v0, s_warp, t0);
        const int e1 = block_scan(v1, s_warp, t1);
        const int e2 = block_scan(v2, s_warp, t2);
        if (ch < hi) {
          w.cscan[ch] = carry0 + e0;
          w.cscan[cc_cap + ch] = carry1 + e1;
          w.cscan[2 * cc_cap + ch] = carry2 + e2;
        }
        carry0 += t0;
        carry1 += t1;
        carry2 += t2;
      }
      if (threadIdx.x == 0) {
        w.ctot[blockIdx.x] = carry0;
        w.ctot[kMaxGrid + blockIdx.x] = carry1;
        w.ctot[2 * kMaxGrid + blockIdx.x] = carry2;
      }
    }
    grid.sync();

    // E: links and boxes of the level's rows, the next level's nodes
    grid_prefix3(w.ctot, s_pre, s_warp);
    for (int ch = gt; ch < n_ch; ch += stride) {
      const int j = ch >> 1, side = ch & 1, blk = ch / chunk2;
      const int nr = __ldcg(w.nright + j);
      const int cc = side ? nr : __ldcg(count + j) - nr;
      int link;
      if (cc <= kLeafMax) {
        const int first = placed + s_pre[0][blk] + __ldcg(w.cscan + ch);
        link = ~((first << 3) | cc);
        w.cbase[ch] = first;
        w.cnext[ch] = -1;
      } else {
        const int rank = s_pre[1][blk] + __ldcg(w.cscan + cc_cap + ch);
        const int at = s_pre[2][blk] + __ldcg(w.cscan + 2 * cc_cap + ch);
        link = n_nodes + rank;
        w.cbase[ch] = at;
        w.cnext[ch] = rank;
        start_next[rank] = at;
        count_next[rank] = cc;
        init_box(w.ncm + 6 * static_cast<size_t>(rank));
      }
      float* row = nodes + 16 * static_cast<size_t>(base + j) + 8 * side;
      const u64* cb = w.cbox + 6 * static_cast<size_t>(ch);
      for (int a = 0; a < 3; ++a) {
        row[a] = round_down(of_key(__ldcg(cb + a)) - margin);
        row[4 + a] = round_up(of_key(__ldcg(cb + 3 + a)) + margin);
      }
      row[3] = __int_as_float(link);
      row[7] = 0.f;
    }
    const int leaf_tris = s_pre[0][g], k_next = s_pre[1][g];
    const int m_next = s_pre[2][g];
    grid.sync();

    // F: every triangle to its leaf or to the next level
    for (int q0 = gt - lane; q0 < m; q0 += stride) {   // warp-uniform
      const int q = q0 + lane;
      int nx = -1;
      double cen[3] = {0.0, 0.0, 0.0};
      if (q < m) {
        const int it = __ldcg(w.part + q), ch = __ldcg(w.child + q);
        const int j = ch >> 1;
        const int c = __ldcg(count + j), nr = __ldcg(w.nright + j);
        const int off = q - (__ldcg(start + j) + ((ch & 1) ? c - nr : 0));
        const int at = __ldcg(w.cbase + ch) + off;
        nx = __ldcg(w.cnext + ch);
        if (nx < 0) {
          order[at] = it;
          const float* src = tris + 12 * static_cast<size_t>(it);
          float* dst = tris_sorted + 12 * static_cast<size_t>(at);
          for (int e = 0; e < 12; ++e) dst[e] = src[e];
        } else {
          w.items[at] = it;
          w.node[at] = nx;
          const double* geo = w.geo + 9 * static_cast<size_t>(it);
          for (int a = 0; a < 3; ++a) cen[a] = __ldcg(geo + 6 + a);
        }
      }
      add_centroid(w, nx, cen, lane);
    }
    for (int e = gt; e < k_next * kNodeBins; e += stride) init_bin(w, e);
    base += k;
    placed += leaf_tris;
    n_nodes += k_next;
    k = k_next;
    m = m_next;
    cur ^= 1;
    grid.sync();
  }
  if (gt == 0) {
    info[0] = n_nodes;
    info[1] = depth;
  }
}

}  // namespace

// Bytes of the work buffer rlrpt_bvh_build takes for n_tris triangles.
extern "C" long long rlrpt_bvh_workspace(int n_tris) {
  size_t bytes = 0;
  layout(n_tris, nullptr, bytes);
  return static_cast<long long>(bytes);
}

// The tree of ops/bvh.py over tris (n_tris, 12) f32, contiguous: nodes
// (max(n_tris - 1, 1), 16) f32, of which the first info[0] rows are the
// tree; order (n_tris,) i32; tris_sorted (n_tris, 12) f32; info (2,) i32
// receives (rows, depth); work: rlrpt_bvh_workspace(n_tris) bytes, no
// values needed.  One cooperative launch on `stream`; does not
// synchronise.  Returns the first CUDA error of the grid query and the
// launch, or 0.
extern "C" int rlrpt_bvh_build(int n_tris, const void* tris, void* nodes,
                               void* order, void* tris_sorted, void* info,
                               void* work, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bvh_build_kernel, kBlock, 0));
  if (err != 0) return err;
  if (per_sm == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = n_tris <= kLeafMax
                       ? 1
                       : (n_tris + kTrisPerBlock - 1) / kTrisPerBlock;
  const int blocks = std::max(1, std::min({want, per_sm * sms, kMaxGrid}));
  size_t bytes = 0;
  Work w = layout(n_tris, static_cast<char*>(work), bytes);
  int n = n_tris;
  const float* t = static_cast<const float*>(tris);
  float* nd = static_cast<float*>(nodes);
  int* od = static_cast<int*>(order);
  float* ts = static_cast<float*>(tris_sorted);
  int* inf = static_cast<int*>(info);
  void* args[] = {&n, &t, &nd, &od, &ts, &inf, &w};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bvh_build_kernel), dim3(blocks),
      dim3(kBlock), args, 0, static_cast<cudaStream_t>(stream)));
  const int last = static_cast<int>(cudaGetLastError());   // clears it
  return err != 0 ? err : last;
}
