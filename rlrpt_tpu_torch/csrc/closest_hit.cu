// B4a, B4b, B4c: the closest-hit kernel of the wavefront integrators, for
// Hopper (sm_90a), as a bounding-volume-hierarchy walk.
//
// Replaces three Pallas TPU kernels of rlrpt_tpu/ops/intersect_pallas.py:
// _hit_kernel (B4b, launcher closest_hit_packed: exact f32
// Moller-Trumbore, t and triangle index), _hit_kernel_mxu (B4c, launcher
// closest_hit_packed_mxu: the same output from compensated-bf16 MXU
// operands) and _hit_mat_kernel_mxu (B4a, launcher closest_hit_mat_mxu:
// plus the hit's 16-float material row, which the TPU fetched with a
// one-hot matmul because gathers are slow there).  All three are this one
// kernel: the hit is exact f32, so B4c's output is B4b's, and the material
// row is a load of the winner's row from the unpermuted (T, 16) table.
//
// What bounds it on this card: no longer the brute-force sweep's flops (50
// a ray-triangle pair, every pair), but the walk's instructions (slab
// tests, the stack, dependent branches) and its scattered node and
// triangle loads, over a few inner nodes and leaves a ray.
//
// What the design does about it: each thread walks one ray through the
// hierarchy of ops/bvh.py (layout and link encoding there; the walk is
// rlrpt::walk in path_common.cuh, which the culled B1 shares), nearer child
// first, with its own stack of (link, near) entries, and skips a box only
// when its near distance is above the best t so far or its far one below
// 0, on the robust slab test of Ize (JCGT 2013: the far distance scaled by
// 1 + 2 gamma_3; zero direction components clamped as megakernel.py:
// 424-428).  Leaves run hit_tris's arithmetic (hit_tris_mapped), and an
// equal t goes to the lower original index, so the answer is the sweep's
// bit for bit.  The walk runs while-while, so a warp's lanes test their
// leaves together.  The first kTopNodes inner nodes (breadth-first, at
// most 16 KB, sized to the tree) sit in shared memory; the rest, the
// triangles and the material rows are read through the read-only cache.
// The grid is one thread a ray: a persistent grid whose warps pulled their
// next 32 rays from a device counter was timed against it on the H100: no
// faster on camera rays, 4-6% slower on the small scenes' bounce rays and
// 5% faster on the 4,980-triangle scene's (PERF.md), so it went.  The
// wavefront's live-ray high-water mark arrives as a device int32
// (`count`), so the host never waits on it: rays at index >= count are
// written as a miss (t = INF, index 0, zero row), and a block wholly past
// it does no walk.
//
// The brute-force sweep stays below as closest_hit_sweep_kernel: no path
// calls it, and the card tests use it as the same-card reference.
#include "path_common.cuh"

namespace {

__device__ __forceinline__ void store(int i, const rlrpt::Hit& h,
                                      const float4* __restrict__ mat,
                                      float* __restrict__ t_out,
                                      int* __restrict__ idx_out,
                                      float4* __restrict__ mat_out) {
  const bool hit = h.t < rlrpt::kInf;
  t_out[i] = h.t;
  idx_out[i] = hit ? h.tri : 0;
  if (mat_out != nullptr) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mat_out[4 * static_cast<size_t>(i) + j] =
          hit ? __ldg(mat + 4 * static_cast<size_t>(h.tri) + j) : zero;
  }
}

__global__ void __launch_bounds__(rlrpt::kBlock) closest_hit_bvh_kernel(
    int n_rays, int n_nodes, const int* __restrict__ count,
    const float* __restrict__ o, const float* __restrict__ d,
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const int* __restrict__ order, const float4* __restrict__ mat,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float4* __restrict__ mat_out) {
  extern __shared__ float4 s_nodes[];   // the top min(n_nodes, kTopNodes)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int live = max(min(__ldg(count), n_rays), 0);
  rlrpt::Hit h{rlrpt::kInf, -1, 0.f, 0.f, 0.f};
  if (static_cast<int>(blockIdx.x * blockDim.x) < live) {
    const int n_top = min(n_nodes, rlrpt::kTopNodes);
    for (int j = threadIdx.x; j < 4 * n_top; j += blockDim.x)
      s_nodes[j] = __ldg(nodes + j);
    __syncthreads();
    if (i < live)
      h = rlrpt::walk(s_nodes, n_top, nodes, tris, order, o[3 * i],
                      o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                      d[3 * i + 2]);
  }
  if (i >= n_rays) return;
  store(i, h, mat, t_out, idx_out, mat_out);
}

// The brute-force sweep (the kernel the walk replaced): one thread a ray,
// triangles streamed through shared memory in tiles of 256, the
// first-tested triangle winning ties (strict <).
__global__ void __launch_bounds__(rlrpt::kBlock) closest_hit_sweep_kernel(
    int n_rays, int n_tris, const int* __restrict__ count,
    const float* __restrict__ o, const float* __restrict__ d,
    const float4* __restrict__ tris, const float4* __restrict__ mat,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float4* __restrict__ mat_out) {
  __shared__ float4 s_tri[3 * rlrpt::kTileTris];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int live = max(min(__ldg(count), n_rays), 0);
  rlrpt::Hit h{rlrpt::kInf, -1, 0.f, 0.f, 0.f};
  if (static_cast<int>(blockIdx.x * blockDim.x) < live) {
    const bool act = i < live;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    if (act) {
      ox = o[3 * i];
      oy = o[3 * i + 1];
      oz = o[3 * i + 2];
      dx = d[3 * i];
      dy = d[3 * i + 1];
      dz = d[3 * i + 2];
    }
    h = rlrpt::sweep(tris, s_tri, n_tris, false, act, ox, oy, oz, dx, dy,
                     dz);
  }
  if (i >= n_rays) return;
  store(i, h, mat, t_out, idx_out, mat_out);
}

}  // namespace

// o, d (n_rays, 3) f32; the hierarchy of ops/bvh.py: nodes (n_nodes, 16)
// f32, tris (T, 12) f32 in its leaf order and order (T,) i32; count: device
// int32, the number of leading rays to trace.  Outputs t (n_rays,) f32,
// idx (n_rays,) i32 (original indices) and, when mat and mat_out are not
// null, mat_out (n_rays, 16) f32 rows of the unpermuted mat (T, 16) f32.
// One thread a ray.  Returns cudaGetLastError() after the launch.
extern "C" int rlrpt_closest_hit(int n_rays, int n_nodes, const void* count,
                                 const void* o, const void* d,
                                 const void* nodes, const void* tris,
                                 const void* order, const void* mat,
                                 void* t_out, void* idx_out, void* mat_out,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  // shared memory sized to the tree's top: a small scene's blocks use
  // little of it, and more of them fit on an SM
  const size_t smem = sizeof(float4) * 4 * std::min(n_nodes, rlrpt::kTopNodes);
  const int blocks = (n_rays + rlrpt::kBlock - 1) / rlrpt::kBlock;
  closest_hit_bvh_kernel<<<blocks, rlrpt::kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      n_rays, n_nodes, static_cast<const int*>(count),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float4*>(nodes), static_cast<const float4*>(tris),
      static_cast<const int*>(order), static_cast<const float4*>(mat),
      static_cast<float*>(t_out), static_cast<int*>(idx_out),
      static_cast<float4*>(mat_out));
  return static_cast<int>(cudaGetLastError());
}

// The brute-force sweep over tris (n_tris, 12) f32 in index order, with
// rlrpt_closest_hit's rays, count and outputs.
extern "C" int rlrpt_closest_hit_sweep(int n_rays, int n_tris,
                                       const void* count, const void* o,
                                       const void* d, const void* tris,
                                       const void* mat, void* t_out,
                                       void* idx_out, void* mat_out,
                                       void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + rlrpt::kBlock - 1) / rlrpt::kBlock;
  closest_hit_sweep_kernel<<<blocks, rlrpt::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      n_rays, n_tris, static_cast<const int*>(count),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float4*>(tris), static_cast<const float4*>(mat),
      static_cast<float*>(t_out), static_cast<int*>(idx_out),
      static_cast<float4*>(mat_out));
  return static_cast<int>(cudaGetLastError());
}
