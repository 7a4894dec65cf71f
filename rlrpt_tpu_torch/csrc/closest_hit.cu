// B4a, B4b, B4c: the closest-hit kernels of the wavefront integrators, for
// Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of rlrpt_tpu/ops/intersect_pallas.py:
// _hit_kernel (B4b, launcher closest_hit_packed: exact f32
// Moller-Trumbore, t and triangle index), _hit_kernel_mxu (B4c, launcher
// closest_hit_packed_mxu: the same output from compensated-bf16 MXU
// operands) and _hit_mat_kernel_mxu (B4a, launcher closest_hit_mat_mxu:
// plus the hit's 16-float material row, which the TPU fetched with a
// one-hot matmul because gathers are slow there).  All three are this one
// kernel: the hit is exact f32 (hit_tris of path_common.cuh, the
// megakernels' routine), so B4c's output is B4b's, and the material row
// is a load of the winner's row from the (T, 16) f32 table.
//
// What bounds it on this card: f32 throughput in the sweep, about 30
// flops per (ray, triangle) pair against 24 bytes read and 8 (or 72)
// written per ray; at 38 triangles a ray costs ~1.1k flops, so 518,400
// rays are compute-bound well below a millisecond, and launch latency
// matters at small batches.
//
// What the design does about it: one thread per ray; triangles stream
// through shared memory in tiles of 256 (every thread of a block loads a
// share, then all test from shared memory); the first-tested triangle wins
// ties (strict <), as the JAX kernels' lowest index does.  The wavefront's
// live-ray high-water mark arrives as a device int32 (`count`), so the host
// never waits on it: rays at index >= count are skipped and written as a
// miss (t = INF, index 0, zero row), and a block wholly past it returns
// without a sweep.
#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(rlrpt::kBlock) closest_hit_kernel(
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
  const bool hit = h.t < rlrpt::kInf;
  t_out[i] = h.t;
  idx_out[i] = hit ? h.tri : 0;
  if (mat_out != nullptr) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mat_out[4 * static_cast<size_t>(i) + j] =
          hit ? __ldg(mat + 4 * h.tri + j) : zero;
  }
}

}  // namespace

// o, d (n_rays, 3) f32; tris (n_tris, 12) f32 as rlrpt_mega_default's;
// count: device int32, the number of leading rays to trace.  Outputs
// t (n_rays,) f32, idx (n_rays,) i32 and, when mat and mat_out are not
// null, mat_out (n_rays, 16) f32 rows of mat (n_tris, 16) f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int rlrpt_closest_hit(int n_rays, int n_tris, const void* count,
                                 const void* o, const void* d,
                                 const void* tris, const void* mat,
                                 void* t_out, void* idx_out, void* mat_out,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + rlrpt::kBlock - 1) / rlrpt::kBlock;
  closest_hit_kernel<<<blocks, rlrpt::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n_rays, n_tris, static_cast<const int*>(count),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float4*>(tris), static_cast<const float4*>(mat),
      static_cast<float*>(t_out), static_cast<int*>(idx_out),
      static_cast<float4*>(mat_out));
  return static_cast<int>(cudaGetLastError());
}
