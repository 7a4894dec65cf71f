// B1: the default path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rlrpt_tpu/ops/megakernel.py:_mega_kernel
// (launcher render_default_mega): the whole frame in one launch, every ray
// slot walking its own regenerative bounce loop with the counter PRNG,
// uniform hemisphere sampling, optional Russian roulette, and per-pixel
// RGB + path-length sums.
//
// What bounds it on this card: f32 issue rate in the closest-hit sweep.
// Each bounce of each slot tests every triangle (50 f32 operations apiece, 38
// triangles for the Cornell box) against at most a few hundred bytes of
// memory traffic per path, so the kernel is compute- and latency-bound,
// and divergence matters: a warp runs until its longest path ends.
//
// What the design does about it: one thread per slot at a time, so the
// TPU's (8,128) vector tiles and its (4T,16)@(16,R) MXU reformulation of
// Moller-Trumbore give way to scalar exact-f32 Moller-Trumbore on each
// thread; triangles sit in shared memory (one load for a scene of one
// tile, streamed tiles of 256 otherwise); a hit pays one division and
// reads its 16-float material row from global memory (L1-cached) once.
// Slot regeneration keeps a thread busy across samples, and the persistent
// grid of run_slots hands a thread whose slot has ended the next unstarted
// slot, so lanes stay busy until the slot queue is empty.  It is built
// without FMA contraction, so it matches its torch twin bit for bit, for
// about 16% more kernel time (_cuda.py).  wgmma, TMA and warp-level tuning
// are later work.
//
// The culled B1 (rlrpt_mega_default_bvh) replaces the JAX kernel's AABB
// chunk cull (megakernel.py:411-472, on by default for a scene of more
// than one 256-triangle chunk): where the TPU skipped a whole chunk that
// no live lane could hit closer than its best hit, each thread here walks
// its own ray through the frame's bounding-volume hierarchy
// (rlrpt::walk, shared with B4), so a segment costs a few box and
// triangle tests in place of T triangle tests.  Everything else (slots,
// RNG keys, regeneration, outputs) is the sweep kernel's, and the walk
// returns the sweep's hit, so the two frames are bit-equal.
#include "path_common.cuh"

namespace {

struct UniformSampler {
  // throughput *= (diffuse/pi) * cos / RHO with RHO = 1/(2pi): *2*cos.
  __device__ __forceinline__ void operator()(
      const rlrpt::MegaParams&, int, uint32_t, float u1, float u2,
      const rlrpt::Hit&, float nx, float ny, float nz, float& dx, float& dy,
      float& dz, float& scale) const {
    rlrpt::uniform_hemisphere_dir(u1, u2, nx, ny, nz, dx, dy, dz);
    scale = 2.f * u1;
  }
};

__global__ void __launch_bounds__(rlrpt::kBlock)
    mega_default_kernel(rlrpt::MegaParams p, const float4* __restrict__ tris,
                        const float* __restrict__ mat, float* __restrict__ rad,
                        float* __restrict__ path_sum, int* __restrict__ iters,
                        int* __restrict__ next) {
  rlrpt::run_slots(p, tris, mat, UniformSampler{}, rad, path_sum, iters,
                   next);
}

// The culled B1: the same slot loop with its closest hit by the walk of
// the frame's tree (path_common.cuh:run_slots_walk).  kCount: the
// count-only build, which also sums the walks' visits and tests, and their
// warp steps and active lanes.
template <bool kCount>
__global__ void __launch_bounds__(rlrpt::kBlock) mega_default_bvh_kernel(
    rlrpt::MegaParams p, int n_nodes, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, const int* __restrict__ order,
    const float* __restrict__ mat, float* __restrict__ rad,
    float* __restrict__ path_sum, int* __restrict__ iters,
    int* __restrict__ next, unsigned long long* __restrict__ counts) {
  extern __shared__ float4 s_nodes[];   // the top min(n_nodes, kTopNodes)
  rlrpt::run_slots_walk<kCount>(p, s_nodes, n_nodes, nodes, tris, order, mat,
                                UniformSampler{}, rad, path_sum, iters, next,
                                counts);
}

template <bool kCount>
int launch_bvh(const rlrpt::MegaParams& p, int n_nodes, const void* nodes,
               const void* tris, const void* order, const void* mat,
               void* rad, void* path_sum, void* iters, void* next,
               void* counts, void* stream) {
  // the occupancy query is told of the top nodes' shared memory
  const size_t smem =
      sizeof(float4) * 4 * std::min(n_nodes, rlrpt::kTopNodes);
  int blocks = 0;
  const int err = rlrpt::slot_grid(mega_default_bvh_kernel<kCount>,
                                   p.n_slots, rlrpt::kBlock, smem, blocks);
  if (err != 0) return err;
  mega_default_bvh_kernel<kCount><<<blocks, rlrpt::kBlock, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      p, n_nodes, static_cast<const float4*>(nodes),
      static_cast<const float4*>(tris), static_cast<const int*>(order),
      static_cast<const float*>(mat), static_cast<float*>(rad),
      static_cast<float*>(path_sum), static_cast<int*>(iters),
      static_cast<int*>(next), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* rlrpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// tris (n_tris, 12) f32, mat (n_tris, 16) f32; rad (pix_mux, n_slots, 3)
// f32, path_sum (n_slots,) f32, iters (n_slots,) i32; next (1,) i32 zero,
// the slot counter of the persistent grid.  Returns the first CUDA error
// of the grid query and the launch, or 0.
extern "C" int rlrpt_mega_default(rlrpt::MegaParams p, const void* tris,
                                  const void* mat, void* rad, void* path_sum,
                                  void* iters, void* next, void* stream) {
  int blocks = 0;
  const int err = rlrpt::slot_grid(mega_default_kernel, p.n_slots,
                                   rlrpt::kBlock, 0, blocks);
  if (err != 0) return err;
  mega_default_kernel<<<blocks, rlrpt::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float4*>(tris), static_cast<const float*>(mat),
      static_cast<float*>(rad), static_cast<float*>(path_sum),
      static_cast<int*>(iters), static_cast<int*>(next));
  return static_cast<int>(cudaGetLastError());
}

// The culled B1 over the tree of ops/bvh.py built from B1's tris: nodes
// (n_nodes, 16) f32, tris (p.n_tris, 12) f32 in its leaf order, order
// (p.n_tris,) i32; mat (p.n_tris, 16) f32 unpermuted; rad, path_sum,
// iters and next as rlrpt_mega_default's, and the same frame bit for bit.
// counts: null, or (4,) uint64 zeros for the count-only build, which adds
// the walks' inner-node visits, triangle tests, warp steps and active
// lanes there (path_common.cuh:WalkCount).  Returns the
// first CUDA error of the grid query and the launch, or 0.
extern "C" int rlrpt_mega_default_bvh(rlrpt::MegaParams p, int n_nodes,
                                      const void* nodes, const void* tris,
                                      const void* order, const void* mat,
                                      void* rad, void* path_sum, void* iters,
                                      void* next, void* counts,
                                      void* stream) {
  return counts == nullptr
             ? launch_bvh<false>(p, n_nodes, nodes, tris, order, mat, rad,
                                 path_sum, iters, next, counts, stream)
             : launch_bvh<true>(p, n_nodes, nodes, tris, order, mat, rad,
                                path_sum, iters, next, counts, stream);
}
