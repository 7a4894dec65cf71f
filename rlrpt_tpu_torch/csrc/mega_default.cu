// B1: the default path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rlrpt_tpu/ops/megakernel.py:_mega_kernel
// (launcher render_default_mega): the whole frame in one launch, every ray
// slot walking its own regenerative bounce loop with the counter PRNG,
// uniform hemisphere sampling, optional Russian roulette, and per-pixel
// RGB + path-length sums.
//
// What bounds it on this card: f32 issue rate in the closest-hit sweep.
// Each bounce of each slot tests every triangle (~30 flops apiece, 38
// triangles for the Cornell box) against at most a few hundred bytes of
// memory traffic per path, so the kernel is compute- and latency-bound,
// and divergence matters: a warp runs until its longest path ends.
//
// What the design does about it: one thread per slot, so the TPU's (8,128)
// vector tiles and its (4T,16)@(16,R) MXU reformulation of Moller-Trumbore
// give way to scalar exact-f32 Moller-Trumbore on each thread; triangles
// sit in shared memory (one load for a scene of one tile, streamed tiles
// of 256 otherwise); a hit pays one division and reads its 16-float
// material row from global memory (L1-cached) once.  Slot regeneration
// keeps threads busy across samples; pix_mux > 1 lengthens each slot's
// work to shrink the tail.  It is built without FMA contraction, so it
// matches its torch twin bit for bit, for about 16% more kernel time
// (_cuda.py).  wgmma, TMA and warp-level tuning are later work.
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
                        float* __restrict__ path_sum, int* __restrict__ iters) {
  rlrpt::run_slots(p, tris, mat, UniformSampler{}, rad, path_sum, iters);
}

}  // namespace

extern "C" const char* rlrpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// tris (n_tris, 12) f32, mat (n_tris, 16) f32; rad (pix_mux, n_slots, 3)
// f32, path_sum (n_slots,) f32, iters (n_slots,) i32.  Returns
// cudaGetLastError() after the launch.
extern "C" int rlrpt_mega_default(rlrpt::MegaParams p, const void* tris,
                                  const void* mat, void* rad, void* path_sum,
                                  void* iters, void* stream) {
  const int blocks = (p.n_slots + rlrpt::kBlock - 1) / rlrpt::kBlock;
  mega_default_kernel<<<blocks, rlrpt::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float4*>(tris), static_cast<const float*>(mat),
      static_cast<float*>(rad), static_cast<float*>(path_sum),
      static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}
