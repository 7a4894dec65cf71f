// B3: the guided (frozen-map) path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rlrpt_tpu/ops/guided_mega.py:_guided_kernel
// (launcher render_guided_mega): B1's regenerative slot loop, but each
// surface bounce draws a sector from a frozen bf16 CDF column keyed on
// (hit triangle, quantised barycentric u, v), weights by pdf =
// (hi - lo) * S / 2pi from the same rounded values the draw compared, and
// maps the sector to a direction with the Chiu concentric map.  Unbiased
// for any table.
//
// What bounds it on this card: as B1, the f32 closest-hit sweep, plus a
// few entries of one CDF column per bounce, read from a table of
// t_pad * uv_bins^2 columns of S_pad bf16 values (160 KB for the Cornell
// box at uv_bins 4), which stays resident in L2 and mostly in L1.
//
// What the design does about it: the TPU fetched the column with a
// one-hot (S_pad, C) @ (C, r) MXU matmul because gathers are slow there;
// here the column is a plain load.  The wrapper hands the table over
// transposed, (C, S_pad), so a column is contiguous, and checks that every
// column is non-decreasing; the TPU kernel's sector count #{entries < us}
// is then the lower bound of us, found by a binary search of about 7
// probes instead of 128 compares.  The slot loop is run_slots' persistent,
// work-pulling grid.  The sampler (rlrpt::CdfSampler) lives in
// path_common.cuh: B2 draws the same paths with it.
//
// Two more kernels time the sampler's share of B3 by difference
// (render_guided_mega(ablate=...), the JAX kernel's `ablate` switch,
// guided_mega.py:340-370): the same slot loop with rlrpt::AblateSampler,
// a uniform sector at the uniform pdf, with ("fetch") or without
// ("uniform") the load of the bin column.  Their images are wrong by
// design; each has its own entry point and launch count.
#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(rlrpt::kBlock)
    mega_guided_kernel(rlrpt::MegaParams p, const float4* __restrict__ tris,
                       const float* __restrict__ mat,
                       const __nv_bfloat16* __restrict__ cdf,
                       float* __restrict__ rad, float* __restrict__ path_sum,
                       int* __restrict__ iters, int* __restrict__ next) {
  rlrpt::run_slots(p, tris, mat, rlrpt::CdfSampler{cdf, -1}, rad, path_sum,
                   iters, next);
}

template <bool kFetch>
__global__ void __launch_bounds__(rlrpt::kBlock)
    mega_guided_ablate_kernel(rlrpt::MegaParams p,
                              const float4* __restrict__ tris,
                              const float* __restrict__ mat,
                              const __nv_bfloat16* __restrict__ cdf,
                              float* __restrict__ rad,
                              float* __restrict__ path_sum,
                              int* __restrict__ iters,
                              int* __restrict__ next) {
  rlrpt::run_slots(p, tris, mat, rlrpt::AblateSampler<kFetch>{cdf}, rad,
                   path_sum, iters, next);
}

template <class Kernel>
int launch(Kernel kernel, const rlrpt::MegaParams& p, const void* tris,
           const void* mat, const void* cdf, void* rad, void* path_sum,
           void* iters, void* next, void* stream) {
  int blocks = 0;
  const int err = rlrpt::slot_grid(kernel, p.n_slots, rlrpt::kBlock, 0,
                                   blocks);
  if (err != 0) return err;
  kernel<<<blocks, rlrpt::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float4*>(tris), static_cast<const float*>(mat),
      static_cast<const __nv_bfloat16*>(cdf), static_cast<float*>(rad),
      static_cast<float*>(path_sum), static_cast<int*>(iters),
      static_cast<int*>(next));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As rlrpt_mega_default, plus cdf (n_cols, s_pad) bf16: the TriBinCDF
// table transposed so that each column is contiguous, non-decreasing down
// every column (ops/guided_mega.py:check_cdf).
extern "C" int rlrpt_mega_guided(rlrpt::MegaParams p, const void* tris,
                                 const void* mat, const void* cdf, void* rad,
                                 void* path_sum, void* iters, void* next,
                                 void* stream) {
  return launch(mega_guided_kernel, p, tris, mat, cdf, rad, path_sum, iters,
                next, stream);
}

// ablate="uniform": as rlrpt_mega_guided; cdf is not read.
extern "C" int rlrpt_mega_guided_uniform(rlrpt::MegaParams p,
                                         const void* tris, const void* mat,
                                         const void* cdf, void* rad,
                                         void* path_sum, void* iters,
                                         void* next, void* stream) {
  return launch(mega_guided_ablate_kernel<false>, p, tris, mat, cdf, rad,
                path_sum, iters, next, stream);
}

// ablate="fetch": as rlrpt_mega_guided; one entry of a column is read.
extern "C" int rlrpt_mega_guided_fetch(rlrpt::MegaParams p, const void* tris,
                                       const void* mat, const void* cdf,
                                       void* rad, void* path_sum, void* iters,
                                       void* next, void* stream) {
  return launch(mega_guided_ablate_kernel<true>, p, tris, mat, cdf, rad,
                path_sum, iters, next, stream);
}
