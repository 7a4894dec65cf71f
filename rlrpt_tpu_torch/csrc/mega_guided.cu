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
// What bounds it on this card: as B1, the f32 closest-hit sweep, plus one
// CDF column per bounce (S_pad bf16 values, 256 bytes at 128 sectors) read
// from a table of t_pad * uv_bins^2 columns (160 KB for the Cornell box at
// uv_bins 4), which stays resident in L2 and mostly in L1.
//
// What the design does about it: the TPU fetched the column with a
// one-hot (S_pad, C) @ (C, r) MXU matmul because gathers are slow there;
// here the column is a plain load.  The wrapper hands the table over
// transposed, (C, S_pad), so a column is contiguous and is read as
// 16-byte vectors; the sector count is a compare per entry, exact for any
// table (monotone or not), as the TPU kernel's comparison count is.  The
// sampler (rlrpt::CdfSampler) lives in path_common.cuh: B2 draws the same
// paths with it.
#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(rlrpt::kBlock)
    mega_guided_kernel(rlrpt::MegaParams p, const float4* __restrict__ tris,
                       const float* __restrict__ mat,
                       const __nv_bfloat16* __restrict__ cdf,
                       float* __restrict__ rad, float* __restrict__ path_sum,
                       int* __restrict__ iters) {
  rlrpt::run_slots(p, tris, mat, rlrpt::CdfSampler{cdf, -1}, rad, path_sum,
                   iters);
}

}  // namespace

// As rlrpt_mega_default, plus cdf (n_cols, s_pad) bf16: the TriBinCDF
// table transposed so that each column is contiguous.
extern "C" int rlrpt_mega_guided(rlrpt::MegaParams p, const void* tris,
                                 const void* mat, const void* cdf, void* rad,
                                 void* path_sum, void* iters, void* stream) {
  const int blocks = (p.n_slots + rlrpt::kBlock - 1) / rlrpt::kBlock;
  mega_guided_kernel<<<blocks, rlrpt::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float4*>(tris), static_cast<const float*>(mat),
      static_cast<const __nv_bfloat16*>(cdf), static_cast<float*>(rad),
      static_cast<float*>(path_sum), static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}
