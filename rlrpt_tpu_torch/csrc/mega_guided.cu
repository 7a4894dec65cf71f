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
// table (monotone or not), as the TPU kernel's comparison count is.
#include "path_common.cuh"

namespace {

struct CdfSampler {
  const __nv_bfloat16* __restrict__ cdf;   // (n_cols, s_pad), s_pad % 8 == 0

  __device__ __forceinline__ void operator()(
      const rlrpt::MegaParams& p, int pix, uint32_t it1, float u1, float u2,
      const rlrpt::Hit& h, float nx, float ny, float nz, float& dx, float& dy,
      float& dz, float& scale) const {
    const float us = rlrpt::uniform01(p.seed, pix, it1, 5);   // sector draw
    // Column c = tri * uv^2 + iu * uv + iv, (iu, iv) the clipped bins of
    // the winner's barycentric u = u'/det, v = v'/det (guided_mega.py:
    // 240-244, :347-351).
    const float dsafe = h.det == 0.f ? 1.f : h.det;
    const int ub = p.uv_bins;
    const int iu = min(max(static_cast<int>(h.up / dsafe * ub), 0), ub - 1);
    const int iv = min(max(static_cast<int>(h.vp / dsafe * ub), 0), ub - 1);
    const __nv_bfloat16* col =
        cdf + static_cast<size_t>(h.tri * ub * ub + iu * ub + iv) * p.s_pad;

    // sector = #{entries < us}, clipped to S-1; padding rows hold 2.0.
    const uint4* col4 = reinterpret_cast<const uint4*>(col);
    int cnt = 0;
    for (int j = 0; j < p.s_pad / 8; ++j) {
      const uint4 w = __ldg(col4 + j);
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        cnt += (f.x < us) + (f.y < us);
      }
    }
    const int sector = min(cnt, p.n_sectors - 1);
    // The last sector absorbs every draw >= cdf[S-2]: its probability is
    // 1 - lo (guided_mega.py:372-376).
    const float hi = sector == p.n_sectors - 1 ? 1.f
                                               : __bfloat162float(col[sector]);
    const float lo = sector > 0 ? __bfloat162float(col[sector - 1]) : 0.f;
    const float pdf = fmaxf(hi - lo, 0.f) * p.pdf_scale;
    const float pdf_safe = fmaxf(pdf, 1e-12f);

    const int sxg = sector / p.sector_grid;
    const int syg = sector - sxg * p.sector_grid;
    const float gx = (static_cast<float>(sxg) + u1) * p.inv_gdir;
    const float gy = (static_cast<float>(syg) + u2) * p.inv_gdir;
    const float cost = rlrpt::concentric_dir(gx, gy, nx, ny, nz, dx, dy, dz);
    // throughput *= (diffuse/pi) * cos / pdf
    scale = cost / (static_cast<float>(rlrpt::kPiD) * pdf_safe);
  }
};

__global__ void __launch_bounds__(rlrpt::kBlock)
    mega_guided_kernel(rlrpt::MegaParams p, const float4* __restrict__ tris,
                       const float* __restrict__ mat,
                       const __nv_bfloat16* __restrict__ cdf,
                       float* __restrict__ rad, float* __restrict__ path_sum,
                       int* __restrict__ iters) {
  rlrpt::run_slots(p, tris, mat, CdfSampler{cdf}, rad, path_sum, iters);
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
