// Shared device code of the path-tracing kernels (mega_default.cu,
// mega_guided.cu, mega_train.cu, closest_hit.cu): the counter PRNG, the
// camera-ray generator, one exact f32 Moller-Trumbore closest-hit routine
// and its shared-memory sweep, the two hemisphere frames, the guided CDF
// sampler, and the per-slot step of the regenerative slot loop.
//
// Every formula keeps the operation order of the JAX reference
// (rlrpt_tpu/ops/megakernel.py, rlrpt_tpu/ops/guided_mega.py) and of the
// plain torch twins beside the wrappers.  Built without FMA contraction
// (_cuda.py NVCC_FLAGS), a kernel then rounds each f32 operation as its
// twin's separate torch ops do on the card, and the two frames agree bit
// for bit; against the JAX kernels on the CPU they agree to f32 rounding.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rlrpt {

constexpr float kInf = 3.0e38f;
constexpr double kPiD = 3.141592653589793;   // Python's math.pi
constexpr int kBlock = 128;       // ray slots (threads) per block
constexpr int kTileTris = 256;    // triangles per shared-memory tile

// Mirrored field for field by rlrpt_tpu_torch/_cuda.py:MegaParams.
struct MegaParams {
  uint32_t seed;
  int width, height, n_pix, spp, max_bounces, pix_mux, n_slots, n_tris;
  int russian_roulette, rr_start_bounce;
  float focal, env, eps, rr_min_prob;
  float cam_x, cam_y, cam_z, cos_yaw_y, sin_yaw_y, cos_yaw_x, sin_yaw_x;
  int n_sectors, sector_grid, uv_bins, s_pad;   // guided kernel only
  float pdf_scale, inv_gdir;                    // guided kernel only
};

// lowbias32 finalizer (megakernel.py:_hash32).  The JAX kernel runs it on
// wrapping int32 with logical shifts; uint32 is the same bits.
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// float32 uniform in [0, 1) keyed on (seed, pixel, iteration, stream):
// the top 24 bits times 2^-24 (megakernel.py:_uniform).
__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t pix,
                                          uint32_t it, uint32_t stream) {
  const uint32_t x = seed + pix * 0x9E3779B9u + it * 0x85EBCA6Bu
                     + stream * 0xC2B2AE35u;
  return static_cast<float>(hash32(x) >> 8) * (1.0f / 16777216.0f);
}

// Jittered camera ray through pixel `pix` (megakernel.py:make_primary_fn,
// ref ray.cu:145-172); the origin is the camera position.
__device__ __forceinline__ void primary_dir(const MegaParams& p, int pix,
                                            float u1, float u2, float& dx,
                                            float& dy, float& dz) {
  const int row = pix / p.width;
  const float fpy = static_cast<float>(row);
  const float fpx = static_cast<float>(pix - row * p.width);
  float x = fpx + u1 - 0.5f * static_cast<float>(p.width);
  float y = fpy + u2 - 0.5f * static_cast<float>(p.height);
  float z = p.focal;
  const float inv = rsqrtf(x * x + y * y + z * z);
  x *= inv;
  y *= inv;
  z *= inv;
  const float x1 = p.cos_yaw_y * x - p.sin_yaw_y * z;
  const float z1 = p.sin_yaw_y * x + p.cos_yaw_y * z;
  dx = x1;
  dy = p.cos_yaw_x * y + p.sin_yaw_x * z1;
  dz = -p.sin_yaw_x * y + p.cos_yaw_x * z1;
}

// Closest hit so far: distance, triangle id, and the winner's
// Moller-Trumbore numerators u' = u*det, v' = v*det and det.
struct Hit {
  float t;
  int tri;
  float up, vp, det;
};

// Exact f32 Moller-Trumbore over triangles [base, base + n) held as three
// float4 rows each (v0, e1 = v1 - v0, e2 = v2 - v0; w unused).  The sign
// tests are multiplied through by det, as the JAX kernels do (det == 0
// fails tp*det > 0), so only a valid hit pays the one division.  Strict
// `<` keeps the first-tested triangle on exact ties (ref ray.cu:17-36).
__device__ __forceinline__ void hit_tris(const float4* __restrict__ tri,
                                         int n, int base, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, Hit& h) {
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float4 v0 = tri[3 * i], e1 = tri[3 * i + 1], e2 = tri[3 * i + 2];
    const float px = dy * e2.z - dz * e2.y;
    const float py = dz * e2.x - dx * e2.z;
    const float pz = dx * e2.y - dy * e2.x;
    const float det = e1.x * px + e1.y * py + e1.z * pz;
    const float tx = ox - v0.x, ty = oy - v0.y, tz = oz - v0.z;
    const float up = tx * px + ty * py + tz * pz;
    const float qx = ty * e1.z - tz * e1.y;
    const float qy = tz * e1.x - tx * e1.z;
    const float qz = tx * e1.y - ty * e1.x;
    const float vp = dx * qx + dy * qy + dz * qz;
    const float tp = e2.x * qx + e2.y * qy + e2.z * qz;
    const float a = up * det, b = vp * det;
    if (a >= 0.f && b >= 0.f && a + b <= det * det && tp * det > 0.f) {
      const float t = tp / det;
      if (t < h.t) {
        h.t = t;
        h.tri = base + i;
        h.up = up;
        h.vp = vp;
        h.det = det;
      }
    }
  }
}

// Tangent T of the hemisphere frame rows (T, N, B) about unit normal n
// (linalg.make_frame, ref hemisphere_helpers.cu:31-63); B = N x T.
__device__ __forceinline__ void frame_tb(float nx, float ny, float nz,
                                         float& tx, float& ty, float& tz,
                                         float& bx, float& by, float& bz) {
  const bool use_x = fabsf(nx) > fabsf(ny);
  tx = use_x ? nz : 0.f;
  ty = use_x ? 0.f : -nz;
  tz = use_x ? -nx : ny;
  const float tn = rsqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-30f));
  tx *= tn;
  ty *= tn;
  tz *= tn;
  bx = ny * tz - nz * ty;
  by = nz * tx - nx * tz;
  bz = nx * ty - ny * tx;
}

// Uniform hemisphere direction about n with cos(theta) = u1
// (megakernel.py:288-309, ref hemisphere_helpers.cu:8-25, :31-63):
// world = lx*B + cos*N + lz*T.
__device__ __forceinline__ void uniform_hemisphere_dir(
    float u1, float u2, float nx, float ny, float nz, float& dx, float& dy,
    float& dz) {
  const float cost = u1;
  const float sint = sqrtf(fmaxf(1.f - u1 * u1, 0.f));
  const float phi = static_cast<float>(2.0 * kPiD) * u2;
  const float lx = sint * cosf(phi);
  const float lz = sint * sinf(phi);
  float tx, ty, tz, bx, by, bz;
  frame_tb(nx, ny, nz, tx, ty, tz, bx, by, bz);
  dx = lx * bx + cost * nx + lz * tx;
  dy = lx * by + cost * ny + lz * ty;
  dz = lx * bz + cost * nz + lz * tz;
}

// Chiu concentric map of the unit square (gx, gy) onto the hemisphere
// about n (guided_mega.py:_concentric_dir, ref hemisphere_helpers.cu:
// 134-226): world = lx*T + ly*N + lz*B; returns cos(theta) = ly.
__device__ __forceinline__ float concentric_dir(float gx, float gy, float nx,
                                                float ny, float nz, float& dx,
                                                float& dy, float& dz) {
  constexpr float kO1 = static_cast<float>(kPiD / 4.0);
  constexpr float kO2 = static_cast<float>(kPiD / 2.0);
  constexpr float kO3 = static_cast<float>(3.0 * kPiD / 4.0);
  constexpr float kO4 = static_cast<float>(kPiD);
  constexpr float kO5 = static_cast<float>(5.0 * kPiD / 4.0);
  constexpr float kO6 = static_cast<float>(3.0 * kPiD / 2.0);
  constexpr float kO7 = static_cast<float>(7.0 * kPiD / 4.0);
  const float a = 2.f * gx - 1.f;
  const float b = 2.f * gy - 1.f;
  const bool abv = b > -a, blw = b < a, pos_b = b > 0.f, pos_a = a > 0.f;
  const bool bga = b > a;
  const float xx = abv ? (blw ? a : b) : (bga ? -a : -b);
  const float yy = abv ? (blw ? (pos_b ? b : a + b) : (pos_a ? b - a : -a))
                       : (bga ? (pos_b ? -a - b : -b) : (pos_a ? a : a - b));
  const float off = abv ? (blw ? (pos_b ? 0.f : kO7) : (pos_a ? kO1 : kO2))
                        : (bga ? (pos_b ? kO3 : kO4) : (pos_a ? kO6 : kO5));
  const bool origin = xx == 0.f;
  const float safe_xx = origin ? 1.f : xx;
  const float cos_t = 1.f - xx * xx;
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  const float phi = off + kO1 * (yy / safe_xx);
  const float lx = origin ? 0.f : sin_t * cosf(phi);
  const float lz = origin ? 0.f : sin_t * sinf(phi);
  const float ly = origin ? 1.f : cos_t;
  float tx, ty, tz, bx, by, bz;
  frame_tb(nx, ny, nz, tx, ty, tz, bx, by, bz);
  dx = lx * tx + ly * nx + lz * bx;
  dy = lx * ty + ly * ny + lz * by;
  dz = lx * tz + ly * nz + lz * bz;
  return ly;
}

__device__ __forceinline__ void load_tile(float4* __restrict__ s_tri,
                                          const float4* __restrict__ tris,
                                          int first, int n) {
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    s_tri[i] = tris[3 * first + i];
}

// Closest hit of one ray per thread over all n_tris triangles, streamed
// through shared memory in tiles of kTileTris.  Every thread of the block
// calls it (the tile loads are block barriers); only `act` threads test.
// `resident`: the scene is one tile and s_tri already holds it.
__device__ __forceinline__ Hit sweep(const float4* __restrict__ tris,
                                     float4* __restrict__ s_tri, int n_tris,
                                     bool resident, bool act, float ox,
                                     float oy, float oz, float dx, float dy,
                                     float dz) {
  Hit h{kInf, -1, 0.f, 0.f, 0.f};
  const int n_tiles = (n_tris + kTileTris - 1) / kTileTris;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int first = tile * kTileTris;
    const int n = min(kTileTris, n_tris - first);
    if (!resident) {
      __syncthreads();
      load_tile(s_tri, tris, first, n);
      __syncthreads();
    }
    if (act) hit_tris(s_tri, n, first, ox, oy, oz, dx, dy, dz, h);
  }
  return h;
}

__device__ __forceinline__ void store_pixel(float* __restrict__ rad,
                                            const MegaParams& p, int k,
                                            int slot, float r, float g,
                                            float b) {
  float* o = rad + 3 * (static_cast<size_t>(k) * p.n_slots + slot);
  o[0] = r;
  o[1] = g;
  o[2] = b;
}

// Column of the binned tables for a surface hit: c = tri * uv^2 + iu * uv
// + iv, (iu, iv) the clipped bins of the winner's barycentric u = u'/det,
// v = v'/det (guided_mega.py:240-244, :347-351).
__device__ __forceinline__ int bin_column(const Hit& h, int ub) {
  const float dsafe = h.det == 0.f ? 1.f : h.det;
  const int iu = min(max(static_cast<int>(h.up / dsafe * ub), 0), ub - 1);
  const int iv = min(max(static_cast<int>(h.vp / dsafe * ub), 0), ub - 1);
  return h.tri * ub * ub + iu * ub + iv;
}

// The guided bounce (B3, and B2's path): a sector drawn from the frozen
// bf16 CDF column of the hit's bin, pdf = (hi - lo) * S / 2pi from the
// same rounded values the draw compared, the Chiu concentric map of the
// sector plus jitter.  `sector` keeps the last draw (B2's pending
// transition reads it).
struct CdfSampler {
  const __nv_bfloat16* __restrict__ cdf;   // (n_cols, s_pad), s_pad % 8 == 0
  mutable int sector;

  __device__ __forceinline__ void operator()(
      const MegaParams& p, int pix, uint32_t it1, float u1, float u2,
      const Hit& h, float nx, float ny, float nz, float& dx, float& dy,
      float& dz, float& scale) const {
    const float us = uniform01(p.seed, pix, it1, 5);   // sector draw
    const __nv_bfloat16* col =
        cdf + static_cast<size_t>(bin_column(h, p.uv_bins)) * p.s_pad;

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
    sector = min(cnt, p.n_sectors - 1);
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
    const float cost = concentric_dir(gx, gy, nx, ny, nz, dx, dy, dz);
    // throughput *= (diffuse/pi) * cos / pdf
    scale = cost / (static_cast<float>(kPiD) * pdf_safe);
  }
};

// One ray slot between steps.  Slot s owns pixels s + k*n_slots
// (k < pix_mux) and regenerates into the next sample, then the next pixel,
// the moment a path ends.
struct Slot {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;      // throughput of the current path
  float ar, ag, ab;      // current pixel's radiance sum
  float psum;            // sum of the slot's finished path lengths
  int bounce, remaining, pix, k;
  bool act;
};

__device__ __forceinline__ Slot start_slot(const MegaParams& p, int slot) {
  Slot s;
  const bool in_image = slot < p.n_slots && slot < p.n_pix;
  s.ox = p.cam_x;
  s.oy = p.cam_y;
  s.oz = p.cam_z;
  primary_dir(p, slot, uniform01(p.seed, slot, 0, 2),
              uniform01(p.seed, slot, 0, 3), s.dx, s.dy, s.dz);
  s.tr = s.tg = s.tb = 1.f;
  s.ar = s.ag = s.ab = 0.f;
  s.psum = 0.f;
  s.bounce = 0;
  s.remaining = in_image ? p.spp - 1 : 0;
  s.pix = slot;
  s.k = 0;
  s.act = in_image;
  return s;
}

// What one step did, for B2's TD update.
struct StepEvent {
  bool missed, hit_light;
  bool survive;          // the path goes on (after the bounce cap and RR)
  const float* m;        // the hit's material row (row 0 on a miss)
};

// One step of an active slot at iteration it1 (megakernel.py:_mega_kernel's
// loop body): terminal contribution, bounce cap, the bounce `sample` draws
// (next direction and throughput factor brdf*cos/pdf), optional Russian
// roulette on RNG stream 4, and regeneration.  A thread's iteration
// counter rises by one every step from 1 while the slot is active, which
// is the TPU tile's counter, so the RNG keys (seed, pix, it, stream) draw
// the TPU's samples.  `sample` has the signature
//   void sample(p, pix, it1, u1, u2, h, nx, ny, nz, dx, dy, dz, scale)
template <class Sampler>
__device__ __forceinline__ StepEvent advance(const MegaParams& p,
                                             const float* __restrict__ mat,
                                             const Sampler& sample,
                                             const Hit& h, uint32_t it1,
                                             Slot& s, float* __restrict__ rad,
                                             int slot) {
  const float u1 = uniform01(p.seed, s.pix, it1, 0);
  const float u2 = uniform01(p.seed, s.pix, it1, 1);
  const float u3 = uniform01(p.seed, s.pix, it1, 2);
  const float u4 = uniform01(p.seed, s.pix, it1, 3);

  const bool missed = h.t >= kInf;
  const float* m = mat + 16 * (missed ? 0 : h.tri);
  const bool hit_light = !missed && __ldg(m + 9) > 0.5f;
  const bool hit_surface = !missed && !hit_light;
  if (missed) {
    s.ar += s.tr * p.env;
    s.ag += s.tg * p.env;
    s.ab += s.tb * p.env;
  } else if (hit_light) {
    s.ar += s.tr * __ldg(m + 6);
    s.ag += s.tg * __ldg(m + 7);
    s.ab += s.tb * __ldg(m + 8);
  }

  const bool exhausted = hit_surface && s.bounce + 1 >= p.max_bounces;
  bool survive = hit_surface && !exhausted;
  bool rr_killed = false;
  float sdx = 0.f, sdy = 0.f, sdz = 0.f;
  if (survive) {
    float scale;
    sample(p, s.pix, it1, u1, u2, h, __ldg(m + 0), __ldg(m + 1),
           __ldg(m + 2), sdx, sdy, sdz, scale);
    s.tr = s.tr * __ldg(m + 3) * scale;
    s.tg = s.tg * __ldg(m + 4) * scale;
    s.tb = s.tb * __ldg(m + 5) * scale;
    if (p.russian_roulette && s.bounce + 1 >= p.rr_start_bounce) {
      // Unbiased kill/reweight on RNG stream 4 (megakernel.py:557-572).
      const float u5 = uniform01(p.seed, s.pix, it1, 4);
      const float p_keep =
          fminf(fmaxf(fmaxf(s.tr, fmaxf(s.tg, s.tb)), p.rr_min_prob), 1.f);
      rr_killed = u5 >= p_keep;
      if (!rr_killed) {
        const float inv_p = 1.f / p_keep;
        s.tr *= inv_p;
        s.tg *= inv_p;
        s.tb *= inv_p;
      }
      survive = !rr_killed;
    }
  }
  if (survive) {
    s.ox = s.ox + h.t * s.dx + p.eps * sdx;
    s.oy = s.oy + h.t * s.dy + p.eps * sdy;
    s.oz = s.oz + h.t * s.dz + p.eps * sdz;
    s.dx = sdx;
    s.dy = sdy;
    s.dz = sdz;
  }
  if (missed || hit_light || rr_killed)
    s.psum += static_cast<float>(s.bounce + 1);
  if (exhausted) s.psum += static_cast<float>(p.max_bounces);

  if (survive) {
    s.bounce += 1;
  } else {
    // Regeneration: the pixel's next sample, else the slot's next
    // multiplexed pixel, else the slot goes idle.
    if (s.remaining <= 0 && s.k + 1 < p.pix_mux &&
        s.pix + p.n_slots < p.n_pix) {
      store_pixel(rad, p, s.k, slot, s.ar, s.ag, s.ab);
      s.ar = s.ag = s.ab = 0.f;
      s.pix += p.n_slots;
      s.k += 1;
      s.remaining = p.spp;
    }
    if (s.remaining > 0) {
      primary_dir(p, s.pix, u3, u4, s.dx, s.dy, s.dz);
      s.ox = p.cam_x;
      s.oy = p.cam_y;
      s.oz = p.cam_z;
      s.tr = s.tg = s.tb = 1.f;
      s.bounce = 0;
      s.remaining -= 1;
    } else {
      s.act = false;
    }
  }
  return StepEvent{missed, hit_light, survive, m};
}

// The whole-frame regenerative slot loop of megakernel.py:_mega_kernel,
// one thread per ray slot, `advance` once per iteration.  A scene of one
// triangle tile is loaded once.  The loop is block-synchronous (a block
// runs until its last slot drains) so that every thread reaches the tile
// barriers.  Outputs: rad (pix_mux, n_slots, 3) per-pixel RGB sums,
// path_sum (n_slots,) and iters (n_slots,), the slot's last active
// iteration.
template <class Sampler>
__device__ __forceinline__ void run_slots(const MegaParams& p,
                                          const float4* __restrict__ tris,
                                          const float* __restrict__ mat,
                                          const Sampler& sample,
                                          float* __restrict__ rad,
                                          float* __restrict__ path_sum,
                                          int* __restrict__ iters) {
  __shared__ float4 s_tri[3 * kTileTris];
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool resident = p.n_tris <= kTileTris;
  if (resident) {
    load_tile(s_tri, tris, 0, p.n_tris);
    __syncthreads();
  }

  Slot s = start_slot(p, slot);
  uint32_t it = 0;
  while (__syncthreads_or(s.act)) {
    const Hit h = sweep(tris, s_tri, p.n_tris, resident, s.act, s.ox, s.oy,
                        s.oz, s.dx, s.dy, s.dz);
    if (!s.act) continue;
    advance(p, mat, sample, h, it + 1, s, rad, slot);
    it += 1;
  }

  if (slot >= p.n_slots) return;
  store_pixel(rad, p, s.k, slot, s.ar, s.ag, s.ab);
  for (int kk = s.k + 1; kk < p.pix_mux; ++kk)
    store_pixel(rad, p, kk, slot, 0.f, 0.f, 0.f);
  path_sum[slot] = s.psum;
  iters[slot] = static_cast<int>(it);
}

}  // namespace rlrpt

extern "C" const char* rlrpt_cuda_error_string(int err);
