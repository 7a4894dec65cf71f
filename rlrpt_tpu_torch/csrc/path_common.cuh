// Shared device code of the path-tracing megakernels (mega_default.cu,
// mega_guided.cu): the counter PRNG, the camera-ray generator, one exact
// f32 Moller-Trumbore closest-hit routine, the two hemisphere frames, and
// the regenerative slot loop both kernels run.
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

__device__ __forceinline__ void store_pixel(float* __restrict__ rad,
                                            const MegaParams& p, int k,
                                            int slot, float r, float g,
                                            float b) {
  float* o = rad + 3 * (static_cast<size_t>(k) * p.n_slots + slot);
  o[0] = r;
  o[1] = g;
  o[2] = b;
}

// The whole-frame regenerative slot loop of megakernel.py:_mega_kernel,
// one thread per ray slot.  Slot s owns pixels s + k*n_slots
// (k < pix_mux) and regenerates into the next sample, then the next pixel,
// the moment a path ends.  A thread's iteration counter `it` rises by one
// every step from 1 while the slot is active, which is the TPU tile's
// counter, so the RNG keys (seed, pix, it, stream) draw the TPU's samples.
//
// Triangles stream through shared memory in tiles of kTileTris; a scene of
// one tile is loaded once.  The loop is block-synchronous (a block runs
// until its last slot drains) so that every thread reaches the tile
// barriers.  `sample` turns a surface hit into the next direction and the
// throughput factor brdf*cos/pdf:
//   void sample(p, pix, it1, u1, u2, h, nx, ny, nz, dx, dy, dz, scale)
// Outputs: rad (pix_mux, n_slots, 3) per-pixel RGB sums, path_sum
// (n_slots,) and iters (n_slots,), the slot's last active iteration.
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
  const int n_tiles = (p.n_tris + kTileTris - 1) / kTileTris;
  if (n_tiles == 1) {
    load_tile(s_tri, tris, 0, p.n_tris);
    __syncthreads();
  }

  const bool valid = slot < p.n_slots;
  const bool in_image = valid && slot < p.n_pix;
  float ox = p.cam_x, oy = p.cam_y, oz = p.cam_z, dx, dy, dz;
  primary_dir(p, slot, uniform01(p.seed, slot, 0, 2),
              uniform01(p.seed, slot, 0, 3), dx, dy, dz);
  float tr = 1.f, tg = 1.f, tb = 1.f, psum = 0.f;
  float ar = 0.f, ag = 0.f, ab = 0.f;   // current pixel's radiance sum
  int bounce = 0, remaining = in_image ? p.spp - 1 : 0, pix = slot, k = 0;
  bool act = in_image;
  uint32_t it = 0;

  while (__syncthreads_or(act)) {
    Hit h{kInf, -1, 0.f, 0.f, 0.f};
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int first = tile * kTileTris;
      const int n = min(kTileTris, p.n_tris - first);
      if (n_tiles > 1) {
        __syncthreads();
        load_tile(s_tri, tris, first, n);
        __syncthreads();
      }
      if (act) hit_tris(s_tri, n, first, ox, oy, oz, dx, dy, dz, h);
    }
    if (!act) continue;

    const uint32_t it1 = it + 1;
    const float u1 = uniform01(p.seed, pix, it1, 0);
    const float u2 = uniform01(p.seed, pix, it1, 1);
    const float u3 = uniform01(p.seed, pix, it1, 2);
    const float u4 = uniform01(p.seed, pix, it1, 3);

    const bool missed = h.t >= kInf;
    const float* m = mat + 16 * (missed ? 0 : h.tri);
    const bool hit_light = !missed && __ldg(m + 9) > 0.5f;
    const bool hit_surface = !missed && !hit_light;
    if (missed) {
      ar += tr * p.env;
      ag += tg * p.env;
      ab += tb * p.env;
    } else if (hit_light) {
      ar += tr * __ldg(m + 6);
      ag += tg * __ldg(m + 7);
      ab += tb * __ldg(m + 8);
    }

    const bool exhausted = hit_surface && bounce + 1 >= p.max_bounces;
    bool survive = hit_surface && !exhausted;
    bool rr_killed = false;
    float sdx = 0.f, sdy = 0.f, sdz = 0.f;
    if (survive) {
      float scale;
      sample(p, pix, it1, u1, u2, h, __ldg(m + 0), __ldg(m + 1),
             __ldg(m + 2), sdx, sdy, sdz, scale);
      tr = tr * __ldg(m + 3) * scale;
      tg = tg * __ldg(m + 4) * scale;
      tb = tb * __ldg(m + 5) * scale;
      if (p.russian_roulette && bounce + 1 >= p.rr_start_bounce) {
        // Unbiased kill/reweight on RNG stream 4 (megakernel.py:557-572).
        const float u5 = uniform01(p.seed, pix, it1, 4);
        const float p_keep =
            fminf(fmaxf(fmaxf(tr, fmaxf(tg, tb)), p.rr_min_prob), 1.f);
        rr_killed = u5 >= p_keep;
        if (!rr_killed) {
          const float inv_p = 1.f / p_keep;
          tr *= inv_p;
          tg *= inv_p;
          tb *= inv_p;
        }
        survive = !rr_killed;
      }
    }
    if (survive) {
      ox = ox + h.t * dx + p.eps * sdx;
      oy = oy + h.t * dy + p.eps * sdy;
      oz = oz + h.t * dz + p.eps * sdz;
      dx = sdx;
      dy = sdy;
      dz = sdz;
    }
    if (missed || hit_light || rr_killed)
      psum += static_cast<float>(bounce + 1);
    if (exhausted) psum += static_cast<float>(p.max_bounces);

    if (survive) {
      bounce += 1;
    } else {
      // Regeneration: the pixel's next sample, else the slot's next
      // multiplexed pixel, else the slot goes idle.
      if (remaining <= 0 && k + 1 < p.pix_mux && pix + p.n_slots < p.n_pix) {
        store_pixel(rad, p, k, slot, ar, ag, ab);
        ar = ag = ab = 0.f;
        pix += p.n_slots;
        k += 1;
        remaining = p.spp;
      }
      if (remaining > 0) {
        primary_dir(p, pix, u3, u4, dx, dy, dz);
        ox = p.cam_x;
        oy = p.cam_y;
        oz = p.cam_z;
        tr = tg = tb = 1.f;
        bounce = 0;
        remaining -= 1;
      } else {
        act = false;
      }
    }
    it = it1;
  }

  if (!valid) return;
  store_pixel(rad, p, k, slot, ar, ag, ab);
  for (int kk = k + 1; kk < p.pix_mux; ++kk)
    store_pixel(rad, p, kk, slot, 0.f, 0.f, 0.f);
  path_sum[slot] = psum;
  iters[slot] = static_cast<int>(it);
}

}  // namespace rlrpt

extern "C" const char* rlrpt_cuda_error_string(int err);
