// Shared device code of the path-tracing kernels (mega_default.cu,
// mega_guided.cu, mega_train.cu, closest_hit.cu): the counter PRNG, the
// camera-ray generator, one exact f32 Moller-Trumbore closest-hit routine,
// its shared-memory sweep and its variant over a BVH leaf, the BVH walk
// (B4, the culled B1), the two hemisphere frames, the guided CDF sampler
// and B3's two ablated samplers, the per-slot step of the regenerative
// slot loop, and that loop on a persistent, work-pulling grid over the
// sweep (B1, B3) or the walk (the culled B1).
//
// Every formula keeps the operation order of the JAX reference
// (rlrpt_tpu/ops/megakernel.py, rlrpt_tpu/ops/guided_mega.py) and of the
// plain torch twins beside the wrappers.  Built without FMA contraction
// (_cuda.py NVCC_FLAGS), a kernel then rounds each f32 operation as its
// twin's separate torch ops do on the card, and the two frames agree bit
// for bit; against the JAX kernels on the CPU they agree to f32 rounding.
#pragma once

#include <algorithm>
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

// hit_tris over positions [first, first + n) of a permuted triangle table
// (a BVH leaf, ops/bvh.py): the same operations in the same order, so each
// (ray, triangle) pair gives hit_tris's t bits; h.tri is the original
// index order[i].  An equal t goes to the lower original index, the one
// hit_tris keeps with its strict `<` when it sweeps in index order.
__device__ __forceinline__ void hit_tris_mapped(
    const float4* __restrict__ tri, const int* __restrict__ order, int first,
    int n, float ox, float oy, float oz, float dx, float dy, float dz,
    Hit& h) {
  for (int i = first; i < first + n; ++i) {
    const float4 v0 = __ldg(tri + 3 * i), e1 = __ldg(tri + 3 * i + 1),
                 e2 = __ldg(tri + 3 * i + 2);
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
      const int orig = __ldg(order + i);
      if (t < h.t || (t == h.t && orig < h.tri)) {
        h.t = t;
        h.tri = orig;
        h.up = up;
        h.vp = vp;
        h.det = det;
      }
    }
  }
}

// ---- the BVH walk (B4a-c, culled B1) --------------------------------------
// The hierarchy's layout and link encoding are ops/bvh.py's.  Each thread
// walks one ray, nearer child first, with its own stack of (link, near)
// entries, and skips a box only when its near distance is above the best
// t so far or its far one below 0, on the robust slab test of Ize (JCGT
// 2013: the far distance scaled by 1 + 2 gamma_3; zero direction
// components clamped as rlrpt_tpu/ops/megakernel.py:424-428).  Leaves run
// hit_tris_mapped, so the answer is the brute-force sweep's bit for bit.

constexpr int kTopNodes = 256;   // inner nodes kept in shared memory
constexpr int kStack = 64;       // per-thread stack (ops/bvh.py STACK)
constexpr int kEmpty = -1;       // the link of no child (ops/bvh.py EMPTY)
constexpr float kTiny = 1e-30f;  // ops/bvh.py TINY
// 1 + 2 gamma_3, gamma_n = n u / (1 - n u), u = 2^-24 (ops/bvh.py FAR_SCALE)
constexpr float kFarScale = static_cast<float>(
    1.0 + 2.0 * (3.0 * 0x1p-24) / (1.0 - 3.0 * 0x1p-24));

struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
};

// Slab test of box [lo, hi]; returns near and sets far (ops/bvh.py:_slab,
// the same operations; its min and max of three are exact in any order).
__device__ __forceinline__ float box_near(const float4 lo, const float4 hi,
                                          const Ray& r, float& far) {
  const float t1x = (lo.x - r.ox) * r.ivx, t2x = (hi.x - r.ox) * r.ivx;
  const float t1y = (lo.y - r.oy) * r.ivy, t2y = (hi.y - r.oy) * r.ivy;
  const float t1z = (lo.z - r.oz) * r.ivz, t2z = (hi.z - r.oz) * r.ivz;
  far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z)) *
        kFarScale;
  return fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
}

// Pops the next stacked link whose near distance is within t into link;
// false when none is left.
__device__ __forceinline__ bool pop(const int* st_link, const float* st_near,
                                    int& sp, float t, int& link) {
  while (sp > 0) {
    --sp;
    if (st_near[sp] <= t) {
      link = st_link[sp];
      return true;
    }
  }
  return false;
}

// What a walk did, for a count-only build (walk<true>): inner nodes
// visited (two box tests each) and ray-triangle tests, the counts that
// ops/bvh.py:closest_hit_bvh_plain returns; and the warp's side of it:
// each step (a node visit or a leaf's tests) counts once for the warp, in
// its lowest active lane, with the lanes that take it together
// (__activemask), so lanes / (32 warp_steps) is the walk's SIMT
// efficiency.
struct WalkCount {
  uint32_t visits, tests;
  unsigned long long warp_steps, lanes;
};

__device__ __forceinline__ void count_warp_step(WalkCount* count) {
  const unsigned mask = __activemask();
  if ((threadIdx.x & 31) == __ffs(mask) - 1) {
    count->warp_steps += 1;
    count->lanes += __popc(mask);
  }
}

// The closest hit of one ray: the walk of ops/bvh.py:closest_hit_bvh_plain.
// While-while order (Aila and Laine, HPG 2009): a lane steps through inner
// nodes until it holds a leaf, and only then tests triangles, so the lanes
// of a warp test their leaves together; each lane's own sequence of
// visits is the plain walk's.  walk<true> also adds its visits and tests
// to *count; walk<false> (the default) compiles the counting out.
template <bool kCount = false>
__device__ __forceinline__ Hit walk(
    const float4* __restrict__ s_nodes, int n_top,
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const int* __restrict__ order, float ox, float oy, float oz, float dx,
    float dy, float dz, WalkCount* count = nullptr) {
  Ray r{ox, oy, oz, dx, dy, dz, 0.f, 0.f, 0.f};
  r.ivx = 1.f / (fabsf(dx) < kTiny ? kTiny : dx);
  r.ivy = 1.f / (fabsf(dy) < kTiny ? kTiny : dy);
  r.ivz = 1.f / (fabsf(dz) < kTiny ? kTiny : dz);
  Hit h{kInf, -1, 0.f, 0.f, 0.f};
  int st_link[kStack];
  float st_near[kStack];
  int sp = 0;
  int link = 0;   // the root
  while (true) {
    while (link >= 0) {
      float4 a, b, c, e;
      if (link < n_top) {
        const float4* p = s_nodes + 4 * link;
        a = p[0];
        b = p[1];
        c = p[2];
        e = p[3];
      } else {
        const float4* p = nodes + 4 * static_cast<size_t>(link);
        a = __ldg(p);
        b = __ldg(p + 1);
        c = __ldg(p + 2);
        e = __ldg(p + 3);
      }
      if constexpr (kCount) {
        ++count->visits;
        count_warp_step(count);
      }
      const int ll = __float_as_int(a.w), lr = __float_as_int(c.w);
      float fl, fr;
      const float nl = box_near(a, b, r, fl), nr = box_near(c, e, r, fr);
      const bool ok_l = ll != kEmpty && nl <= fl && fl >= 0.f && nl <= h.t;
      const bool ok_r = lr != kEmpty && nr <= fr && fr >= 0.f && nr <= h.t;
      if (ok_l && ok_r) {
        const bool r_first = nr < nl;
        st_link[sp] = r_first ? ll : lr;
        st_near[sp] = r_first ? nl : nr;
        ++sp;
        link = r_first ? lr : ll;
      } else if (ok_l || ok_r) {
        link = ok_l ? ll : lr;
      } else if (!pop(st_link, st_near, sp, h.t, link)) {
        return h;
      }
    }
    const int code = ~link;
    if constexpr (kCount) {
      count->tests += code & 7;
      count_warp_step(count);
    }
    hit_tris_mapped(tris, order, code >> 3, code & 7, ox, oy, oz, dx, dy,
                    dz, h);
    if (!pop(st_link, st_near, sp, h.t, link)) return h;
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

// Entry i of a bf16 column as f32 (exact: a bf16 is the top half of an f32).
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* col, int i) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(col) + i);
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// The direction and throughput factor of a guided bounce into `sector` at
// probability density `pdf`: the Chiu concentric map of the sector's cell
// plus the jitter (u1, u2), and scale = (diffuse/pi) * cos / pdf.
__device__ __forceinline__ void sector_bounce(const MegaParams& p,
                                              int sector, float pdf,
                                              float u1, float u2, float nx,
                                              float ny, float nz, float& dx,
                                              float& dy, float& dz,
                                              float& scale) {
  const float pdf_safe = fmaxf(pdf, 1e-12f);
  const int sxg = sector / p.sector_grid;
  const int syg = sector - sxg * p.sector_grid;
  const float gx = (static_cast<float>(sxg) + u1) * p.inv_gdir;
  const float gy = (static_cast<float>(syg) + u2) * p.inv_gdir;
  const float cost = concentric_dir(gx, gy, nx, ny, nz, dx, dy, dz);
  // throughput *= (diffuse/pi) * cos / pdf
  scale = cost / (static_cast<float>(kPiD) * pdf_safe);
}

// The guided bounce (B3, and B2's path): a sector drawn from the frozen
// bf16 CDF column of the hit's bin, pdf = (hi - lo) * S / 2pi from the
// same rounded values the draw compared, the Chiu concentric map of the
// sector plus jitter.  `sector` keeps the last draw (B2's pending
// transition reads it).
struct CdfSampler {
  const __nv_bfloat16* __restrict__ cdf;   // (n_cols, s_pad), non-decreasing
  mutable int sector;

  __device__ __forceinline__ void operator()(
      const MegaParams& p, int pix, uint32_t it1, float u1, float u2,
      const Hit& h, float nx, float ny, float nz, float& dx, float& dy,
      float& dz, float& scale) const {
    const float us = uniform01(p.seed, pix, it1, 5);   // sector draw
    const __nv_bfloat16* col =
        cdf + static_cast<size_t>(bin_column(h, p.uv_bins)) * p.s_pad;

    // sector = #{entries < us}, clipped to S-1 (the twin's count).  In a
    // non-decreasing column (check_cdf) that is the lower bound of us
    // among entries [0, S-1), ties and flat runs included: a binary
    // search of about log2(S) probes.
    int lo_i = 0;
    for (int n = p.n_sectors - 1; n > 0;) {
      const int half = n >> 1;
      if (bf16_at(col, lo_i + half) < us) {
        lo_i += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    sector = lo_i;
    // The last sector absorbs every draw >= cdf[S-2]: its probability is
    // 1 - lo (guided_mega.py:372-376).
    const float hi = sector == p.n_sectors - 1 ? 1.f : bf16_at(col, sector);
    const float lo = sector > 0 ? bf16_at(col, sector - 1) : 0.f;
    const float pdf = fmaxf(hi - lo, 0.f) * p.pdf_scale;
    sector_bounce(p, sector, pdf, u1, u2, nx, ny, nz, dx, dy, dz, scale);
  }
};

// B3's perf-attribution samplers, render_guided_mega(ablate=...)
// (guided_mega.py:340-370): the uniforms of CdfSampler, but the sector is
// drawn uniformly, min(floor(us * S), S - 1), at the uniform pdf
// 1/S * S/2pi, and no search is made.  kFetch ("fetch") also locates the
// hit's bin column and reads its first entry, folded into the sector as
// JAX folds row[0] * 1e-30: always 0 after truncation, but a load the
// compiler must issue.  kFetch false ("uniform") reads no table.  The
// images are wrong by design; the kernels time the guided sampler's share
// of B3 by difference.
template <bool kFetch>
struct AblateSampler {
  const __nv_bfloat16* __restrict__ cdf;   // (n_cols, s_pad)

  __device__ __forceinline__ void operator()(
      const MegaParams& p, int pix, uint32_t it1, float u1, float u2,
      const Hit& h, float nx, float ny, float nz, float& dx, float& dy,
      float& dz, float& scale) const {
    const float us = uniform01(p.seed, pix, it1, 5);   // sector draw
    int touch = 0;
    if constexpr (kFetch) {
      const __nv_bfloat16* col =
          cdf + static_cast<size_t>(bin_column(h, p.uv_bins)) * p.s_pad;
      touch = static_cast<int>(bf16_at(col, 0) * 1e-30f);
    }
    const int sector =
        min(static_cast<int>(us * static_cast<float>(p.n_sectors)) + touch,
            p.n_sectors - 1);
    const float pdf = (1.f / static_cast<float>(p.n_sectors)) * p.pdf_scale;
    sector_bounce(p, sector, pdf, u1, u2, nx, ny, nz, dx, dy, dz, scale);
  }
};

// One ray slot between steps.  Slot s owns pixels s + k*n_slots
// (k < pix_mux) and regenerates into the next sample, then the next pixel,
// the moment a path ends.  Its pixel and path-length sums are kept by the
// caller (run_slots in registers, B2 in device memory).
struct Slot {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;      // throughput of the current path
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
  s.bounce = 0;
  s.remaining = in_image ? p.spp - 1 : 0;
  s.pix = slot;
  s.k = 0;
  s.act = in_image;
  return s;
}

// What one step did: for the caller's pixel and path-length sums, and for
// B2's TD update.  A step that ends a path on a miss or a light adds
// (cr, cg, cb) to the pixel the slot held at the step's start (k_old);
// a step that ends a path adds plen to the slot's path-length sum.
struct StepEvent {
  bool missed, hit_light;
  bool survive;          // the path goes on (after the bounce cap and RR)
  bool new_pixel;        // the slot moved on to its next multiplexed pixel
  int k_old;             // the slot's pixel index k at the step's start
  int bounce_old;        // the path's bounce at the step's start
  float cr, cg, cb;      // terminal contribution (0 on a surface hit)
  float plen;            // the ended path's length
  const float* m;        // the hit's material row (row 0 on a miss)
};

// One step of an active slot at iteration it1 (megakernel.py:_mega_kernel's
// loop body): terminal contribution, bounce cap, the bounce `sample` draws
// (next direction and throughput factor brdf*cos/pdf), optional Russian
// roulette on RNG stream 4, and regeneration.  A slot's iteration counter
// rises by one every step from 1 while the slot is active, which is the
// TPU tile's counter, so the RNG keys (seed, pix, it, stream) draw the
// TPU's samples, whichever thread steps the slot and in whatever order.
// The pixel sums are the caller's (StepEvent).  `sample` has the signature
//   void sample(p, pix, it1, u1, u2, h, nx, ny, nz, dx, dy, dz, scale)
template <class Sampler>
__device__ __forceinline__ StepEvent advance(const MegaParams& p,
                                             const float* __restrict__ mat,
                                             const Sampler& sample,
                                             const Hit& h, uint32_t it1,
                                             Slot& s) {
  const float u1 = uniform01(p.seed, s.pix, it1, 0);
  const float u2 = uniform01(p.seed, s.pix, it1, 1);
  const float u3 = uniform01(p.seed, s.pix, it1, 2);
  const float u4 = uniform01(p.seed, s.pix, it1, 3);

  const bool missed = h.t >= kInf;
  const float* m = mat + 16 * (missed ? 0 : h.tri);
  const bool hit_light = !missed && __ldg(m + 9) > 0.5f;
  const bool hit_surface = !missed && !hit_light;
  StepEvent ev;
  ev.k_old = s.k;
  ev.bounce_old = s.bounce;
  ev.cr = ev.cg = ev.cb = 0.f;
  if (missed) {
    ev.cr = s.tr * p.env;
    ev.cg = s.tg * p.env;
    ev.cb = s.tb * p.env;
  } else if (hit_light) {
    ev.cr = s.tr * __ldg(m + 6);
    ev.cg = s.tg * __ldg(m + 7);
    ev.cb = s.tb * __ldg(m + 8);
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
  ev.missed = missed;
  ev.hit_light = hit_light;
  ev.survive = survive;
  ev.plen = exhausted ? static_cast<float>(p.max_bounces)
                      : static_cast<float>(s.bounce + 1);
  ev.new_pixel = false;
  ev.m = m;

  if (survive) {
    s.bounce += 1;
  } else {
    // Regeneration: the pixel's next sample, else the slot's next
    // multiplexed pixel, else the slot goes idle.
    if (s.remaining <= 0 && s.k + 1 < p.pix_mux &&
        s.pix + p.n_slots < p.n_pix) {
      ev.new_pixel = true;
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
  return ev;
}

// Lanes of this warp below the calling lane.
__device__ __forceinline__ uint32_t lanes_below() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The closest hit of slot_loop by the brute-force sweep: every thread of
// the block takes part in every call (the tile loads are block barriers),
// so the loop's condition is block-wide and idle threads still reach the
// barriers.  `resident`: the scene is one tile, loaded once.
struct SweepHits {
  const float4* __restrict__ tris;
  float4* __restrict__ s_tri;
  int n_tris;
  bool resident;

  __device__ __forceinline__ bool more(bool have) const {
    return __syncthreads_or(have);
  }
  __device__ __forceinline__ Hit operator()(bool act, const Slot& s) const {
    return sweep(tris, s_tri, n_tris, resident, act, s.ox, s.oy, s.oz, s.dx,
                 s.dy, s.dz);
  }
};

// The closest hit of slot_loop by the BVH walk (the culled B1): only `act`
// lanes walk, each on its own.  No barrier follows the load of the top
// nodes, so the loop's condition is per warp (its refill is warp-wide): a
// block-wide one would hold every warp at each iteration until the
// block's longest walk ended, and walks differ 8-9x in length.  With
// kCount each thread keeps its walks' WalkCount.
template <bool kCount>
struct WalkHits {
  const float4* __restrict__ s_nodes;   // the top n_top inner nodes
  int n_top;
  const float4* __restrict__ nodes;
  const float4* __restrict__ tris;      // in the tree's leaf order
  const int* __restrict__ order;
  WalkCount count;

  __device__ __forceinline__ bool more(bool have) const {
    return __any_sync(0xffffffffu, have);
  }
  __device__ __forceinline__ Hit operator()(bool act, const Slot& s) {
    if (!act) return Hit{kInf, -1, 0.f, 0.f, 0.f};
    return walk<kCount>(s_nodes, n_top, nodes, tris, order, s.ox, s.oy,
                        s.oz, s.dx, s.dy, s.dz, &count);
  }
};

// The whole-frame regenerative slot loop of megakernel.py:_mega_kernel on
// a persistent grid (slot_grid): a thread runs one slot at a time from
// start_slot to its end, `advance` once per iteration on the slot's own
// iteration counter, and then pulls the next unstarted slot.  The first
// slot of a thread is its global index; later ones come from the device
// counter `next` (zero at launch), one atomicAdd per warp per refill, each
// lane taking base + its rank among the lanes that asked.  Every output
// belongs to one slot and every RNG key to (slot's pixel, slot's
// iteration), so the order in which slots run changes no bit of the frame.
// `hits` (SweepHits, WalkHits) gives each iteration's closest hit and the
// loop's condition; the hit is all that differs between a sweep and a
// walk, and the walk returns the sweep's hit.  Outputs: rad (pix_mux,
// n_slots, 3) per-pixel RGB sums, path_sum (n_slots,) and iters
// (n_slots,), the slot's count of active iterations.
template <class Sampler, class Hits>
__device__ __forceinline__ void slot_loop(const MegaParams& p,
                                          const float* __restrict__ mat,
                                          const Sampler& sample, Hits& hits,
                                          float* __restrict__ rad,
                                          float* __restrict__ path_sum,
                                          int* __restrict__ iters,
                                          int* __restrict__ next) {
  const int first_pulled = gridDim.x * blockDim.x;
  int slot = blockIdx.x * blockDim.x + threadIdx.x;
  bool have = slot < p.n_slots;
  bool drained = !have;   // the counter has run past n_slots for this lane
  Slot s{};
  if (have) s = start_slot(p, slot);
  float ar = 0.f, ag = 0.f, ab = 0.f, psum = 0.f;
  uint32_t it = 0;
  while (hits.more(have)) {
    const Hit h = hits(have && s.act, s);
    if (have) {
      if (s.act) {
        it += 1;
        const StepEvent ev = advance(p, mat, sample, h, it, s);
        if (ev.missed || ev.hit_light) {
          ar += ev.cr;
          ag += ev.cg;
          ab += ev.cb;
        }
        if (!ev.survive) psum += ev.plen;
        if (ev.new_pixel) {
          store_pixel(rad, p, ev.k_old, slot, ar, ag, ab);
          ar = ag = ab = 0.f;
        }
      }
      if (!s.act) {   // the slot is done (or was never in the image)
        store_pixel(rad, p, s.k, slot, ar, ag, ab);
        for (int kk = s.k + 1; kk < p.pix_mux; ++kk)
          store_pixel(rad, p, kk, slot, 0.f, 0.f, 0.f);
        path_sum[slot] = psum;
        iters[slot] = static_cast<int>(it);
        have = false;
      }
    }
    // Refill: one atomic per warp for the lanes that need a slot.
    const bool need = !have && !drained;
    const uint32_t want = __ballot_sync(0xffffffffu, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if ((threadIdx.x & 31) == leader) base = atomicAdd(next, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) {
        slot = first_pulled + base + __popc(want & lanes_below());
        if (slot < p.n_slots) {
          s = start_slot(p, slot);
          ar = ag = ab = psum = 0.f;
          it = 0;
          have = true;
        } else {
          drained = true;
        }
      }
    }
  }
}


// slot_loop over the brute-force sweep of tris (n_tris, 12) in index
// order (B1, B3).
template <class Sampler>
__device__ __forceinline__ void run_slots(const MegaParams& p,
                                          const float4* __restrict__ tris,
                                          const float* __restrict__ mat,
                                          const Sampler& sample,
                                          float* __restrict__ rad,
                                          float* __restrict__ path_sum,
                                          int* __restrict__ iters,
                                          int* __restrict__ next) {
  __shared__ float4 s_tri[3 * kTileTris];
  SweepHits hits{tris, s_tri, p.n_tris, p.n_tris <= kTileTris};
  if (hits.resident) {
    load_tile(s_tri, tris, 0, p.n_tris);
    __syncthreads();
  }
  slot_loop(p, mat, sample, hits, rad, path_sum, iters, next);
}

// slot_loop over the walk of ops/bvh.py's tree (the culled B1): nodes
// (n_nodes, 16), tris (n_tris, 12) in its leaf order and order (n_tris,);
// the top min(n_nodes, kTopNodes) nodes are copied into s_nodes (dynamic
// shared memory of that size) once per block.  With kCount the walks'
// visits, tests, warp steps and active lanes are added to counts[0..3].
template <bool kCount, class Sampler>
__device__ __forceinline__ void run_slots_walk(
    const MegaParams& p, float4* __restrict__ s_nodes, int n_nodes,
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const int* __restrict__ order, const float* __restrict__ mat,
    const Sampler& sample, float* __restrict__ rad,
    float* __restrict__ path_sum, int* __restrict__ iters,
    int* __restrict__ next, unsigned long long* __restrict__ counts) {
  const int n_top = min(n_nodes, kTopNodes);
  for (int j = threadIdx.x; j < 4 * n_top; j += blockDim.x)
    s_nodes[j] = __ldg(nodes + j);
  __syncthreads();
  WalkHits<kCount> hits{s_nodes, n_top, nodes, tris, order,
                        {0u, 0u, 0ull, 0ull}};
  slot_loop(p, mat, sample, hits, rad, path_sum, iters, next);
  if constexpr (kCount) {
    atomicAdd(counts, static_cast<unsigned long long>(hits.count.visits));
    atomicAdd(counts + 1, static_cast<unsigned long long>(hits.count.tests));
    atomicAdd(counts + 2, hits.count.warp_steps);
    atomicAdd(counts + 3, hits.count.lanes);
  }
}

// The grid of run_slots: as many blocks of `block` threads as fit on the
// card at once (occupancy x SMs), and no more than the slots need.
// Returns a CUDA error, or 0.
template <class Kernel>
inline int slot_grid(Kernel kernel, int n_slots, int block, size_t smem,
                     int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block, smem));
  if (err != 0) return err;
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = std::min(per_sm * sms, std::max(1, (n_slots + block - 1) / block));
  return 0;
}

}  // namespace rlrpt

extern "C" const char* rlrpt_cuda_error_string(int err);
