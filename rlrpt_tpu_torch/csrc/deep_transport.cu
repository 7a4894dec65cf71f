// The deep-Q wavefront's sample-and-transport, one launch a step, for Hopper
// (sm_90a): the `.sample` and `.transport` stages of
// deep/deep_wavefront.py:trace_frame_deep_wavefront.  For each lane: the
// radiance a miss or a light adds, the lane's epsilon, the next sector from
// Q * cos (or a random one), its jittered direction and pdf, the bounce cap,
// the throughput and optional Russian roulette, the banking of a finished
// sample into the slot's row, and regeneration (the pixel's next sample, or
// the slot's next pixel, with a jittered camera ray).
//
// Replaces no TPU kernel: the JAX package leaves these stages to XLA, which
// fuses them.  On the card they were ~220 small torch kernels and ~290 host
// calls a step, and in the narrow phases of a frame the host's issue of them
// set the pace (PERF.md).
//
// What bounds it on this card: bytes.  A lane reads ~0.83 KB (at 144 sectors
// its 576-byte Q row, the slot state, its pix_mux banked rows, the hit's
// material row, the uniforms) and writes ~0.16 KB, at a few flops a byte.
//
// What the design does about it: one thread a lane, and each Q row is read
// from device memory once.  A block's rows lie next to each other, so the
// block stages them into shared memory with coalesced 16-byte loads, at an
// odd row stride, so that the threads' walks along their own rows fall on
// distinct banks; each thread then makes two passes over its row there (the
// total, then the inverse-CDF count).  The four statistics are sums of whole
// numbers, reduced in the block and added with one atomic each, so their
// order does not matter.
//
// Arithmetic: the twin's f32 operations in the twin's order (the twin is
// ops/deep_transport.py:sample_transport_plain), built without FMA
// contraction (_cuda.py), and with what torch's kernels do on the card: a
// sum or a norm over 3 is (x0 + x2) + x1, and a mean over 3 that sum times
// f32(1/3); the Q row's total follows ATen's reduce kernel (row_total), and
// its CDF ATen's scan kernel (cdf_count), so the sector is the twin's; a
// division by a host scalar is a product with its f32 reciprocal; a cross
// product's a*b - c*d is fma(a, b, -(c*d)).
#include <cstdint>
#include <cuda_runtime.h>

namespace rlrpt_deep {

// Mirrored field for field by ops/deep_transport.py:DeepParams (4-byte
// fields only, so no padding to disagree on).
struct DeepParams {
  int n_lanes, n_sectors, grid, n_surfaces;
  int w0, n_pix, pix_end, pix_mux, spp, width;
  int max_bounces, russian_roulette, rr_start_bounce, train, scan_levels;
  float env, ray_eps, rr_min_prob, throughput_threshold;
  float eps0, eps_decay, eps_min;
  float rho, inv_grid_rho, inv_sectors, inv_pi, inv_grid;
  float half_width, half_height, focal;
  float cam_x, cam_y, cam_z, cos_yaw_y, sin_yaw_y, cos_yaw_x, sin_yaw_x;
};

// A slot state's fields (deep_wavefront._State), in its order; the input
// state is only read.
struct SlotState {
  float* o;
  float* d;
  float* tp;
  int64_t* pixel;
  int64_t* kmx;
  int* bounce;
  int* remaining;
  int* sord;
  bool* active;
  float* sample_rad;
  float* slot_rad;
  float* prev_loc;
  int64_t* action;
};

struct StepInputs {
  const float* t;
  const int* tri;
  const float* mrow;    // (W, 16): normal 0-2, diffuse 3-5, emission 6-8
  const float* qpos;
  const float* qs;      // (W, S)
  const float* u;       // (W, 5)
  const float* u_rr;    // (W,), or null without Russian roulette
  const float* u_pix;   // (W, 2)
  const float* cos;     // (S,)
};

struct StepOutputs {
  int64_t* sector;
  float* pdf;
  double* path_sum;
  double* light_path_sum;
  unsigned long long* zclp;
  unsigned long long* light_hits;
};

constexpr int kBlock = 128;          // lanes (threads) a block
constexpr int kWarps = kBlock / 32;
constexpr float kInfCut = 1.0e38f;   // integrators/sarsa_wavefront.py INF_CUT
constexpr double kPiD = 3.141592653589793;   // Python's math.pi

// torch.sum (and linalg.norm's sum of squares) over a last dimension of 3 on
// the card: lanes 0 and 1 of ATen's reduce kernel hold x0 + x2 and x1.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

// The row's total of w_k = q_k * cos_k in the association of torch's sum
// over a contiguous last dimension on the card (ATen/native/cuda/Reduce.cuh):
// bw lanes, the largest power of two up to min(n, 32), where n is S, or S / 4
// from S = 128 on (16-byte aligned rows are loaded 4 at a time); each lane
// sums its elements into 4 accumulators, adds those in order, and the lanes
// meet in a warp shuffle of halving offsets.  Exact where S is below 128 or a
// multiple of 4 (ATen starts a misaligned row on a shifted lane).
__device__ __forceinline__ float row_total(const float* __restrict__ q,
                                           const float* __restrict__ cs,
                                           int S) {
  const bool vec = S >= 128 && S % 4 == 0;
  const int n = vec ? S / 4 : S;
  int bw = 1;
  while (bw * 2 <= min(n, 32)) bw *= 2;
  float lane[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (x < bw) {
      if (vec) {
        for (int j = 4 * x; j < S; j += 4 * bw) {
          a0 = a0 + q[j] * cs[j];
          a1 = a1 + q[j + 1] * cs[j + 1];
          a2 = a2 + q[j + 2] * cs[j + 2];
          a3 = a3 + q[j + 3] * cs[j + 3];
        }
      } else {
        int j = x;
        for (; j + 3 * bw < S; j += 4 * bw) {
          a0 = a0 + q[j] * cs[j];
          a1 = a1 + q[j + bw] * cs[j + bw];
          a2 = a2 + q[j + 2 * bw] * cs[j + 2 * bw];
          a3 = a3 + q[j + 3 * bw] * cs[j + 3 * bw];
        }
        if (j < S) a0 = a0 + q[j] * cs[j];
        if (j + bw < S) a1 = a1 + q[j + bw] * cs[j + bw];
        if (j + 2 * bw < S) a2 = a2 + q[j + 2 * bw] * cs[j + 2 * bw];
      }
    }
    lane[x] = ((a0 + a1) + a2) + a3;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < bw) {
#pragma unroll
      for (int x = 0; x < off; ++x) lane[x] = lane[x] + lane[x + off];
    }
  }
  return lane[0];
}

// How many of the row's CDF values q_k cos_k / total (1/S each for a zero
// total) are <= u1, with the CDF as torch.cumsum computes it on the card
// (ATen/native/cuda/ScanUtils.cuh, tensor_kernel_scan_innermost_dim): the row
// in blocks of 2^levels columns (zeros past its end), the blocks before added
// into each block's first element, each block a Sklansky scan.  Element i's
// value gains, for each set bit m of i in turn, the total of the aligned
// 2^m-column group below it; lower[m] keeps the last such group's total.
__device__ __forceinline__ int cdf_count(const float* __restrict__ q,
                                         const float* __restrict__ cs, int S,
                                         float total, bool pos, float inv_s,
                                         int levels, float u1) {
  constexpr int kMaxLevels = 10;   // ATen's blocks have at most 1,024 columns
  const int nb = 1 << levels;
  float carry = 0.f;
  int count = 0;
  for (int b0 = 0; b0 < S; b0 += nb) {
    float lower[kMaxLevels];
    float x = 0.f;
    for (int i = 0; i < nb; ++i) {
      const int col = b0 + i;
      float v = col < S ? (pos ? q[col] * cs[col] / total : inv_s) : 0.f;
      if (i == 0) v = v + carry;
      x = v;
#pragma unroll
      for (int m = 0; m < kMaxLevels; ++m)
        if (m < levels && ((i >> m) & 1)) x = x + lower[m];
      if (col < S && x <= u1) ++count;
      float t = v;   // the aligned groups that end at i
#pragma unroll
      for (int k = 0; k < kMaxLevels; ++k) {
        if (k >= levels) break;
        if (((i >> k) & 1) == 0) {
          lower[k] = t;
          break;
        }
        t = t + lower[k];
      }
    }
    carry = x;
  }
  return count;
}

// hemisphere.sector_direction(u, sector, linalg.make_frame(n), G), op for
// op: the jittered grid point, Chiu's concentric map, the frame (T, N, B)
// about the normal, and local x T + y N + z B.  inv_g is 1 / G in f32:
// torch divides by a host scalar as a product with its f32 reciprocal.
__device__ __forceinline__ void sector_direction(int sector, int G,
                                                 float inv_g, float ju,
                                                 float jv, float nx, float ny,
                                                 float nz, float& dx,
                                                 float& dy, float& dz) {
  constexpr float kO1 = static_cast<float>(kPiD / 4.0);
  constexpr float kO2 = static_cast<float>(kPiD / 2.0);
  constexpr float kO3 = static_cast<float>(3.0 * kPiD / 4.0);
  constexpr float kO4 = static_cast<float>(kPiD);
  constexpr float kO5 = static_cast<float>(5.0 * kPiD / 4.0);
  constexpr float kO6 = static_cast<float>(3.0 * kPiD / 2.0);
  constexpr float kO7 = static_cast<float>(7.0 * kPiD / 4.0);
  const int sx = sector / G, sy = sector - sx * G;
  const float x = (static_cast<float>(sx) + ju) * inv_g;
  const float y = (static_cast<float>(sy) + jv) * inv_g;
  const float a = 2.f * x - 1.f;
  const float b = 2.f * y - 1.f;
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
  const float ly = origin ? 1.f : cos_t;
  const float lz = origin ? 0.f : sin_t * sinf(phi);
  // make_frame: T = normalize((n.z, 0, -n.x) or (0, -n.z, n.y)), B = N x T
  const bool use_x = fabsf(nx) > fabsf(ny);
  float tx = use_x ? nz : 0.f, ty = use_x ? 0.f : -nz, tz = use_x ? -nx : ny;
  const float tn = fmaxf(sqrtf(sum3(tx * tx, ty * ty, tz * tz)), 1e-20f);
  tx = tx / tn;
  ty = ty / tn;
  tz = tz / tn;
  // torch.linalg.cross rounds a*b - c*d as fma(a, b, -(c*d)) on the card
  const float bx = fmaf(ny, tz, -(nz * ty));
  const float by = fmaf(nz, tx, -(nx * tz));
  const float bz = fmaf(nx, ty, -(ny * tx));
  dx = (lx * tx + ly * nx) + lz * bx;
  dy = (lx * ty + ly * ny) + lz * by;
  dz = (lx * tz + ly * nz) + lz * bz;
}

// integrators/wavefront.py:primary_dirs_u for one pixel: the jittered ray
// through the pixel, normalised, then camera.rotate_dirs.
__device__ __forceinline__ void primary_dir(const DeepParams& p, int64_t pix,
                                            float ju, float jv, float& dx,
                                            float& dy, float& dz) {
  const float px = static_cast<float>(pix % p.width);
  const float py = static_cast<float>(pix / p.width);
  float x = (px + ju) - p.half_width;
  float y = (py + jv) - p.half_height;
  float z = p.focal;
  const float n = sqrtf(sum3(x * x, y * y, z * z));
  x = x / n;
  y = y / n;
  z = z / n;
  dx = p.cos_yaw_y * x - p.sin_yaw_y * z;
  const float z1 = p.sin_yaw_y * x + p.cos_yaw_y * z;
  dy = p.cos_yaw_x * y + p.sin_yaw_x * z1;
  dz = (-p.sin_yaw_x) * y + p.cos_yaw_x * z1;
}

__global__ void __launch_bounds__(kBlock) deep_transport_kernel(
    DeepParams p, SlotState c, StepInputs x, SlotState out, StepOutputs y) {
  extern __shared__ float smem[];
  const int S = p.n_sectors;
  const int stride = S | 1;   // odd: a warp's rows start on distinct banks
  float* s_cos = smem + kBlock * stride;
  const int base = blockIdx.x * kBlock;
  const int rows = min(kBlock, p.n_lanes - base);
  const float* src = x.qs + static_cast<size_t>(base) * S;
  if (S % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int j = threadIdx.x; j < rows * S / 4; j += kBlock) {
      const float4 v = __ldg(src4 + j);
      const int r = 4 * j / S, k = 4 * j - r * S;
      float* dst = smem + r * stride + k;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int j = threadIdx.x; j < rows * S; j += kBlock) {
      const int r = j / S;
      smem[r * stride + (j - r * S)] = __ldg(src + j);
    }
  }
  for (int k = threadIdx.x; k < S; k += kBlock) s_cos[k] = __ldg(x.cos + k);
  __syncthreads();

  long long n_path = 0, n_light_path = 0, n_zclp = 0, n_light = 0;
  const int i = base + threadIdx.x;
  if (i < p.n_lanes) {
    const float* q = smem + threadIdx.x * stride;
    const bool act = c.active[i];
    const float t = x.t[i];
    const int tri = x.tri[i];
    const bool missed = act && t >= kInfCut;
    const bool light = act && !missed && tri >= p.n_surfaces;
    const bool surf = act && !missed && tri < p.n_surfaces;
    const float4* mr = reinterpret_cast<const float4*>(x.mrow) + 4 * i;
    const float4 m0 = __ldg(mr), m1 = __ldg(mr + 1), m2 = __ldg(mr + 2);
    const float nx = m0.x, ny = m0.y, nz = m0.z;
    const float diff[3] = {m0.w, m1.x, m1.y};
    const float emis[3] = {m1.z, m1.w, m2.x};
    float tp[3], sr[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tp[k] = c.tp[3 * i + k];
      sr[k] = c.sample_rad[3 * i + k];
    }
    const int bounce = c.bounce[i];
    const int sord = c.sord[i];

    // the sampler (deep.neural_q.sample_q_directions_u)
    const float eps = p.train ? fmaxf(p.eps0 - p.eps_decay *
                                      static_cast<float>(sord), p.eps_min)
                              : 0.f;
    const float* u = x.u + 5 * i;
    const float total = row_total(q, s_cos, S);
    const bool pos = total > 0.f;
    const int count = cdf_count(q, s_cos, S, total, pos, p.inv_sectors,
                                p.scan_levels, u[1]);
    const int sec_imp = min(count, S - 1);
    const float p_imp = pos ? q[sec_imp] * s_cos[sec_imp] / total
                            : p.inv_sectors;
    const float pdf_imp = p.rho * (p_imp * p.inv_grid_rho);
    const int sec_rand = min(max(static_cast<int>((u[2] - 1e-4f) *
                                                  static_cast<float>(S)), 0),
                             S - 1);
    const bool explore = u[0] <= eps;
    const int sector = explore ? sec_rand : sec_imp;
    const float pdf = explore ? p.rho : pdf_imp;
    float ndx, ndy, ndz;
    sector_direction(sector, p.grid, p.inv_grid, u[3], u[4], nx, ny, nz, ndx,
                     ndy, ndz);
    y.sector[i] = sector;
    y.pdf[i] = pdf;

    // transport
    const float cos_theta = sum3(nx * ndx, ny * ndy, nz * ndz);
    const float ratio = cos_theta / fmaxf(pdf, 1e-12f);
    const bool exhausted = surf && bounce + 1 >= p.max_bounces;
    bool survive = surf && !exhausted;
    float brdf[3], ntp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      brdf[k] = diff[k] * p.inv_pi;
      const float contrib = (missed ? tp[k] * p.env : 0.f)
                            + (light ? tp[k] * emis[k] : 0.f);
      sr[k] = (sr[k] + contrib) + (exhausted ? tp[k] * brdf[k] : 0.f);
      ntp[k] = survive ? tp[k] * brdf[k] * ratio : tp[k];
    }
    bool rr_killed = false;
    if (p.russian_roulette) {
      const float pk = fminf(fmaxf(fmaxf(fmaxf(ntp[0], ntp[1]), ntp[2]),
                                   p.rr_min_prob), 1.f);
      const bool do_rr = survive && bounce + 1 >= p.rr_start_bounce;
      rr_killed = do_rr && x.u_rr[i] >= pk;
      if (do_rr && !rr_killed) {
#pragma unroll
        for (int k = 0; k < 3; ++k) ntp[k] = ntp[k] / pk;
      }
      survive = survive && !rr_killed;
    }

    // the statistics of finished samples
    const bool done = missed || light;
    const int fin = bounce + 1;   // a finished lane keeps its bounce
    n_path = ((done || rr_killed) ? fin : 0)
             + (exhausted ? p.max_bounces : 0);
    const bool finished = act && !survive;
    n_zclp = finished && sum3(sr[0], sr[1], sr[2]) * (1.f / 3.f)
                             < p.throughput_threshold;
    n_light = light;
    n_light_path = light ? fin : 0;

    // bank a finished sample into the slot's row kmx
    const int64_t kmx = c.kmx[i];
    for (int r = 0; r < p.pix_mux; ++r) {
      const size_t at = (static_cast<size_t>(i) * p.pix_mux + r) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        out.slot_rad[at + k] =
            c.slot_rad[at + k] + ((r == kmx && finished) ? sr[k] : 0.f);
    }

    // regeneration: the next sample, else the next multiplexed pixel
    const int64_t pixel = c.pixel[i];
    const int64_t next_pix = pixel + p.w0;
    int remaining = c.remaining[i];
    const bool step_k = finished && remaining <= 0 && kmx + 1 < p.pix_mux
                        && next_pix < p.n_pix && next_pix < p.pix_end;
    const int64_t pix_out = step_k ? next_pix : pixel;
    if (step_k) remaining = p.spp;
    const bool regen = finished && remaining > 0;
    out.pixel[i] = pix_out;
    out.kmx[i] = step_k ? kmx + 1 : kmx;
    out.remaining[i] = regen ? remaining - 1 : remaining;
    out.sord[i] = regen ? (step_k ? 0 : sord + 1) : sord;
    out.bounce[i] = regen ? 0 : (survive ? bounce + 1 : bounce);
    out.active[i] = survive || regen;
    out.action[i] = survive ? static_cast<int64_t>(sector) : -1;
    const float cam[3] = {p.cam_x, p.cam_y, p.cam_z};
    const float nd[3] = {ndx, ndy, ndz};
    float rd[3] = {0.f, 0.f, 0.f};
    if (regen) {
      primary_dir(p, pix_out, x.u_pix[2 * i], x.u_pix[2 * i + 1], rd[0],
                  rd[1], rd[2]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float qp = x.qpos[3 * i + k];
      const float o = survive ? qp + p.ray_eps * nd[k] : c.o[3 * i + k];
      const float d = survive ? nd[k] : c.d[3 * i + k];
      out.o[3 * i + k] = regen ? cam[k] : o;
      out.d[3 * i + k] = regen ? rd[k] : d;
      out.tp[3 * i + k] = regen ? 1.f : ntp[k];
      out.sample_rad[3 * i + k] = regen ? 0.f : sr[k];
      out.prev_loc[3 * i + k] = survive ? qp : c.prev_loc[3 * i + k];
    }
  }

  // the block's sums, one atomic each
  __shared__ long long s_sum[kWarps][4];
  long long v[4] = {n_path, n_light_path, n_zclp, n_light};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s_sum[threadIdx.x / 32][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b[4] = {0, 0, 0, 0};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] += s_sum[w][k];
    }
    if (b[0]) atomicAdd(y.path_sum, static_cast<double>(b[0]));
    if (b[1]) atomicAdd(y.light_path_sum, static_cast<double>(b[1]));
    if (b[2]) atomicAdd(y.zclp, static_cast<unsigned long long>(b[2]));
    if (b[3]) atomicAdd(y.light_hits, static_cast<unsigned long long>(b[3]));
  }
}

}  // namespace rlrpt_deep

// One step of the deep wavefront's sample-and-transport over p.n_lanes
// lanes: reads the slot state `in` and the step's inputs, writes the new
// slot state `out`, the sector and the pdf, and adds into the four
// statistics.  One thread a lane; a block's Q rows and the sector cosines in
// dynamic shared memory.  Returns cudaGetLastError() after the launch.
extern "C" int rlrpt_deep_transport(rlrpt_deep::DeepParams p,
                                    rlrpt_deep::SlotState in,
                                    rlrpt_deep::StepInputs x,
                                    rlrpt_deep::SlotState out,
                                    rlrpt_deep::StepOutputs y, void* stream) {
  using rlrpt_deep::deep_transport_kernel;
  using rlrpt_deep::kBlock;
  if (p.n_lanes <= 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlock) * (p.n_sectors | 1)
                       + p.n_sectors);
  cudaFuncSetAttribute(deep_transport_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
  deep_transport_kernel<<<blocks, kBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(p, in, x, out,
                                                               y);
  return static_cast<int>(cudaGetLastError());
}
