// The fine-map SARSA wavefront's sector draw and transport, one launch a
// step, for Hopper (sm_90a): the `.sample` and `.transport` stages of
// integrators/sarsa_wavefront.py:trace_frame_sarsa_wavefront.  For each
// lane: the next sector drawn from the hit volume's CDF row, its pdf and its
// jittered direction in the hit's frame (or the volume's), the radiance a
// miss or a light adds, the bounce cap, the throughput and optional Russian
// roulette, the next pending TD state, the banking of a finished sample
// into the slot's row, and regeneration (the pixel's next sample, or the
// slot's next pixel, with a jittered camera ray).  Under the two-level
// sampler the frame draws the sector itself and the kernel only transports
// (`sample` 0).
//
// Replaces no TPU kernel: the JAX package leaves these stages to XLA, which
// fuses them.  On the card they were ~270 small torch kernels a step, and
// the host's issue of them set the pace of the frame (PERF.md).
//
// What bounds it on this card: bytes.  A lane reads its volume's CDF row
// (576 bytes at 144 f32 sectors, 288 in bf16), ~0.2 KB of slot state, hit
// and uniforms, and writes ~0.15 KB, at a few flops a byte.  The rows are
// gathered by volume, so no two lanes' rows need lie side by side.
//
// What the design does about it: one thread a lane for the transport, and a
// warp together for the row reads.  A warp takes its 32 lanes' rows in
// turn; for each, its threads read 32 neighbouring entries at a time (one
// coalesced load per 32 entries) and count those below the lane's uniform
// with a ballot.  The count is over all S entries, as the twin's is: the
// rows come from torch's scan and need not be monotone to the ulp, so no
// binary search.  The two entries about the sector are then read by the
// lane's own thread (the row is in cache).  The two statistics are sums of
// whole numbers, reduced in the block and added with one atomic each, so
// their order does not matter.
//
// Arithmetic: the twin's f32 operations in the twin's order (the twin is
// ops/sarsa_transport.py:sample_transport_plain), built without FMA
// contraction (_cuda.py), and with what torch's kernels do on the card: a
// sum over 3 is (x0 + x2) + x1, and a mean over 3 that sum times f32(1/3);
// a division by a host scalar is a product with its f32 reciprocal; a cross
// product's a*b - c*d is fma(a, b, -(c*d)).  The frame, the concentric map
// and the camera ray are csrc/deep_transport.cu's.
#include <cstdint>
#include <cuda_runtime.h>

namespace rlrpt_sarsa {

// Mirrored field for field by ops/sarsa_transport.py:SarsaParams (4-byte
// fields only, so no padding to disagree on).
struct SarsaParams {
  int n_lanes, n_sectors, grid, n_volumes, row_stride, bf16_rows;
  int sample, volume_frames;
  int normal_stride, diffuse_stride, emission_stride, lum_stride;
  int w0, n_pix, pix_end, pix_mux, spp, width;
  int max_bounces, russian_roulette, rr_start_bounce;
  float env, ray_eps, rr_min_prob, throughput_threshold;
  float rho, inv_grid_rho, inv_pi, inv_grid;
  float half_width, half_height, focal;
  float cam_x, cam_y, cam_z, cos_yaw_y, sin_yaw_y, cos_yaw_x, sin_yaw_x;
};

// A slot state's fields (sarsa_wavefront._State), in its order; the input
// state is only read.
struct SlotState {
  float* o;
  float* d;
  float* tp;
  int64_t* pixel;
  int64_t* kmx;
  int* bounce;
  int* remaining;
  bool* active;
  float* sample_rad;
  float* slot_rad;
  int64_t* cur_vol;
  int64_t* cur_sector;
  float* cur_brdf;
};

struct StepInputs {
  const bool* missed;
  const bool* light;
  const bool* surface;
  const float* pos;        // (W, 3) the hit point
  const float* normal;     // rows of normal_stride floats, and so on
  const float* diffuse;
  const float* emission;
  const float* lum;
  const int64_t* next_vol;
  const void* rows;        // (V, row_stride) f32 or bf16; null with sample 0
  const float* frames;     // (V, 3, 3) rows (T, N, B), or null
  const float* r;          // (W,)
  const float* u;          // (W, 2)
  const float* u_rr;       // (W,), or null without Russian roulette
  const float* u_pix;      // (W, 2)
  const int64_t* sector;   // the drawn sector, pdf and direction (W, 3)
  const float* pdf;        // with sample 0, else null
  const float* dir;
};

struct StepOutputs {
  int64_t* sector;         // with sample 1, else null
  float* pdf;
  double* path_sum;
  unsigned long long* zclp;
};

constexpr int kBlock = 128;          // lanes (threads) a block
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPiD = 3.141592653589793;   // Python's math.pi

// torch.sum over a last dimension of 3 on the card: lanes 0 and 1 of ATen's
// reduce kernel hold x0 + x2 and x1.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

// Entry k of a CDF row, as torch's .float() reads it.
__device__ __forceinline__ float row_at(const void* rows, bool bf16,
                                        size_t k) {
  if (bf16) {
    const unsigned short b =
        __ldg(static_cast<const unsigned short*>(rows) + k);
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  return __ldg(static_cast<const float*>(rows) + k);
}

// hemisphere.concentric_map of the sector's jittered grid point
// (hemisphere.sector_direction before its frame), op for op.  inv_g is 1 / G
// in f32: torch divides by a host scalar as a product with its f32
// reciprocal.
__device__ __forceinline__ void sector_local(int sector, int G, float inv_g,
                                             float ju, float jv, float& lx,
                                             float& ly, float& lz) {
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
  lx = origin ? 0.f : sin_t * cosf(phi);
  ly = origin ? 1.f : cos_t;
  lz = origin ? 0.f : sin_t * sinf(phi);
}

// linalg.make_frame's rows T and B about the normal n (its N):
// T = normalize((n.z, 0, -n.x) or (0, -n.z, n.y)), B = N x T.
__device__ __forceinline__ void normal_frame(const float n[3], float t[3],
                                             float b[3]) {
  const bool use_x = fabsf(n[0]) > fabsf(n[1]);
  t[0] = use_x ? n[2] : 0.f;
  t[1] = use_x ? 0.f : -n[2];
  t[2] = use_x ? -n[0] : n[1];
  const float tn = fmaxf(sqrtf(sum3(t[0] * t[0], t[1] * t[1], t[2] * t[2])),
                         1e-20f);
  t[0] = t[0] / tn;
  t[1] = t[1] / tn;
  t[2] = t[2] / tn;
  // torch.linalg.cross rounds a*b - c*d as fma(a, b, -(c*d)) on the card
  b[0] = fmaf(n[1], t[2], -(n[2] * t[1]));
  b[1] = fmaf(n[2], t[0], -(n[0] * t[2]));
  b[2] = fmaf(n[0], t[1], -(n[1] * t[0]));
}

// integrators/wavefront.py:primary_dirs_u for one pixel: the jittered ray
// through the pixel, normalised, then camera.rotate_dirs.
__device__ __forceinline__ void primary_dir(const SarsaParams& p, int64_t pix,
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

__global__ void __launch_bounds__(kBlock) sarsa_transport_kernel(
    SarsaParams p, SlotState c, StepInputs x, SlotState out, StepOutputs y) {
  const int S = p.n_sectors;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool mine = i < p.n_lanes;
  const bool bf16 = p.bf16_rows;

  // the sector draw (volumes.sample_from_cdf_rows_u): how many of the row's
  // S entries lie below r, counted by the whole warp for each of its lanes
  int64_t vol = 0;
  long long row = 0;
  int count = 0;
  if (p.sample) {
    float r = 0.f;
    if (mine) {
      vol = x.next_vol[i];
      r = x.r[i];
    }
    // torch's index takes -V <= v < 0 as v + V
    row = (vol < 0 ? vol + p.n_volumes : vol) * p.row_stride;
    const int n = min(32, p.n_lanes - (i - lane));   // the warp's lanes
    // kGroup lanes' rows at a time, so that as many loads are in flight
    constexpr int kGroup = 8;
    for (int j0 = 0; j0 < n; j0 += kGroup) {
      long long rj[kGroup];
      float uj[kGroup];
      int below[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        rj[q] = __shfl_sync(kFull, row, (j0 + q) & 31);
        uj[q] = __shfl_sync(kFull, r, (j0 + q) & 31);
        below[q] = 0;
      }
      for (int k0 = 0; k0 < S; k0 += 32) {
        const int k = k0 + lane;
        float val[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          val[q] = (k < S && j0 + q < n) ? row_at(x.rows, bf16, rj[q] + k)
                                         : 0.f;
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          below[q] += __popc(__ballot_sync(
              kFull, k < S && j0 + q < n && val[q] < uj[q]));
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (lane == j0 + q) count = below[q];
    }
  }

  long long n_path = 0, n_zclp = 0;
  if (mine) {
    const bool act = c.active[i];
    const bool missed = x.missed[i], light = x.light[i], surf = x.surface[i];
    const float nrm[3] = {x.normal[i * p.normal_stride],
                          x.normal[i * p.normal_stride + 1],
                          x.normal[i * p.normal_stride + 2]};
    int sector;
    float pdf, nd[3];
    if (p.sample) {
      sector = min(count, S - 1);
      const float hi = sector == S - 1 ? 1.f : row_at(x.rows, bf16,
                                                      row + sector);
      const float lo = sector > 0 ? row_at(x.rows, bf16, row + sector - 1)
                                  : 0.f;
      pdf = p.rho * ((hi - lo) * p.inv_grid_rho);
      const float2 ju = reinterpret_cast<const float2*>(x.u)[i];
      float lx, ly, lz, t[3], n[3], b[3];
      sector_local(sector, p.grid, p.inv_grid, ju.x, ju.y, lx, ly, lz);
      if (p.volume_frames) {
        const float* f = x.frames + static_cast<size_t>(
            vol < 0 ? vol + p.n_volumes : vol) * 9;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          t[k] = __ldg(f + k);
          n[k] = __ldg(f + 3 + k);
          b[k] = __ldg(f + 6 + k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) n[k] = nrm[k];
        normal_frame(n, t, b);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) nd[k] = (lx * t[k] + ly * n[k]) + lz * b[k];
      y.sector[i] = sector;
      y.pdf[i] = pdf;
    } else {
      sector = static_cast<int>(x.sector[i]);
      pdf = x.pdf[i];
#pragma unroll
      for (int k = 0; k < 3; ++k) nd[k] = x.dir[3 * i + k];
    }

    // transport
    float tp[3], sr[3], ntp[3];
    const float cos_theta = sum3(nrm[0] * nd[0], nrm[1] * nd[1],
                                 nrm[2] * nd[2]);
    const float ratio = cos_theta / fmaxf(pdf, 1e-12f);
    const int bounce = c.bounce[i];
    const bool exhausted = surf && bounce + 1 >= p.max_bounces;
    bool survive = surf && !exhausted;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tp[k] = c.tp[3 * i + k];
      const float emis = x.emission[i * p.emission_stride + k];
      const float brdf = x.diffuse[i * p.diffuse_stride + k] * p.inv_pi;
      sr[k] = (c.sample_rad[3 * i + k] + (missed ? tp[k] * p.env : 0.f))
              + (light ? tp[k] * emis : 0.f);
      ntp[k] = survive ? tp[k] * brdf * ratio : tp[k];
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
    const int fin = bounce + 1;   // a finished lane keeps its bounce
    n_path = ((missed || light || rr_killed) ? fin : 0)
             + (exhausted ? p.max_bounces : 0);
    const bool finished = act && !survive;
    n_zclp = finished && sum3(sr[0], sr[1], sr[2]) * (1.f / 3.f)
                             < p.throughput_threshold;

    // bank a finished sample into the slot's row kmx
    const int64_t kmx = c.kmx[i];
    for (int r = 0; r < p.pix_mux; ++r) {
      const size_t at = (static_cast<size_t>(i) * p.pix_mux + r) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        out.slot_rad[at + k] =
            c.slot_rad[at + k] + ((r == kmx && finished) ? sr[k] : 0.f);
    }

    // regeneration: the next sample, else the next multiplexed pixel (the
    // pixel stride stays w0 in every phase)
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
    out.bounce[i] = regen ? 0 : (survive ? bounce + 1 : bounce);
    out.active[i] = survive || regen;
    // the pending TD state for the next vertex
    out.cur_vol[i] = survive ? x.next_vol[i] : c.cur_vol[i];
    out.cur_sector[i] = survive ? static_cast<int64_t>(sector) : -1;
    out.cur_brdf[i] = survive ? x.lum[i * p.lum_stride] * p.inv_pi
                              : c.cur_brdf[i];
    const float cam[3] = {p.cam_x, p.cam_y, p.cam_z};
    float rd[3] = {0.f, 0.f, 0.f};
    if (regen) {
      const float2 jp = reinterpret_cast<const float2*>(x.u_pix)[i];
      primary_dir(p, pix_out, jp.x, jp.y, rd[0], rd[1], rd[2]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float o = survive ? x.pos[3 * i + k] + p.ray_eps * nd[k]
                              : c.o[3 * i + k];
      const float d = survive ? nd[k] : c.d[3 * i + k];
      out.o[3 * i + k] = regen ? cam[k] : o;
      out.d[3 * i + k] = regen ? rd[k] : d;
      out.tp[3 * i + k] = regen ? 1.f : ntp[k];
      out.sample_rad[3 * i + k] = regen ? 0.f : sr[k];
    }
  }

  // the block's sums, one atomic each
  __shared__ long long s_sum[kWarps][2];
  long long v[2] = {n_path, n_zclp};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(kFull, v[k], off);
  }
  if (lane == 0) {
    s_sum[threadIdx.x / 32][0] = v[0];
    s_sum[threadIdx.x / 32][1] = v[1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b0 = 0, b1 = 0;
    for (int w = 0; w < kWarps; ++w) {
      b0 += s_sum[w][0];
      b1 += s_sum[w][1];
    }
    if (b0) atomicAdd(y.path_sum, static_cast<double>(b0));
    if (b1) atomicAdd(y.zclp, static_cast<unsigned long long>(b1));
  }
}

}  // namespace rlrpt_sarsa

// One step of the fine-map SARSA wavefront's sector draw and transport over
// p.n_lanes lanes: reads the slot state `in` and the step's inputs, writes
// the new slot state `out` (and, with p.sample, the sector and the pdf), and
// adds into the two statistics.  One thread a lane, a warp together for each
// lane's CDF row.  Returns cudaGetLastError() after the launch.
extern "C" int rlrpt_sarsa_transport(rlrpt_sarsa::SarsaParams p,
                                     rlrpt_sarsa::SlotState in,
                                     rlrpt_sarsa::StepInputs x,
                                     rlrpt_sarsa::SlotState out,
                                     rlrpt_sarsa::StepOutputs y,
                                     void* stream) {
  using rlrpt_sarsa::kBlock;
  if (p.n_lanes <= 0) return 0;
  const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
  rlrpt_sarsa::sarsa_transport_kernel<<<blocks, kBlock, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      p, in, x, out, y);
  return static_cast<int>(cudaGetLastError());
}
