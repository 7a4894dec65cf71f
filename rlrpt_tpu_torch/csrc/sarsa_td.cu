// The fine-map SARSA wavefront's nearest-volume lookup and TD update, for
// Hopper (sm_90a): the `.volume` and `.td` stages of
// integrators/sarsa_wavefront.py:trace_frame_sarsa_wavefront, in four
// launches a step:
//
//   lookup   the answer table's nearest volume at each lane's hit (the cell
//            index, the cell's 64-byte row, the class-slot compare and the
//            fallback): radiance/grid_bucket.py:find_closest_volume_table;
//   targets  each lane's TD target (the environment, the light's luminance,
//            or the bootstrap irradiance, column S of the carried CDF row of
//            the lane's new volume) and its pending flag, and the pending
//            count added into the frame's TD count;
//   scatter  each pending lane's target and a count of 1 added into the
//            frame's (V*S + 1) scratch with atomics, and the lane's volume
//            marked dirty;
//   apply    a warp for each dirty volume: every entry of its row that
//            received targets takes the exact sequential composition of the
//            running mean in place (radiance/volumes.py:
//            apply_sarsa_contributions), its scratch entries are set back to
//            zero, and the row's irradiance (volumes.py:irradiance_estimates)
//            is written into column S of its carried CDF row.
//
// Replaces no TPU kernel: the JAX package leaves these stages to XLA, which
// fuses them.  On the card they were ~65 small torch kernels a step, ~17 of
// them passes over the whole (V, S) table, and the host launching them set
// the pace of the frame (PERF.md).
//
// What bounds them on this card: bytes.  The lookup reads a lane's hit
// point and class and one 64-byte table row; the targets a lane's state,
// hit masks and one carried row entry; the scatter two atomics a pending
// lane; the apply a dirty row's counts, Q and cosines (1,728 bytes at 144
// sectors) and writes the entries updated.  Rows no lane touched are not
// read: the scratch stays zero between steps (the apply zeroes what the
// scatter added), so nothing clears the whole table.
//
// Arithmetic: the twins' f32 operations in their order, built without FMA
// contraction (_cuda.py), and with what torch's kernels do on the card: a
// division by a host scalar is a product with its f32 reciprocal; the row's
// sum of Q * cos follows ATen's reduce kernel (as csrc/deep_transport.cu's
// row_total: bw lanes, the largest power of two up to min(n, 32), n being S,
// or S / 4 where S is at least 128 and a multiple of 4; each lane's 4
// accumulators added in order; a warp shuffle of halving offsets), exact
// where S is below 128 or a multiple of 4; the bfloat16 column rounds to
// nearest even.  The scatter's atomics add a duplicate entry's targets in
// any order, as the twin's index_add_ does on the card, so Q differs from
// run to run in its last bits; the counts are whole numbers and exact.
#include <cstdint>
#include <cuda_runtime.h>

namespace rlrpt_td {

// Mirrored field for field by ops/sarsa_td.py:LookupParams.
struct LookupParams {
  int n_lanes, n_slots, nx, ny, nz;
};

struct LookupArgs {
  const float* qpos;       // (W, 3) hit points
  const int* cls;          // (W,) the hits' normal classes
  const int* table;        // (C, 16) rows [cls0, ans0, ... cls3, ans3,
                           // fallback, has_any, pad]
  const float* origin;     // (3,) the table's lower corner
  const float* inv_cell;   // () 1 / cell
  int64_t* next_vol;       // (W,) out
};

// Mirrored by ops/sarsa_td.py:TdParams (4-byte fields only).
struct TdParams {
  int n_lanes, n_volumes, n_sectors, bf16_rows, lum_stride;
  float env, threshold, inv_pi, irr_scale;
};

// A frame's tables, updated in place; the scratch (sum_t, cnt: V*S + 1 f32
// each) and the dirty flags (V int32) are zero between steps.
struct TdTables {
  float* q;                 // (V, S)
  int* visits;              // (V, S)
  float* sum_t;
  float* cnt;
  int* dirty;
  void* rows;               // (V, S + 1) f32 or bf16, the carried CDF rows
  const float* cos;         // (S,) sector_cos_thetas
  const float* surface_lum; // (V,)
  unsigned long long* td_count;   // () int64
};

// A step's lanes: the targets' inputs and outputs.
struct TargetArgs {
  const bool* active;
  const int64_t* cur_sector;
  const float* cur_brdf;
  const bool* missed;
  const bool* light;
  const float* lum;          // rows of lum_stride floats
  const int64_t* next_vol;
  float* target;             // (W,) out
  bool* pending;             // (W,) out
};

struct ScatterArgs {
  const int64_t* vol;
  const int64_t* sector;
  const float* target;
  const bool* mask;
};

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(f, 0, hi) on the card (NaN passes through), then .long().
__device__ __forceinline__ long long clamp_long(float f, float hi) {
  const float c = f != f ? f : fminf(fmaxf(f, 0.f), hi);
  return static_cast<long long>(c);
}

__global__ void lookup_kernel(LookupParams p, LookupArgs a, int n_cells) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n_lanes) return;
  const float inv = __ldg(a.inv_cell);
  long long cell = 0;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const int n = axis == 0 ? p.nx : (axis == 1 ? p.ny : p.nz);
    const float f = (a.qpos[3 * i + axis] - __ldg(a.origin + axis)) * inv;
    cell = cell * n + clamp_long(f, static_cast<float>(n - 1));
  }
  // in range for every number but NaN (torch's index would stop there)
  cell = cell < 0 ? 0 : (cell >= n_cells ? n_cells - 1 : cell);
  const int4* row = reinterpret_cast<const int4*>(a.table) + 4 * cell;
  const int4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  const int slot_cls[4] = {r0.x, r0.z, r1.x, r1.z};
  const int slot_ans[4] = {r0.y, r0.w, r1.y, r1.w};
  const int cls = a.cls[i];
  int ans = r2.x;                                       // fallback
#pragma unroll
  for (int s = 3; s >= 0; --s)
    if (s < p.n_slots && slot_cls[s] == cls) ans = slot_ans[s];
  a.next_vol[i] = ans;
}

// Column k of carried row v, as torch's .float() reads it.
__device__ __forceinline__ float row_at(const void* rows, bool bf16,
                                        size_t k) {
  if (bf16) {
    const unsigned short b =
        __ldg(static_cast<const unsigned short*>(rows) + k);
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  return __ldg(static_cast<const float*>(rows) + k);
}

__global__ void targets_kernel(TdParams p, TdTables b, TargetArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  bool pend = false;
  if (i < p.n_lanes) {
    const float brdf = a.cur_brdf[i];
    const size_t stride = static_cast<size_t>(p.n_sectors) + 1;
    const float irr = row_at(b.rows, p.bf16_rows,
                             static_cast<size_t>(a.next_vol[i]) * stride +
                                 p.n_sectors);
    const float env = brdf * p.env;
    const float light = brdf * a.lum[static_cast<size_t>(i) * p.lum_stride];
    const float boot = brdf * irr;
    a.target[i] = a.missed[i] ? env : (a.light[i] ? light : boot);
    pend = a.active[i] && a.cur_sector[i] >= 0;
    a.pending[i] = pend;
  }
  const int n = __syncthreads_count(pend);
  if (threadIdx.x == 0 && n)
    atomicAdd(b.td_count, static_cast<unsigned long long>(n));
}

__global__ void scatter_kernel(int n_lanes, int n_sectors, ScatterArgs a,
                               float* sum_t, float* cnt, int* dirty) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_lanes || !a.mask[i]) return;
  const long long v = a.vol[i];
  const long long e = v * n_sectors + a.sector[i];
  atomicAdd(sum_t + e, a.target[i]);
  atomicAdd(cnt + e, 1.f);
  dirty[v] = 1;
}

// Entry e's Q after the update: (q (1 + n) + sum) / ((1 + n) + cnt), at
// least the threshold, where it received targets; the scratch entry back to
// zero.
__device__ __forceinline__ float update(const TdParams& p, const TdTables& b,
                                        size_t e) {
  const float c = b.cnt[e];
  float q = b.q[e];
  if (c > 0.f) {
    const int n = b.visits[e];
    const float a = static_cast<float>(n) + 1.f;
    const float qn = (q * a + b.sum_t[e]) / (a + c);
    q = qn != qn ? qn : fmaxf(qn, p.threshold);
    b.q[e] = q;
    b.visits[e] = n + static_cast<int>(c);
    b.cnt[e] = 0.f;
    b.sum_t[e] = 0.f;
  }
  return q;
}

// One warp a volume; a clean row is left as it is.
__global__ void apply_kernel(TdParams p, TdTables b) {
  const int v = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int x = threadIdx.x & 31;
  if (v >= p.n_volumes || !b.dirty[v]) return;      // the whole warp
  const int S = p.n_sectors;
  const size_t base = static_cast<size_t>(v) * S;
  const bool vec = S >= 128 && S % 4 == 0;
  const int n = vec ? S / 4 : S;
  int bw = 1;
  while (bw * 2 <= min(n, 32)) bw *= 2;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (x < bw) {
    if (vec) {
      for (int j = 4 * x; j < S; j += 4 * bw) {
        a0 = a0 + update(p, b, base + j) * __ldg(b.cos + j);
        a1 = a1 + update(p, b, base + j + 1) * __ldg(b.cos + j + 1);
        a2 = a2 + update(p, b, base + j + 2) * __ldg(b.cos + j + 2);
        a3 = a3 + update(p, b, base + j + 3) * __ldg(b.cos + j + 3);
      }
    } else {
      int j = x;
      for (; j + 3 * bw < S; j += 4 * bw) {
        a0 = a0 + update(p, b, base + j) * __ldg(b.cos + j);
        a1 = a1 + update(p, b, base + j + bw) * __ldg(b.cos + j + bw);
        a2 = a2 + update(p, b, base + j + 2 * bw) *
                      __ldg(b.cos + j + 2 * bw);
        a3 = a3 + update(p, b, base + j + 3 * bw) *
                      __ldg(b.cos + j + 3 * bw);
      }
      if (j < S) a0 = a0 + update(p, b, base + j) * __ldg(b.cos + j);
      if (j + bw < S)
        a1 = a1 + update(p, b, base + j + bw) * __ldg(b.cos + j + bw);
      if (j + 2 * bw < S)
        a2 = a2 + update(p, b, base + j + 2 * bw) *
                      __ldg(b.cos + j + 2 * bw);
    }
  }
  float t = ((a0 + a1) + a2) + a3;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(kFull, t, off);
    if (off < bw) t = t + o;
  }
  if (x == 0) {
    const float irr = (t * (__ldg(b.surface_lum + v) * p.inv_pi)) *
                      p.irr_scale;
    const size_t k = static_cast<size_t>(v) * (S + 1) + S;
    if (p.bf16_rows) {
      // c10's round to nearest even
      const unsigned u = __float_as_uint(irr);
      const unsigned short h =
          irr != irr ? 0x7FC0
                     : static_cast<unsigned short>(
                           (u + ((u >> 16) & 1u) + 0x7FFFu) >> 16);
      static_cast<unsigned short*>(b.rows)[k] = h;
    } else {
      static_cast<float*>(b.rows)[k] = irr;
    }
    b.dirty[v] = 0;
  }
}

inline int blocks_for(long long threads) {
  return static_cast<int>((threads + kBlock - 1) / kBlock);
}

}  // namespace rlrpt_td

// The nearest volume of p.n_lanes hits through the answer table (C =
// n_cells rows).  One thread a lane.  Returns cudaGetLastError() after the
// launch.
extern "C" int rlrpt_td_lookup(rlrpt_td::LookupParams p,
                               rlrpt_td::LookupArgs a, int n_cells,
                               void* stream) {
  if (p.n_lanes <= 0) return 0;
  rlrpt_td::lookup_kernel<<<rlrpt_td::blocks_for(p.n_lanes),
                            rlrpt_td::kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(p, a,
                                                                 n_cells);
  return static_cast<int>(cudaGetLastError());
}

// A step's TD targets and pending flags; adds the pending count into
// b.td_count.  One thread a lane.
extern "C" int rlrpt_td_targets(rlrpt_td::TdParams p, rlrpt_td::TdTables b,
                                rlrpt_td::TargetArgs a, void* stream) {
  if (p.n_lanes <= 0) return 0;
  rlrpt_td::targets_kernel<<<rlrpt_td::blocks_for(p.n_lanes),
                             rlrpt_td::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(p, b, a);
  return static_cast<int>(cudaGetLastError());
}

// The masked lanes' targets and counts added into sum_t and cnt (flat,
// n_sectors a volume), their volumes marked in dirty.  One thread a lane.
extern "C" int rlrpt_td_scatter(int n_lanes, int n_sectors,
                                rlrpt_td::ScatterArgs a, void* sum_t,
                                void* cnt, void* dirty, void* stream) {
  if (n_lanes <= 0) return 0;
  rlrpt_td::scatter_kernel<<<rlrpt_td::blocks_for(n_lanes), rlrpt_td::kBlock,
                             0, static_cast<cudaStream_t>(stream)>>>(
      n_lanes, n_sectors, a, static_cast<float*>(sum_t),
      static_cast<float*>(cnt), static_cast<int*>(dirty));
  return static_cast<int>(cudaGetLastError());
}

// The dirty volumes' update and irradiance (p.n_volumes rows, a warp each).
extern "C" int rlrpt_td_apply(rlrpt_td::TdParams p, rlrpt_td::TdTables b,
                              void* stream) {
  if (p.n_volumes <= 0) return 0;
  rlrpt_td::apply_kernel<<<rlrpt_td::blocks_for(32LL * p.n_volumes),
                           rlrpt_td::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}
