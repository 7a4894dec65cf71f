// B2: the in-kernel expected-SARSA learning frame for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rlrpt_tpu/ops/guided_mega_train.py:_train_kernel (launcher
// render_sarsa_mega_train): B3's guided slot loop, sampling from the
// frame-start CDF, plus per bounce the TD update of the binned Q-state
// (sector x (triangle, uv bin)).  A pending transition (the sector drawn
// at the surface just left, cur_brdf = its luminance/pi) takes the target
// brdf*env on a miss, brdf*lum(light) on a light and otherwise
// brdf*irr(new bin), the live irradiance sum_s Q*cos * lum/pi * 2pi/S
// (also on a hit that exhausts the bounce cap).  Targets and counts are
// summed per (sector, bin) over one iteration, then applied:
// Q <- max((Q(1+V) + sum_t)/(1+V+cnt), threshold) where cnt > 0.
//
// The schedule: one batch per global iteration.  At iteration k every
// active slot takes its k-th step and reads the irradiance of Q after
// iteration k-1; the step kernel adds (target, 1) to global (sum_t, cnt)
// with atomicAdd; the apply kernel (a lane per column) then updates Q,
// V and the columns' irradiance and zeroes the accumulators.  The TPU
// kernel runs its ray tiles in order, each on the Q the last one left, and
// applies after every iteration of a tile; with one tile covering every
// slot the two schedules are the same.  Counts are small integers in f32,
// so sum(V_out - V_in) equals the number of pending steps exactly.
//
// What bounds it on this card: B3's closest-hit sweep and CDF scan, plus
// the slot state, which lives in global memory between the two launches of
// each iteration (about 100 bytes per slot read and written per step, 52 MB
// at 720x720), and two launches per iteration, about 1,200 per 720x720,
// 32-spp frame.  The atomics hit a (S_pad, C) table that stays in L2
// (320 KB each at Cornell, uv_bins 4).
//
// What the design does about it: the simple schedule first, a host loop of
// two launches per iteration; a block whose slots are all idle returns at
// once, so the tail costs a launch and not a sweep.  The host reads a
// device-side "any slot alive" flag every kCheckEvery iterations to stop;
// the idle iterations past the end are no-ops.  A persistent cooperative
// kernel with a grid barrier and CUDA graphs are later perf work.  The
// paths do not depend on Q (the sector comes from the frame-start CDF with
// B3's sampler and RNG streams), so image, path_sum and iters are B3's bit
// for bit; the TPU's bf16 hi/lo splits of targets and irradiance are gone:
// kernel and twin compute in plain f32.
#include "path_common.cuh"

namespace rlrpt {

// Mirrored field for field by rlrpt_tpu_torch/_cuda.py:TrainParams.  (Not
// in the unnamed namespace: the C entry point takes it by value.)
struct TrainParams {
  int n_cols;                 // C = t_pad * uv_bins^2
  int max_iters;              // pix_mux * spp * max_bounces: no slot steps
                              // more
  float radiance_threshold;   // Q floor
  float irr_scale;            // f32(2pi/S) / f32(pi)
};

}  // namespace rlrpt

namespace {

using rlrpt::kBlock;
using rlrpt::TrainParams;

constexpr int kCheckEvery = 16;

// Rows of the slot-state tables fstate (kNumF, n_slots) f32 and istate
// (kNumI, n_slots) i32.  The pixel sums live in rad, path lengths in
// path_sum.
enum FRow { kOx, kOy, kOz, kDx, kDy, kDz, kTr, kTg, kTb, kBrdf, kTd, kNumF };
enum IRow { kBounce, kRemaining, kPix, kK, kAct, kBin, kSec, kNumI };

__device__ __forceinline__ void store_slot(const rlrpt::Slot& s, float* fs,
                                           int* is, float* rad,
                                           float* path_sum,
                                           const rlrpt::MegaParams& p,
                                           int slot) {
  const size_t n = p.n_slots;
  fs[kOx * n + slot] = s.ox;
  fs[kOy * n + slot] = s.oy;
  fs[kOz * n + slot] = s.oz;
  fs[kDx * n + slot] = s.dx;
  fs[kDy * n + slot] = s.dy;
  fs[kDz * n + slot] = s.dz;
  fs[kTr * n + slot] = s.tr;
  fs[kTg * n + slot] = s.tg;
  fs[kTb * n + slot] = s.tb;
  is[kBounce * n + slot] = s.bounce;
  is[kRemaining * n + slot] = s.remaining;
  is[kPix * n + slot] = s.pix;
  is[kK * n + slot] = s.k;
  is[kAct * n + slot] = s.act;
  rlrpt::store_pixel(rad, p, s.k, slot, s.ar, s.ag, s.ab);
  path_sum[slot] = s.psum;
}

__device__ __forceinline__ rlrpt::Slot load_slot(const float* fs,
                                                 const int* is,
                                                 const float* rad,
                                                 const float* path_sum,
                                                 const rlrpt::MegaParams& p,
                                                 int slot) {
  const size_t n = p.n_slots;
  rlrpt::Slot s;
  s.ox = fs[kOx * n + slot];
  s.oy = fs[kOy * n + slot];
  s.oz = fs[kOz * n + slot];
  s.dx = fs[kDx * n + slot];
  s.dy = fs[kDy * n + slot];
  s.dz = fs[kDz * n + slot];
  s.tr = fs[kTr * n + slot];
  s.tg = fs[kTg * n + slot];
  s.tb = fs[kTb * n + slot];
  s.bounce = is[kBounce * n + slot];
  s.remaining = is[kRemaining * n + slot];
  s.pix = is[kPix * n + slot];
  s.k = is[kK * n + slot];
  s.act = is[kAct * n + slot] != 0;
  const float* a = rad + 3 * (static_cast<size_t>(s.k) * n + slot);
  s.ar = a[0];
  s.ag = a[1];
  s.ab = a[2];
  s.psum = path_sum[slot];
  return s;
}

// The state of guided_mega_train.py:199-222; rad must be zero.
__global__ void train_init_kernel(rlrpt::MegaParams p, float* fs, int* is,
                                  float* rad, float* path_sum, int* iters) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.n_slots) return;
  const size_t n = p.n_slots;
  store_slot(rlrpt::start_slot(p, slot), fs, is, rad, path_sum, p, slot);
  fs[kBrdf * n + slot] = 0.f;    // pending brdf (lum/pi)
  fs[kTd * n + slot] = 0.f;      // TD scatter count
  is[kBin * n + slot] = 0;       // pending bin
  is[kSec * n + slot] = -1;      // pending sector; -1: none
  iters[slot] = 0;
}

// Iteration it1 of every slot: closest hit, the pending transition's TD
// target into (sum_t, cnt), then B3's step; alive[it1] = 1 if a slot is
// still active after it.
__global__ void __launch_bounds__(kBlock) train_step_kernel(
    rlrpt::MegaParams p, TrainParams tp, uint32_t it1,
    const float4* __restrict__ tris, const float* __restrict__ mat,
    const __nv_bfloat16* __restrict__ cdf, const float* __restrict__ irr,
    float* __restrict__ sum_t, float* __restrict__ cnt,
    float* __restrict__ fs, int* __restrict__ is, float* __restrict__ rad,
    float* __restrict__ path_sum, int* __restrict__ iters,
    int* __restrict__ alive) {
  __shared__ float4 s_tri[3 * rlrpt::kTileTris];
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = p.n_slots;
  const bool act = slot < p.n_slots && is[kAct * n + slot] != 0;
  if (!__syncthreads_or(act)) return;   // the block's slots are all idle

  rlrpt::Slot s{};
  if (act) s = load_slot(fs, is, rad, path_sum, p, slot);
  const rlrpt::Hit h = rlrpt::sweep(tris, s_tri, p.n_tris, false, act, s.ox,
                                    s.oy, s.oz, s.dx, s.dy, s.dz);
  if (act) {
    int cur_sec = is[kSec * n + slot];
    int cur_bin = is[kBin * n + slot];
    float cur_brdf = fs[kBrdf * n + slot];
    rlrpt::CdfSampler sample{cdf, -1};
    const rlrpt::StepEvent ev =
        rlrpt::advance(p, mat, sample, h, it1, s, rad, slot);
    const int col = ev.missed ? 0 : rlrpt::bin_column(h, p.uv_bins);
    if (cur_sec >= 0) {   // the pending transition completes here
      const float target =
          ev.missed      ? cur_brdf * p.env
          : ev.hit_light ? cur_brdf * __ldg(ev.m + 10)
                         : cur_brdf * irr[col];
      const size_t cell = static_cast<size_t>(cur_sec) * tp.n_cols + cur_bin;
      atomicAdd(sum_t + cell, target);
      atomicAdd(cnt + cell, 1.f);
      fs[kTd * n + slot] += 1.f;
    }
    if (ev.survive) {   // the transition just sampled is now pending
      cur_bin = col;
      cur_sec = sample.sector;
      cur_brdf = __ldg(ev.m + 10) / static_cast<float>(rlrpt::kPiD);
    } else {
      cur_sec = -1;
    }
    store_slot(s, fs, is, rad, path_sum, p, slot);
    is[kSec * n + slot] = cur_sec;
    is[kBin * n + slot] = cur_bin;
    fs[kBrdf * n + slot] = cur_brdf;
    if (!s.act) iters[slot] = static_cast<int>(it1);
  }
  if (__any_sync(0xffffffffu, s.act) && (threadIdx.x & 31) == 0)
    alive[it1] = 1;
}

// Apply the iteration's (sum_t, cnt) to Q and V (guided_mega_train.py:
// 305-313), zero them, and refresh each column's irradiance
// sum_s Q*cos * lum * irr_scale (guided_mega_train.py:274-275).  A block
// takes 32 columns, one per lane, so every load is a 128-byte row
// segment; its kApplyWarps warps split the sectors and add their partial
// sums in shared memory.  (One thread per column walking all sectors took
// 63 us a launch on 5 SMs, more than the step kernel.)
constexpr int kApplyWarps = 16;

__global__ void __launch_bounds__(32 * kApplyWarps) train_apply_kernel(
    rlrpt::MegaParams p, TrainParams tp, const float* __restrict__ sec_cos,
    const float* __restrict__ lum, float* __restrict__ q,
    float* __restrict__ v, float* __restrict__ sum_t,
    float* __restrict__ cnt, float* __restrict__ irr) {
  __shared__ float part[kApplyWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < tp.n_cols) {
    for (int sec = warp; sec < p.n_sectors; sec += kApplyWarps) {
      const size_t i = static_cast<size_t>(sec) * tp.n_cols + c;
      float qs = q[i];
      const float nc = cnt[i];
      if (nc > 0.f) {
        const float vs = v[i];
        qs = fmaxf((qs * (1.f + vs) + sum_t[i]) / (1.f + vs + nc),
                   tp.radiance_threshold);
        q[i] = qs;
        v[i] = vs + nc;
        sum_t[i] = 0.f;
        cnt[i] = 0.f;
      }
      acc += qs * sec_cos[sec];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < tp.n_cols) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kApplyWarps; ++w) sum += part[w][lane];
    irr[c] = sum * lum[c] * tp.irr_scale;
  }
}

}  // namespace

// One learning frame.  tris, mat, cdf as rlrpt_mega_guided; lum (C,) and
// sec_cos (n_sectors,) f32; q, v (S_pad, C) f32, updated in place; sum_t, cnt
// (S_pad, C) f32 zeros; irr (C,) f32; fstate (11, n_slots) f32, istate
// (7, n_slots) i32; alive (max_iters + 1,) i32 zeros; rad (pix_mux,
// n_slots, 3) f32 zeros; path_sum (n_slots,) f32, iters (n_slots,) i32.
// Returns the first CUDA error, or 0.  Synchronises the stream every
// kCheckEvery iterations to read the alive flag.
extern "C" int rlrpt_mega_train(rlrpt::MegaParams p, rlrpt::TrainParams tp,
                                const void* tris, const void* mat,
                                const void* cdf, const void* lum,
                                const void* sec_cos, void* q, void* v,
                                void* sum_t, void* cnt, void* irr,
                                void* fstate, void* istate, void* alive,
                                void* rad, void* path_sum, void* iters,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (p.n_slots + kBlock - 1) / kBlock;
  const int col_blocks = (tp.n_cols + 31) / 32;
  auto* fs = static_cast<float*>(fstate);
  auto* is = static_cast<int*>(istate);
  auto* alive_i = static_cast<int*>(alive);
  auto apply = [&] {
    train_apply_kernel<<<col_blocks, 32 * kApplyWarps, 0, st>>>(
        p, tp, static_cast<const float*>(sec_cos),
        static_cast<const float*>(lum),
        static_cast<float*>(q), static_cast<float*>(v),
        static_cast<float*>(sum_t), static_cast<float*>(cnt),
        static_cast<float*>(irr));
  };
  train_init_kernel<<<blocks, kBlock, 0, st>>>(
      p, fs, is, static_cast<float*>(rad), static_cast<float*>(path_sum),
      static_cast<int*>(iters));
  apply();   // cnt is zero: the irradiance of the input Q
  int err = static_cast<int>(cudaGetLastError());
  for (int it = 1; it <= tp.max_iters && err == 0; ++it) {
    train_step_kernel<<<blocks, kBlock, 0, st>>>(
        p, tp, static_cast<uint32_t>(it), static_cast<const float4*>(tris),
        static_cast<const float*>(mat),
        static_cast<const __nv_bfloat16*>(cdf),
        static_cast<const float*>(irr), static_cast<float*>(sum_t),
        static_cast<float*>(cnt), fs, is, static_cast<float*>(rad),
        static_cast<float*>(path_sum), static_cast<int*>(iters), alive_i);
    apply();
    err = static_cast<int>(cudaGetLastError());
    if (err == 0 && it % kCheckEvery == 0) {
      int flag = 0;
      err = static_cast<int>(cudaMemcpyAsync(&flag, alive_i + it, sizeof(int),
                                             cudaMemcpyDeviceToHost, st));
      if (err == 0) err = static_cast<int>(cudaStreamSynchronize(st));
      if (err == 0 && flag == 0) break;
    }
  }
  return err;
}
