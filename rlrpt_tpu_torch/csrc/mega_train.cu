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
// iteration k-1; the steps add (target, 1) to global (sum_t, cnt) with
// atomicAdd; the apply then updates Q, V and the columns' irradiance and
// zeroes the accumulators.  The TPU kernel runs its ray tiles in order,
// each on the Q the last one left, and applies after every iteration of a
// tile; with one tile covering every slot the two schedules are the same.
// Counts are small integers in f32, so sum(V_out - V_in) equals the number
// of pending steps exactly.
//
// What bounds it on this card: B3's closest-hit sweep for the same paths,
// plus the per-iteration schedule: about 600 iterations per 720x720,
// 32-spp frame, each a step of the live slots, an apply over the
// (S, C) cells (the tables stay in L2: 320 KB each at Cornell, uv_bins 4)
// and two grid-wide barriers.
//
// What the design does about it: the whole frame is one cooperative,
// persistent launch (grid = the blocks that fit on the card at once), and
// the iteration loop runs on the device: step, grid barrier, apply spread
// over every warp of the grid, grid barrier, the "any slot alive" test.
// No host sync inside the frame and no idle iteration past its end.  Each
// block owns a fixed set of slots (32-slot groups spread over the image)
// and keeps the local ids of its live ones in shared memory, compacted
// after every step (warp ballots and a block scan), so its threads step
// only live slots.  The per-step state
// (origin, direction, throughput, bounce, remaining samples, pixel index
// k, pending sector and bin: 56 bytes a slot, 29 MB at 720x720) lives in
// device memory and stays in L2; the pending brdf is re-read from the
// pending bin's triangle, the pixel sums, path lengths, TD counts and
// iteration counts are written only when a path or the slot ends.  The
// paths do not depend on Q (the sector comes from the frame-start CDF with
// B3's sampler and RNG streams), so image, path_sum and iters are B3's bit
// for bit; the TPU's bf16 hi/lo splits of targets and irradiance are gone:
// kernel and twin compute in plain f32.
#include <cooperative_groups.h>

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

namespace cg = cooperative_groups;
using rlrpt::kBlock;
using rlrpt::TrainParams;

constexpr int kSecChunk = 8;   // sectors per apply work item (one warp)

// Rows of the per-step slot state fstate (kNumF, n_slots) f32 and istate
// (kNumI, n_slots) i32.  A slot's pixel is slot + k * n_slots.
enum FRow { kOx, kOy, kOz, kDx, kDy, kDz, kTr, kTg, kTb, kNumF };
enum IRow { kBounce, kRemaining, kK, kSec, kBin, kNumI };

// The frame's buffers (rlrpt_mega_train documents each).
struct TrainBufs {
  const float4* tris;
  const float* mat;
  const __nv_bfloat16* cdf;
  const float* lum;
  const float* sec_cos;
  float *q, *v, *sum_t, *cnt;
  float* irr;   // (2, C) sum_s Q*cos; iteration it reads row it & 1
  float* fs;
  int* is;
  float *rad, *path_sum;
  int* iters;
  float* td;
  int* flags;   // (2,): some slot is alive after iteration it, at it & 1
  int per_block;   // slot ids a block owns (a multiple of 32)
};

// Block b owns the 32-slot groups b, b + G, b + 2G, ... (G = gridDim.x):
// its local id l is slot ((l / 32) * G + b) * 32 + l % 32.  Groups spread
// over the image, so the blocks' live counts stay alike and the grid
// barrier waits little on the slowest block; a warp's ids stay adjacent.
__device__ __forceinline__ int owned_slot(int local) {
  return ((local >> 5) * gridDim.x + blockIdx.x) * 32 + (local & 31);
}

__device__ __forceinline__ void store_state(const TrainBufs& b, size_t n,
                                            int slot, const rlrpt::Slot& s,
                                            int sec, int bin) {
  b.fs[kOx * n + slot] = s.ox;
  b.fs[kOy * n + slot] = s.oy;
  b.fs[kOz * n + slot] = s.oz;
  b.fs[kDx * n + slot] = s.dx;
  b.fs[kDy * n + slot] = s.dy;
  b.fs[kDz * n + slot] = s.dz;
  b.fs[kTr * n + slot] = s.tr;
  b.fs[kTg * n + slot] = s.tg;
  b.fs[kTb * n + slot] = s.tb;
  b.is[kBounce * n + slot] = s.bounce;
  b.is[kRemaining * n + slot] = s.remaining;
  b.is[kK * n + slot] = s.k;
  b.is[kSec * n + slot] = sec;
  b.is[kBin * n + slot] = bin;
}

__device__ __forceinline__ rlrpt::Slot load_state(const TrainBufs& b,
                                                  const rlrpt::MegaParams& p,
                                                  int slot, int& sec,
                                                  int& bin) {
  const size_t n = p.n_slots;
  rlrpt::Slot s;
  s.ox = b.fs[kOx * n + slot];
  s.oy = b.fs[kOy * n + slot];
  s.oz = b.fs[kOz * n + slot];
  s.dx = b.fs[kDx * n + slot];
  s.dy = b.fs[kDy * n + slot];
  s.dz = b.fs[kDz * n + slot];
  s.tr = b.fs[kTr * n + slot];
  s.tg = b.fs[kTg * n + slot];
  s.tb = b.fs[kTb * n + slot];
  s.bounce = b.is[kBounce * n + slot];
  s.remaining = b.is[kRemaining * n + slot];
  s.k = b.is[kK * n + slot];
  s.pix = slot + s.k * p.n_slots;
  s.act = true;
  sec = b.is[kSec * n + slot];
  bin = b.is[kBin * n + slot];
  return s;
}

// Exclusive prefix of `flag` over the block, and the block's total.  Every
// thread of the block calls it; it may be called back to back.
__device__ __forceinline__ int block_scan(bool flag, int& total,
                                          int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const uint32_t bal = __ballot_sync(0xffffffffu, flag);
  __syncthreads();   // the last call's readers are done with s_warp
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int own = lane < n_warps ? s_warp[lane] : 0;
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane < n_warps) s_warp[lane] = incl - own;
    if (lane == n_warps - 1) s_warp[32] = incl;
  }
  __syncthreads();
  total = s_warp[32];
  return s_warp[warp] + __popc(bal & rlrpt::lanes_below());
}

// One step of a live slot at iteration it1: the pending transition's TD
// target into (sum_t, cnt), then B3's step; the pixel, path-length and TD
// sums when the path ends.  Returns whether the slot is still active.
__device__ __forceinline__ bool step(const rlrpt::MegaParams& p,
                                     const TrainParams& tp,
                                     const TrainBufs& b, const float* irr,
                                     const rlrpt::Hit& h, uint32_t it1,
                                     int slot, rlrpt::Slot& s, int sec,
                                     int bin) {
  // cur_brdf = lum/pi of the surface the pending sector was drawn at:
  // column bin = tri * uv^2 + iu * uv + iv, so tri = bin / uv^2.
  const int uv2 = p.uv_bins * p.uv_bins;
  const float cur_brdf =
      sec >= 0 ? __ldg(b.mat + 16 * (bin / uv2) + 10)
                     / static_cast<float>(rlrpt::kPiD)
               : 0.f;
  rlrpt::CdfSampler sample{b.cdf, -1};
  const rlrpt::StepEvent ev = rlrpt::advance(p, b.mat, sample, h, it1, s);
  const int col = ev.missed ? 0 : rlrpt::bin_column(h, p.uv_bins);
  if (sec >= 0) {   // the pending transition completes here
    const float target =
        ev.missed      ? cur_brdf * p.env
        : ev.hit_light ? cur_brdf * __ldg(ev.m + 10)
                       : cur_brdf * (__ldcg(irr + col) * __ldg(b.lum + col)
                                     * tp.irr_scale);
    const size_t cell = static_cast<size_t>(sec) * tp.n_cols + bin;
    atomicAdd(b.sum_t + cell, target);
    atomicAdd(b.cnt + cell, 1.f);
  }
  if (ev.missed || ev.hit_light) {
    float* o = b.rad + 3 * (static_cast<size_t>(ev.k_old) * p.n_slots + slot);
    o[0] += ev.cr;
    o[1] += ev.cg;
    o[2] += ev.cb;
  }
  if (!ev.survive) {
    b.path_sum[slot] += ev.plen;
    // every step of the path after its first completed a transition
    b.td[slot] += static_cast<float>(ev.bounce_old);
  }
  if (s.act) {
    store_state(b, p.n_slots, slot, s, ev.survive ? sample.sector : -1,
                ev.survive ? col : bin);
  } else {
    b.iters[slot] = static_cast<int>(it1);
  }
  return s.act;
}

// Apply the iteration's (sum_t, cnt) to Q and V (guided_mega_train.py:
// 305-313), zero them, and add each column's sum_s Q*cos into irr_out
// (zero on entry; the step multiplies by lum * irr_scale,
// guided_mega_train.py:274-275).  A work item is 32 columns (a lane each,
// so every load is a 128-byte row segment) by kSecChunk sectors; the
// items are spread over every warp of the grid.
__device__ __forceinline__ void apply(const rlrpt::MegaParams& p,
                                      const TrainParams& tp,
                                      const TrainBufs& b, float* irr_out) {
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps_per_block;
  const int n_groups = (tp.n_cols + 31) / 32;
  const int n_items =
      n_groups * ((p.n_sectors + kSecChunk - 1) / kSecChunk);
  for (int item = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
       item < n_items; item += n_warps) {
    const int c = (item % n_groups) * 32 + lane;
    const int s0 = (item / n_groups) * kSecChunk;
    if (c >= tp.n_cols) continue;
    const int s1 = min(s0 + kSecChunk, p.n_sectors);
    float acc = 0.f;
    for (int sec = s0; sec < s1; ++sec) {
      const size_t i = static_cast<size_t>(sec) * tp.n_cols + c;
      float qs = b.q[i];
      const float nc = __ldcg(b.cnt + i);
      if (nc > 0.f) {
        const float vs = b.v[i];
        qs = fmaxf((qs * (1.f + vs) + __ldcg(b.sum_t + i)) / (1.f + vs + nc),
                   tp.radiance_threshold);
        b.q[i] = qs;
        b.v[i] = vs + nc;
        b.sum_t[i] = 0.f;
        b.cnt[i] = 0.f;
      }
      acc += qs * __ldg(b.sec_cos + sec);
    }
    atomicAdd(irr_out + c, acc);
  }
}

// B2's phase clock, in the timed build only (KERNEL_TIMED in
// ops/guided_mega_train.py): each block's thread 0 reads clock64() at the
// start and after each phase, sums the cycles in shared memory and at the
// end adds its row into clock (blocks, kClockCols) int64: the start (slot
// starts, first apply, first grid barrier), then over the iterations the
// step (with the compaction), the first grid barrier, the apply (to its
// block's last warp: the timed build waits for the block there) and the
// second grid barrier, the block's total, and its iterations.  The phases
// sum to the total but for the last iteration's flag test.  Every reading
// is one SM's own counter, so a row's shares need no clock conversion.
// apply() deals its items to the grid's warps in order, so where they are
// fewer than the warps only the first blocks apply, and the rest wait for
// them at the second barrier: the row of the block with the most apply
// cycles is the one the frame's length follows.
enum ClockCol {
  kStartCyc, kStepCyc, kWait1Cyc, kApplyCyc, kWait2Cyc, kTotalCyc, kIters,
  kClockCols
};

__device__ __forceinline__ long long* clock_sums() {
  __shared__ long long s[kClockCols + 1];   // the sums, the last reading
  return s;
}

template <bool kTimed>
__device__ __forceinline__ void clock_begin() {
  if constexpr (kTimed) {
    if (threadIdx.x == 0) {
      long long* s = clock_sums();
      for (int j = 0; j < kClockCols; ++j) s[j] = 0;
      s[kClockCols] = clock64();
      s[kTotalCyc] = -s[kClockCols];
    }
  }
}

// Add the cycles since the last reading to column col.
template <bool kTimed>
__device__ __forceinline__ void clock_mark(int col) {
  if constexpr (kTimed) {
    if (threadIdx.x == 0) {
      long long* s = clock_sums();
      const long long now = clock64();
      s[col] += now - s[kClockCols];
      s[kClockCols] = now;
      if (col == kWait2Cyc) s[kIters] += 1;
    }
  }
}

template <bool kTimed>
__device__ __forceinline__ void clock_end(long long* clock) {
  if constexpr (kTimed) {
    if (threadIdx.x == 0) {
      long long* s = clock_sums();
      s[kTotalCyc] += clock64();
      long long* row = clock + static_cast<size_t>(blockIdx.x) * kClockCols;
      for (int j = 0; j < kClockCols; ++j) row[j] += s[j];
    }
  }
}

// The whole learning frame; launched cooperatively (grid.sync).  Block b
// owns per_block slot ids (owned_slot); dynamic shared memory holds the
// local ids of its live slots (per_block ints).  Eight blocks an SM (1,056
// on the H100) cap it at 64 registers a thread.  kTimed adds the phase
// clock.
template <bool kTimed>
__device__ __forceinline__ void train_frame(const rlrpt::MegaParams& p,
                                            const TrainParams& tp,
                                            const TrainBufs& b,
                                            long long* clock) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int s_live[];
  __shared__ float4 s_tri[3 * rlrpt::kTileTris];
  __shared__ int s_warp[33];
  clock_begin<kTimed>();
  const bool resident = p.n_tris <= rlrpt::kTileTris;
  if (resident) rlrpt::load_tile(s_tri, b.tris, 0, p.n_tris);
  __syncthreads();

  // Start the block's slots; the live list takes the ones in the image.
  int count = 0;   // the same in every thread of the block
  for (int base = 0; base < b.per_block; base += blockDim.x) {
    const int local = base + threadIdx.x;
    const int slot = owned_slot(local);
    bool live = false;
    if (local < b.per_block && slot < p.n_slots) {
      const rlrpt::Slot s = rlrpt::start_slot(p, slot);
      live = s.act;
      if (live) store_state(b, p.n_slots, slot, s, -1, 0);
    }
    int total;
    const int pos = block_scan(live, total, s_warp);
    if (live) s_live[count + pos] = local;
    count += total;
  }
  apply(p, tp, b, b.irr + tp.n_cols);   // cnt is zero: the input Q's sums
  grid.sync();
  clock_mark<kTimed>(kStartCyc);

  for (int it1 = 1; it1 <= tp.max_iters; ++it1) {
    const float* irr = b.irr + (it1 & 1) * tp.n_cols;
    float* irr_next = b.irr + ((it1 + 1) & 1) * tp.n_cols;
    // irr_next was last read by the step of iteration it1 - 1
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < tp.n_cols;
         c += gridDim.x * blockDim.x)
      irr_next[c] = 0.f;

    // Step the live slots, blockDim at a time, and compact the list in
    // place: a kept id moves to a position at or before its own, and the
    // scan's barrier comes after every thread has read its chunk's ids.
    int kept = 0;
    for (int base = 0; base < count; base += blockDim.x) {
      const int idx = base + threadIdx.x;
      const bool have = idx < count;
      const int local = have ? s_live[idx] : 0;
      const int slot = owned_slot(local);
      int sec = -1, bin = 0;
      rlrpt::Slot s{};
      if (have) s = load_state(b, p, slot, sec, bin);
      const rlrpt::Hit h = rlrpt::sweep(b.tris, s_tri, p.n_tris, resident,
                                        have, s.ox, s.oy, s.oz, s.dx, s.dy,
                                        s.dz);
      const bool alive =
          have && step(p, tp, b, irr, h, it1, slot, s, sec, bin);
      int total;
      const int pos = block_scan(alive, total, s_warp);
      if (alive) s_live[kept + pos] = local;
      kept += total;
    }
    count = kept;
    if (count > 0 && threadIdx.x == 0) b.flags[it1 & 1] = 1;
    clock_mark<kTimed>(kStepCyc);
    grid.sync();
    clock_mark<kTimed>(kWait1Cyc);
    // flags[(it1 + 1) & 1] was last read after iteration it1 - 1's apply
    if (blockIdx.x == 0 && threadIdx.x == 0) b.flags[(it1 + 1) & 1] = 0;
    apply(p, tp, b, irr_next);
    if constexpr (kTimed) __syncthreads();
    clock_mark<kTimed>(kApplyCyc);
    grid.sync();
    clock_mark<kTimed>(kWait2Cyc);
    if (__ldcg(b.flags + (it1 & 1)) == 0) break;
  }
  clock_end<kTimed>(clock);
}

// The plain build and the timed one: overloads of one name, so a trace
// names both train_kernel.
__global__ void __launch_bounds__(kBlock, 8)
    train_kernel(rlrpt::MegaParams p, TrainParams tp, TrainBufs b) {
  train_frame<false>(p, tp, b, nullptr);
}

__global__ void __launch_bounds__(kBlock, 8)
    train_kernel(rlrpt::MegaParams p, TrainParams tp, TrainBufs b,
                 long long* clock) {
  train_frame<true>(p, tp, b, clock);
}

using PlainKernel = void (*)(rlrpt::MegaParams, TrainParams, TrainBufs);
using TimedKernel = void (*)(rlrpt::MegaParams, TrainParams, TrainBufs,
                             long long*);

const void* train_kernel_ptr(bool timed) {
  return timed ? reinterpret_cast<const void*>(
                     static_cast<TimedKernel>(train_kernel))
               : reinterpret_cast<const void*>(
                     static_cast<PlainKernel>(train_kernel));
}

// train_kernel's grid (the plain or the timed build): the blocks that fit
// on the card at once with per_block ints of dynamic shared memory each,
// and no more than the slots need; per_block covers the block's 32-slot
// groups.  Returns a CUDA error, or 0.
int train_grid(bool timed, int n_slots, int& blocks, int& per_block,
               size_t& smem) {
  const void* kernel = train_kernel_ptr(timed);
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  blocks = std::max(1, (n_slots + kBlock - 1) / kBlock);
  for (int round = 0; err == 0 && round < 8; ++round) {
    const int groups = (n_slots + 31) / 32;
    per_block = 32 * ((groups + blocks - 1) / blocks);
    smem = static_cast<size_t>(per_block) * sizeof(int);
    if (smem > 48 * 1024)
      err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
    if (err == 0)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kBlock, smem));
    if (err == 0 && per_sm == 0)
      err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    if (err != 0 || blocks <= per_sm * sms) break;
    blocks = per_sm * sms;
  }
  return err;
}

}  // namespace

// One learning frame, one cooperative launch.  tris, mat, cdf as
// rlrpt_mega_guided; lum (C,) and sec_cos (n_sectors,) f32; q, v (S_pad, C)
// f32, updated in place; sum_t, cnt (S_pad, C) f32 zeros; irr (2, C) f32
// zeros; fstate (9, n_slots) f32, istate (5, n_slots) i32 (no values
// needed); flags (2,) i32 zeros; rad (pix_mux, n_slots, 3), path_sum
// (n_slots,), td (n_slots,) f32 zeros; iters (n_slots,) i32 zeros; clock
// null (the plain build), or (blocks, kClockCols) int64 (the timed build,
// which adds its phase cycles; blocks from rlrpt_train_blocks(n_slots)).
// Returns the first CUDA error, or 0: cudaErrorCooperativeLaunchTooLarge
// if the grid cannot be co-resident.  Does not synchronise.
extern "C" int rlrpt_mega_train(rlrpt::MegaParams p, rlrpt::TrainParams tp,
                                const void* tris, const void* mat,
                                const void* cdf, const void* lum,
                                const void* sec_cos, void* q, void* v,
                                void* sum_t, void* cnt, void* irr,
                                void* fstate, void* istate, void* flags,
                                void* rad, void* path_sum, void* iters,
                                void* td, void* clock, void* stream) {
  const bool timed = clock != nullptr;
  int blocks = 0, per_block = 0;
  size_t smem = 0;
  int err = train_grid(timed, p.n_slots, blocks, per_block, smem);
  if (err != 0) return err;
  TrainBufs b{static_cast<const float4*>(tris),
              static_cast<const float*>(mat),
              static_cast<const __nv_bfloat16*>(cdf),
              static_cast<const float*>(lum),
              static_cast<const float*>(sec_cos),
              static_cast<float*>(q), static_cast<float*>(v),
              static_cast<float*>(sum_t), static_cast<float*>(cnt),
              static_cast<float*>(irr), static_cast<float*>(fstate),
              static_cast<int*>(istate), static_cast<float*>(rad),
              static_cast<float*>(path_sum), static_cast<int*>(iters),
              static_cast<float*>(td), static_cast<int*>(flags), per_block};
  long long* clock_rows = static_cast<long long*>(clock);
  void* args[] = {&p, &tp, &b, &clock_rows};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      train_kernel_ptr(timed), dim3(blocks), dim3(kBlock), args, smem,
      static_cast<cudaStream_t>(stream)));
  const int last = static_cast<int>(cudaGetLastError());   // clears it
  return err != 0 ? err : last;
}

// *blocks_out receives the block count of the grid rlrpt_mega_train's
// timed build launches for n_slots slots: the rows of its clock.  Returns
// a CUDA error, or 0.
extern "C" int rlrpt_train_blocks(int n_slots, int* blocks_out) {
  int blocks = 0, per_block = 0;
  size_t smem = 0;
  const int err = train_grid(true, n_slots, blocks, per_block, smem);
  if (err == 0) *blocks_out = blocks;
  return err;
}
