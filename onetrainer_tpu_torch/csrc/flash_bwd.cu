// Folded-layout flash-attention backward for Hopper (sm_90a): K2 (dq), K3
// (dk, dv) and K3's delta pre-pass.
//
// Replaces, in onetrainer_tpu/ops/flash_folded.py (all launched by `_bwd`):
//   K2  _dq_kernel          (:196, launch :401)  -> flash_bwd_dq_kernel
//   K3a _dkv_kernel         (:248, launch :447)  -> flash_bwd_dkv_kernel
//   K3b _dkv_stream_kernel  (:305, launch :494)     (one kernel for both)
// Each TPU kernel recomputes delta per block; here flash_bwd_delta_kernel
// writes delta [B, H, Sq] once per backward, and K2 and K3 read it.
// It computes the same function as the TPU kernels, not the same blocks.
// With S = q k^T * sm_scale + bias[b, j], P = exp(S - lse) (lse saved by
// the forward, csrc/flash_fwd.cu), delta_i = sum_d dO[i, d] * O[i, d]:
//
//   dS = P * (dO v^T - delta) * sm_scale      (rounded to bf16, as the TPU
//                                              kernels round it to k.dtype)
//   dq = dS k,   dk = dS^T q,   dv = bf16(P)^T dO
//
// over packed [B, S, H*d] bf16 tensors, non-causal, optional fp32 kv bias
// (0 keep / -1e30 drop). The bias gets no gradient. Heads are read by
// stride from the packed layout; a runtime d <= 128 (d % 8 == 0) sits in a
// 64- or 128-wide slot whose lanes past d are zero-filled on load; ragged
// Sq/Skv are masked in the kernel.
//
// K2: grid (ceil(Sq/128), H, B), 256 threads = two warpgroups of 64 q rows
// each. Bound by tensor-core FLOPs: 6*B*H*Sq*Skv*d (S = q k^T, dP = dO v^T,
// dq = dS k) against ~5 bf16 [B, S, H*d] tensors of traffic, far above the
// H100's ~295 FLOP/byte ridge at SDXL's S = 1024 and 4096, d = 64. So the
// design feeds the tensor cores: TMA copies the block's q and dO rows once
// into 128-byte-swizzled panels, and K and V tiles of 64 kv rows stream
// through a 4-stage TMA ring on mbarriers, refilled by one thread once all
// 256 threads have released a stage (no block barrier in the loop, the
// warpgroups drift apart and one's exponentials overlap the other's
// products). Per kv tile each warpgroup issues S = q K^T and dP = dO V^T as
// wgmma from shared memory, forms P = exp2(S*scale*log2e + bias - lse) and
// dS = P (dP - delta) * scale in registers (bias read once per column, kv
// columns past Skv get P = 0), packs dS to bf16 and feeds it as the register
// A operand of dq += dS K, K being the MN-major B (the same tile that served
// S as a K-major B). The next tile's S and dP are issued with this tile's
// dq product, and its dS formed while dq runs. delta comes from
// flash_bwd_delta_kernel, shared with K3; lse and delta of a thread's two
// rows sit in registers. No atomics: dq sums over kv tiles in a fixed order
// (deterministic).
//
// K3, flash_bwd_dkv_kernel: grid (ceil(Skv/128), H, B), 256 threads = two
//   warpgroups of 64 kv rows each. K and V rows stay in swizzled shared
//   memory; q, dO, lse and delta tiles of 64 q rows stream through a
//   4-stage TMA ring (csrc/hopper_mma.cuh) that completes on mbarriers, so
//   tiles t+1..t+3 land while tile t computes. One thread issues the
//   copies; a stage is refilled once all 256 threads have released it, so
//   the warpgroups drift apart by up to a tile and never wait at a block
//   barrier. Per q tile each warpgroup runs four wgmma
//   products: S^T = K q^T and dP^T = V dO^T from shared memory, then
//   P^T = exp(S^T*scale + bias - lse) and dS^T in registers, packed to bf16
//   and fed back as the A operand of dV += P^T dO and dK += dS^T q (dO, q as
//   MN-major B). Computing the transposed scores is what lets the
//   accumulator serve as the A operand with no data movement. dk and dv
//   stay in fp32 registers and are written once. No atomics and no
//   sequence threshold: the TPU's resident / streaming split (6144 tokens)
//   is a VMEM limit that a loop inside the block does not have, so one
//   kernel covers K3a and K3b, and its sums run in a fixed order
//   (deterministic from run to run).
//
// Bound: K3 does 8*B*H*Sq*Skv*d FLOPs against ~7 bf16 [B, S, H*d] tensors
// of traffic; at SDXL's S=4096 (and 1024), d=64 that is far above the
// H100's ~295 FLOP/byte ridge, so tensor-core FLOPs bound it: at 989
// TFLOP/s, B2 S4096 H10 d64 takes >= 0.174 ms, B2 S1024 H20 d64 >= 0.022
// ms. The pre-pass moves 2 bf16 [B, Sq, H*d] tensors and is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ K2: dq

// kv rows per streamed tile, in both slots
constexpr int kBlockKv = 64;

template <int DSLOT>
struct DqLayout {
  static constexpr int kQRows = 128;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 4;
  static constexpr int kQTile = kQRows * DSLOT * 2;      // bytes of q (or dO)
  static constexpr int kKvTile = kBlockKv * DSLOT * 2;   // bytes of K (or V)
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  static constexpr int kK = kDo + kQTile;                // kStages K tiles
  static constexpr int kV = kK + kStages * kKvTile;      // kStages V tiles
  static constexpr int kFull = kV + kStages * kKvTile;   // kStages mbarriers
  static constexpr int kEmpty = kFull + kStages * 8;     // kStages mbarriers
  static constexpr int kQBar = kEmpty + kStages * 8;
  static constexpr int kBytes = kQBar + 8;
  // + slack to align the dynamic shared memory to one swizzle atom
  static constexpr size_t kSmemBytes = kBytes + hopper::kAtomBytes;
};

// One block per SM in both slots (64 slot: 164 registers, 128 slot: 216, no
// spills). Capped at 128 registers for two blocks per SM, the 64 slot
// spilled, with each tile's products in turn or with the overlap below,
// and was no faster at S = 1024.
template <int DSLOT>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,    // box 128 rows
                    const __grid_constant__ CUtensorMap do_map,   // box 128 rows
                    const __grid_constant__ CUtensorMap k_map,    // box 64 rows
                    const __grid_constant__ CUtensorMap v_map,    // box 64 rows
                    const float* __restrict__ lse,     // [B, H, Sq]
                    const float* __restrict__ delta,   // [B, H, Sq]
                    const float* __restrict__ bias,    // [B, Skv] or nullptr
                    __nv_bfloat16* __restrict__ dq,
                    int sq, int skv, int num_heads, int d, float sm_scale) {
  using L = DqLayout<DSLOT>;
  using hopper::Wgmma;
  constexpr int BK = kBlockKv;
  constexpr int kDSteps = DSLOT / 16;   // k-steps of S and dP
  constexpr int kKSteps = BK / 16;      // k-steps of dq

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + hopper::kAtomBytes - 1) & ~(hopper::kAtomBytes - 1);

  const int tid = threadIdx.x;
  const int wg = tid / 128;             // consumer warpgroup: q rows wg*64..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;

  const int q0 = blockIdx.x * L::kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = num_heads * d;
  const size_t q_head = static_cast<size_t>(b) * sq * inner + static_cast<size_t>(h) * d;
  const size_t bh = (static_cast<size_t>(b) * num_heads + h) * sq;
  const float* bias_row = bias ? bias + static_cast<size_t>(b) * skv : nullptr;
  const int nk = (skv + BK - 1) / BK;

  // kv tile t (K and V, DSLOT/64 panels each) into ring stage t % kStages
  // by TMA; one thread issues it
  auto issue_kv_tile = [&](int t) {
    const int s = t % L::kStages;
    const uint32_t full = base + L::kFull + 8 * s;
    hopper::mbar_arrive_expect_tx(full, 2 * L::kKvTile);
#pragma unroll
    for (int p = 0; p < DSLOT / 64; ++p) {
      const uint32_t off = s * L::kKvTile + p * BK * hopper::kSwizzleBytes;
      hopper::tma_load_4d(base + L::kK + off, &k_map, full, 64 * p, h, t * BK, b);
      hopper::tma_load_4d(base + L::kV + off, &v_map, full, 64 * p, h, t * BK, b);
    }
  };

  const int lead = nk < L::kStages ? nk : L::kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(base + L::kFull + 8 * s, 1);
      hopper::mbar_init(base + L::kEmpty + 8 * s, L::kThreads);
    }
    hopper::mbar_init(base + L::kQBar, 1);
    hopper::mbar_init_fence();
    hopper::mbar_arrive_expect_tx(base + L::kQBar, 2 * L::kQTile);
#pragma unroll
    for (int p = 0; p < DSLOT / 64; ++p) {
      const uint32_t off = p * L::kQRows * hopper::kSwizzleBytes;
      hopper::tma_load_4d(base + L::kQ + off, &q_map, base + L::kQBar, 64 * p, h, q0, b);
      hopper::tma_load_4d(base + L::kDo + off, &do_map, base + L::kQBar, 64 * p, h, q0, b);
    }
    for (int t = 0; t < lead; ++t) issue_kv_tile(t);
  }

  // this thread's q rows (q0 + wg*64 + warp*16 + g + 8r): lse in log2
  // units and delta; rows past Sq are zero-filled and never stored
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  float lse_l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < sq) {
      lse_l2[r] = lse[bh + row] * kLog2e;
      dl[r] = delta[bh + row];
    }
  }
  const float scale_l2 = sm_scale * kLog2e;

  // this warpgroup's 64 rows of q and dO (K-major A operands)
  const uint32_t q_rows = base + L::kQ + wg * 64 * hopper::kSwizzleBytes;
  const uint32_t do_rows = base + L::kDo + wg * 64 * hopper::kSwizzleBytes;
  constexpr uint32_t kQPanel = L::kQRows * hopper::kSwizzleBytes;
  constexpr uint32_t kKvPanel = BK * hopper::kSwizzleBytes;

  // S = q K^T and dP = dO V^T of kv tile t, 64 q rows x BK kv columns:
  // two asynchronous groups, S first
  auto issue_scores = [&](float (&s)[BK / 2], float (&dp)[BK / 2], int t) {
    const uint32_t k_tile = base + L::kK + (t % L::kStages) * L::kKvTile;
    const uint32_t v_tile = base + L::kV + (t % L::kStages) * L::kKvTile;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const uint32_t off = (ks / 4) * kQPanel + (ks % 4) * 32;
      const uint32_t kv_off = (ks / 4) * kKvPanel + (ks % 4) * 32;
      Wgmma<BK>::ss(s, hopper::desc_k_major(q_rows + off),
                    hopper::desc_k_major(k_tile + kv_off), ks > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const uint32_t off = (ks / 4) * kQPanel + (ks % 4) * 32;
      const uint32_t kv_off = (ks / 4) * kKvPanel + (ks % 4) * 32;
      Wgmma<BK>::ss(dp, hopper::desc_k_major(do_rows + off),
                    hopper::desc_k_major(v_tile + kv_off), ks > 0);
    }
    hopper::wgmma_commit();
  };

  // P = exp(S * scale + bias - lse) in s; kv columns past Skv get a bias of
  // -inf, so P = 0 there exactly
  auto probs = [&](float (&s)[BK / 2], int t) {
    const int kv0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float bj[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + 8 * j + 2 * c + e;
        bj[e] = col >= skv ? __int_as_float(0xff800000)
                           : (bias_row ? __ldg(bias_row + col) * kLog2e : 0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = hopper::exp2_approx(
            fmaf(s[4 * j + e], scale_l2, bj[e & 1] - lse_l2[e >> 1]));
      }
    }
  };

  // dS = P (dP - delta) * scale in dp (fp32; rounded to bf16 by acc_to_a)
  auto dscores = [&](const float (&p)[BK / 2], float (&dp)[BK / 2]) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = p[i] * (dp[i] - dl[(i >> 1) & 1]) * sm_scale;
  };

  float acc[DSLOT / 2];
#pragma unroll
  for (int i = 0; i < DSLOT / 2; ++i) acc[i] = 0.f;

  // dq += bf16(dS) K of kv tile t (asynchronous; K is a MN-major B)
  auto issue_dq = [&](const uint32_t (&dsa)[kKSteps][4], int t) {
    const uint32_t k_tile = base + L::kK + (t % L::kStages) * L::kKvTile;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      Wgmma<DSLOT>::rs(acc, dsa[kk],
                       hopper::desc_mn_major(k_tile + kk * 16 * hopper::kSwizzleBytes, kKvPanel),
                       1);
    }
    hopper::wgmma_commit();
  };

  __syncthreads();   // the barriers are initialised
  auto wait_tile = [&](int t) {
    hopper::mbar_wait(base + L::kFull + 8 * (t % L::kStages), (t / L::kStages) & 1);
  };
  // thread 0 refills the stage of tile t-1 once every thread released it
  auto refill = [&](int t) {
    if (tid == 0 && t >= 1 && t - 1 + L::kStages < nk) {
      const int s = (t - 1) % L::kStages;
      hopper::mbar_wait(base + L::kEmpty + 8 * s, ((t - 1) / L::kStages) & 1);
      issue_kv_tile(t - 1 + L::kStages);
    }
  };
  // every thread is done with tile t's stage (K read by S and dq, V by dP)
  auto release_tile = [&](int t) {
    hopper::mbar_arrive(base + L::kEmpty + 8 * (t % L::kStages));
  };
  hopper::mbar_wait(base + L::kQBar, 0);

  // tile 0's scores; then step t issues tile t+1's S and dP with tile t's
  // dq product and forms tile t+1's dS while dq runs; the last tile's dq
  // product follows the loop (no wgmma is issued under a condition)
  float s[BK / 2], dp[BK / 2];
  uint32_t dsa[kKSteps][4];
  wait_tile(0);
  hopper::wgmma_fence();
  issue_scores(s, dp, 0);
  hopper::wgmma_wait<1>();
  hopper::fence_regs(s);
  probs(s, 0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dp);
  dscores(s, dp);
  hopper::acc_to_a<BK / 2>(dsa, dp);
  for (int t = 0; t + 1 < nk; ++t) {
    refill(t);
    wait_tile(t + 1);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(dsa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_scores(s, dp, t + 1);
    issue_dq(dsa, t);
    hopper::wgmma_wait<2>();   // S; dP and dq may still run
    hopper::fence_regs(s);
    probs(s, t + 1);
    hopper::wgmma_wait<1>();   // dP
    hopper::fence_regs(dp);
    dscores(s, dp);
    hopper::wgmma_wait<0>();   // dq: dsa is free again
    hopper::fence_regs(acc);
    hopper::fence_regs(dsa);
    release_tile(t);
    hopper::acc_to_a<BK / 2>(dsa, dp);
  }
  hopper::fence_regs(dsa);
  hopper::wgmma_fence();
  issue_dq(dsa, nk - 1);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // rows past Sq and lanes past d are never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dq_row = dq + q_head + static_cast<size_t>(row) * inner;
#pragma unroll
    for (int j = 0; j < DSLOT / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dq_row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------- K3 pre-pass: delta

// delta[b, h, i] = sum_d dO[b, i, h*d + d'] * O[b, i, h*d + d'] in fp32, one
// thread per (row, head), 16-byte loads.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta,   // [B, H, Sq]
                       int rows, int sq, int num_heads, int d) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * num_heads) return;
  const int row = idx / num_heads;   // b * sq + i
  const int h = idx % num_heads;
  const size_t off = static_cast<size_t>(row) * num_heads * d + static_cast<size_t>(h) * d;
  float sum = 0.f;
  for (int col = 0; col < d; col += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off + col);
    const uint4 b = *reinterpret_cast<const uint4*>(o + off + col);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]);
      const float2 fb = __bfloat1622float2(b2[i]);
      sum += fa.x * fb.x + fa.y * fb.y;
    }
  }
  const int b = row / sq;
  delta[(static_cast<size_t>(b) * num_heads + h) * sq + row % sq] = sum;
}

// -------------------------------------------------------------- K3: dk, dv

// q rows per streamed tile, in both slots: in the 128 slot two 64x128 fp32
// accumulators, S^T and dP^T take 245 registers, with no spills
constexpr int kBlockQ = 64;

// One block: 128 kv rows of one (batch, head), two consumer warpgroups of
// 64 kv rows each; q, dO, lse and delta stream through a 4-stage TMA ring
// of BQ-row tiles.
template <int DSLOT>
struct DkvLayout {
  static constexpr int BQ = kBlockQ;
  static constexpr int kKvRows = 128;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 4;
  static constexpr int kKvTile = kKvRows * DSLOT * 2;   // bytes of K (or V)
  static constexpr int kQTile = BQ * DSLOT * 2;         // bytes of q (or dO)
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvTile;
  static constexpr int kQ = kV + kKvTile;               // kStages q tiles
  static constexpr int kDo = kQ + kStages * kQTile;     // kStages dO tiles
  // lse and delta boxes start at a 16-byte aligned element (TMA needs it),
  // up to 3 values before the tile: BQ + 4 values, 128-byte aligned stages
  static constexpr int kStatBox = BQ + 4;
  static constexpr int kStatStride = (kStatBox * 4 + 127) / 128 * 128;
  static constexpr int kLse = kDo + kStages * kQTile;   // kStages lse boxes
  static constexpr int kDelta = kLse + kStages * kStatStride;
  static constexpr int kFull = kDelta + kStages * kStatStride;   // kStages mbarriers
  static constexpr int kEmpty = kFull + kStages * 8;        // kStages mbarriers
  static constexpr int kKvBar = kEmpty + kStages * 8;
  static constexpr int kBytes = kKvBar + 8;
  static constexpr uint32_t kStageTx = 2 * kQTile + 2 * kStatBox * 4;   // TMA bytes per stage
  // + slack to align the dynamic shared memory to one swizzle atom
  static constexpr size_t kSmemBytes = kBytes + hopper::kAtomBytes;
};

template <int DSLOT>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,    // box BQ rows
                     const __grid_constant__ CUtensorMap do_map,   // box BQ rows
                     const __grid_constant__ CUtensorMap k_map,    // box 128 rows
                     const __grid_constant__ CUtensorMap v_map,    // box 128 rows
                     const __grid_constant__ CUtensorMap lse_map,  // [B*H*Sq] fp32
                     const __grid_constant__ CUtensorMap delta_map,
                     const float* __restrict__ bias,    // [B, Skv] or nullptr
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int sq, int skv, int num_heads, int d, float sm_scale) {
  using L = DkvLayout<DSLOT>;
  using hopper::Wgmma;
  constexpr int BQ = kBlockQ;
  constexpr int kDSteps = DSLOT / 16;   // k-steps of S^T and dP^T
  constexpr int kQSteps = BQ / 16;      // k-steps of dV and dK

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + hopper::kAtomBytes - 1) & ~(hopper::kAtomBytes - 1);
  const unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;             // consumer warpgroup: kv rows wg*64..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;

  const int kv0 = blockIdx.x * L::kKvRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = num_heads * d;
  const size_t kv_head = static_cast<size_t>(b) * skv * inner + static_cast<size_t>(h) * d;
  // lse and delta of this head start here in their flat [B*H*Sq] maps; a
  // box also holds values of neighbouring rows and heads, which the offsets
  // skip or the mask of q columns past Sq discards
  const int bh = (b * num_heads + h) * sq;
  const int nq = (sq + BQ - 1) / BQ;

  // q tile t (q, dO: DSLOT/64 panels each; lse, delta) into ring stage
  // t % kStages by TMA; one thread issues it
  auto issue_q_tile = [&](int t) {
    const int s = t % L::kStages;
    const uint32_t full = base + L::kFull + 8 * s;
    hopper::mbar_arrive_expect_tx(full, L::kStageTx);
#pragma unroll
    for (int p = 0; p < DSLOT / 64; ++p) {
      const uint32_t off = s * L::kQTile + p * BQ * hopper::kSwizzleBytes;
      hopper::tma_load_4d(base + L::kQ + off, &q_map, full, 64 * p, h, t * BQ, b);
      hopper::tma_load_4d(base + L::kDo + off, &do_map, full, 64 * p, h, t * BQ, b);
    }
    const int first = (bh + t * BQ) & ~3;
    hopper::tma_load_1d(base + L::kLse + s * L::kStatStride, &lse_map, full, first);
    hopper::tma_load_1d(base + L::kDelta + s * L::kStatStride, &delta_map, full, first);
  };

  const int lead = nq < L::kStages ? nq : L::kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(base + L::kFull + 8 * s, 1);
      hopper::mbar_init(base + L::kEmpty + 8 * s, L::kThreads);
    }
    hopper::mbar_init(base + L::kKvBar, 1);
    hopper::mbar_init_fence();
    hopper::mbar_arrive_expect_tx(base + L::kKvBar, 2 * L::kKvTile);
#pragma unroll
    for (int p = 0; p < DSLOT / 64; ++p) {
      const uint32_t off = p * L::kKvRows * hopper::kSwizzleBytes;
      hopper::tma_load_4d(base + L::kK + off, &k_map, base + L::kKvBar, 64 * p, h, kv0, b);
      hopper::tma_load_4d(base + L::kV + off, &v_map, base + L::kKvBar, 64 * p, h, kv0, b);
    }
    for (int t = 0; t < lead; ++t) issue_q_tile(t);
  }

  // this thread's kv rows (within the block: wg*64 + warp*16 + g + 8r), their
  // bias in log2 units
  const int my_row = wg * 64 + warp * 16 + g;
  float bias_l2[2] = {0.f, 0.f};
  if (bias) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + my_row + 8 * r;
      if (row < skv) bias_l2[r] = bias[static_cast<size_t>(b) * skv + row] * kLog2e;
    }
  }
  const float scale_l2 = sm_scale * kLog2e;

  float dk_acc[DSLOT / 2], dv_acc[DSLOT / 2];
#pragma unroll
  for (int i = 0; i < DSLOT / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // this warpgroup's 64 rows of K and V (K-major A operands)
  const uint32_t k_rows = base + L::kK + wg * 64 * hopper::kSwizzleBytes;
  const uint32_t v_rows = base + L::kV + wg * 64 * hopper::kSwizzleBytes;
  constexpr uint32_t kKvPanel = L::kKvRows * hopper::kSwizzleBytes;
  constexpr uint32_t kQPanel = BQ * hopper::kSwizzleBytes;

  __syncthreads();   // the barriers are initialised
  hopper::mbar_wait(base + L::kKvBar, 0);

  for (int t = 0; t < nq; ++t) {
    // thread 0 refills the stage of tile t-1 once every thread released it
    if (tid == 0 && t >= 1 && t - 1 + L::kStages < nq) {
      hopper::mbar_wait(base + L::kEmpty + 8 * ((t - 1) % L::kStages),
                        ((t - 1) / L::kStages) & 1);
      issue_q_tile(t - 1 + L::kStages);
    }
    const int s = t % L::kStages;
    hopper::mbar_wait(base + L::kFull + 8 * s, (t / L::kStages) & 1);

    const int q0 = t * BQ;
    const uint32_t q_tile = base + L::kQ + s * L::kQTile;
    const uint32_t do_tile = base + L::kDo + s * L::kQTile;

    // S^T = K Q^T and dP^T = V dO^T for 64 kv rows x BQ q columns
    float st[BQ / 2], dpt[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const uint32_t koff = (ks / 4) * kKvPanel + (ks % 4) * 32;
      const uint32_t qoff = (ks / 4) * kQPanel + (ks % 4) * 32;
      Wgmma<BQ>::ss(st, hopper::desc_k_major(k_rows + koff),
                    hopper::desc_k_major(q_tile + qoff), ks > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const uint32_t koff = (ks / 4) * kKvPanel + (ks % 4) * 32;
      const uint32_t qoff = (ks / 4) * kQPanel + (ks % 4) * 32;
      Wgmma<BQ>::ss(dpt, hopper::desc_k_major(v_rows + koff),
                    hopper::desc_k_major(do_tile + qoff), ks > 0);
    }
    hopper::wgmma_commit();

    // P^T = exp(S^T * scale + bias - lse), exactly 0 for q columns past Sq
    const int skip = (bh + q0) & 3;   // values before the tile in its box
    const float* lse_t =
        reinterpret_cast<const float*>(smem + L::kLse + s * L::kStatStride) + skip;
    const float* delta_t =
        reinterpret_cast<const float*>(smem + L::kDelta + s * L::kStatStride) + skip;
    const bool partial = q0 + BQ > sq;
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float l2[2] = {lse_t[8 * j + 2 * c] * kLog2e, lse_t[8 * j + 2 * c + 1] * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        const float x = fmaf(st[4 * j + e], scale_l2, bias_l2[e >> 1] - l2[e & 1]);
        float p = hopper::exp2_approx(x);
        if (partial && q0 + col >= sq) p = 0.f;
        st[4 * j + e] = p;
      }
    }
    uint32_t pa[kQSteps][4];
    hopper::acc_to_a<BQ / 2>(pa, st);

    // dS^T = P^T (dP^T - delta) * scale
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float dl[2] = {delta_t[8 * j + 2 * c], delta_t[8 * j + 2 * c + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl[e & 1]) * sm_scale;
      }
    }
    uint32_t dsa[kQSteps][4];
    hopper::acc_to_a<BQ / 2>(dsa, dpt);

    // dV += bf16(P^T) dO;  dK += bf16(dS^T) q  (dO and q are MN-major B)
    hopper::fence_regs(pa);
    hopper::fence_regs(dsa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      Wgmma<DSLOT>::rs(dv_acc, pa[kk],
                       hopper::desc_mn_major(do_tile + kk * 16 * hopper::kSwizzleBytes, kQPanel), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      Wgmma<DSLOT>::rs(dk_acc, dsa[kk],
                       hopper::desc_mn_major(q_tile + kk * 16 * hopper::kSwizzleBytes, kQPanel), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(dsa);
    hopper::mbar_arrive(base + L::kEmpty + 8 * s);   // this thread is done with stage s
  }


  // rows past Skv and lanes past d are never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + my_row + 8 * r;
    if (row >= skv) continue;
    __nv_bfloat16* dk_row = dk + kv_head + static_cast<size_t>(row) * inner;
    __nv_bfloat16* dv_row = dv + kv_head + static_cast<size_t>(row) * inner;
#pragma unroll
    for (int j = 0; j < DSLOT / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DSLOT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* bias, void* dq,
              int batch, int sq, int skv, int num_heads, int head_dim,
              float sm_scale, cudaStream_t stream) {
  using L = DqLayout<DSLOT>;
  // the dynamic shared memory limit, set once per template instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DSLOT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!hopper::head_map(&q_map, q, batch, sq, num_heads, head_dim, L::kQRows) ||
      !hopper::head_map(&do_map, dout, batch, sq, num_heads, head_dim, L::kQRows) ||
      !hopper::head_map(&k_map, k, batch, skv, num_heads, head_dim, kBlockKv) ||
      !hopper::head_map(&v_map, v, batch, skv, num_heads, head_dim, kBlockKv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + L::kQRows - 1) / L::kQRows, num_heads, batch);
  flash_bwd_dq_kernel<DSLOT><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(dq), sq, skv, num_heads, head_dim, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DSLOT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias, void* dk,
               void* dv, int batch, int sq, int skv, int num_heads, int head_dim,
               float sm_scale, cudaStream_t stream) {
  using L = DkvLayout<DSLOT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DSLOT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap q_map, do_map, k_map, v_map, lse_map, delta_map;
  const long long rows = static_cast<long long>(batch) * num_heads * sq;
  if (!hopper::head_map(&q_map, q, batch, sq, num_heads, head_dim, kBlockQ) ||
      !hopper::head_map(&do_map, dout, batch, sq, num_heads, head_dim, kBlockQ) ||
      !hopper::head_map(&k_map, k, batch, skv, num_heads, head_dim, L::kKvRows) ||
      !hopper::head_map(&v_map, v, batch, skv, num_heads, head_dim, L::kKvRows) ||
      !hopper::flat_map(&lse_map, lse, rows, L::kStatBox) ||
      !hopper::flat_map(&delta_map, delta, rows, L::kStatBox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((skv + L::kKvRows - 1) / L::kKvRows, num_heads, batch);
  flash_bwd_dkv_kernel<DSLOT><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      q_map, do_map, k_map, v_map, lse_map, delta_map, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq, skv, num_heads,
      head_dim, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors; the wrapper checks shapes, dtypes and alignment.
// Each returns the launch's cudaError_t (0 on success).
extern "C" int ot_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* bias, void* dq, int batch, int sq,
                               int skv, int num_heads, int head_dim,
                               float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 64) {
    return launch_dq<64>(q, k, v, dout, lse, delta, bias, dq, batch, sq, skv,
                         num_heads, head_dim, sm_scale, s);
  }
  return launch_dq<128>(q, k, v, dout, lse, delta, bias, dq, batch, sq, skv,
                        num_heads, head_dim, sm_scale, s);
}

extern "C" int ot_flash_bwd_delta(const void* o, const void* dout, void* delta,
                                  int batch, int sq, int num_heads, int head_dim,
                                  void* stream) {
  const int rows = batch * sq;
  const int threads = 256;
  const int blocks = (rows * num_heads + threads - 1) / threads;
  flash_bwd_delta_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), rows, sq, num_heads, head_dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ot_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* bias, void* dk, void* dv, int batch,
                                int sq, int skv, int num_heads, int head_dim,
                                float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 64) {
    return launch_dkv<64>(q, k, v, dout, lse, delta, bias, dk, dv, batch, sq, skv,
                          num_heads, head_dim, sm_scale, s);
  }
  return launch_dkv<128>(q, k, v, dout, lse, delta, bias, dk, dv, batch, sq, skv,
                         num_heads, head_dim, sm_scale, s);
}
