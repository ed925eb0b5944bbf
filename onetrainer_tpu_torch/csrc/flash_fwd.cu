// Folded-layout flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces onetrainer_tpu/ops/flash_folded.py:_fwd_kernel (launched by
// `_fwd`), the Pallas TPU kernel behind every UNet self-attention of the SD
// families. It computes the same function, not the same blocks:
//
//   o[b, i, h*d:(h+1)*d] = softmax_j(q_i . k_j * sm_scale + bias[b, j]) v_j
//   lse[b, h, i]         = log sum_j exp(q_i . k_j * sm_scale + bias[b, j])
//
// over packed [B, S, H*d] bf16 tensors, non-causal, with an optional fp32
// kv-drop bias (0 keep / -1e30 drop, the same finite value as the TPU
// kernel, so a fully masked leading kv tile behaves identically: its
// transient weight is wiped by alpha = exp(-1e30 - m) == 0 once real kv
// arrives).
//
// Design:
// - Grid (ceil(Sq/128), H, B), 256 threads = two warpgroups of 64 q rows
//   each. Heads are read by stride straight from the packed layout (row
//   stride H*d): no transpose and no [B, H, S, d] copy.
// - d is a runtime value <= 128 (multiple of 8) placed in a 64- or
//   128-wide template slot; lanes d..slot are zero-filled by the copies,
//   so SD 1.5's d=40/80 need no padded copy. Ragged Sq/Skv edges are
//   masked in the kernel (rows past Sq are zero-filled and never stored;
//   kv columns past Skv get -inf and contribute exactly zero).
// - TMA copies the q tile once and streams K and V tiles of 64 kv rows
//   through a 4-stage ring into swizzled shared memory (the 128-byte
//   swizzle of wgmma's descriptors, csrc/hopper_mma.cuh), completing on
//   mbarriers: tiles t+1..t+3 land while tile t computes. The tensor maps
//   are 4-D (lane, head, row, batch) over the packed layout, so lanes past
//   d and rows past S are out of bounds and TMA fills them with zeros.
//   One thread issues the copies; the two warpgroups never wait for each
//   other except when a stage is refilled, so they drift apart and one's
//   softmax overlaps the other's products.
// - S = Q K^T is a wgmma with both operands in shared memory; the online
//   softmax (fp32 running max and sum, in log2 units) runs in registers; P
//   is packed to bf16 (as the TPU kernel rounds p to v.dtype) and fed as
//   the register A operand of O += P V, V being a MN-major B operand.
//   Within a warpgroup, tile t+1's scores and tile t's P V are issued
//   together, and tile t+1's softmax runs while P V does.
// - In the 64 slot a thread stays under 128 registers, so two blocks share
//   an SM.
//
// Bound: at SDXL's S=4096, d=64 the work is 4*S*S*d FLOPs per (b, h)
// against 4*S*d*2 bytes of q/k/v/o, about S/2 = 2048 FLOP per byte, far
// above the H100's ~295 FLOP/byte ridge: tensor-core FLOPs bound it. At d=64
// the exponentials come close: one per score against 256 FLOPs, and the
// SM's 16 exp per clock against its 4096 bf16 FLOPs per clock.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kv rows per tile, in both slots: in the 64 slot this keeps a thread
// under 128 registers, so two blocks share an SM (measured faster than 128
// kv rows with one block per SM)
constexpr int kBlockK = 64;

template <int DSLOT>
struct FwdLayout {
  static constexpr int kQRows = 128;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 4;
  static constexpr int kQTile = kQRows * DSLOT * 2;   // bytes
  static constexpr int kKvTile = kBlockK * DSLOT * 2; // bytes of K (or V)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;               // kStages K tiles
  static constexpr int kV = kK + kStages * kKvTile;    // kStages V tiles
  static constexpr int kFull = kV + kStages * kKvTile; // kStages mbarriers
  static constexpr int kEmpty = kFull + kStages * 8;   // kStages mbarriers
  static constexpr int kQBar = kEmpty + kStages * 8;
  static constexpr int kBytes = kQBar + 8;
  // + slack to align the dynamic shared memory to one swizzle atom
  static constexpr size_t kSmemBytes = kBytes + hopper::kAtomBytes;
};

template <int DSLOT>
constexpr int kBlocksPerSm = DSLOT == 64 ? 2 : 1;

template <int DSLOT, bool HAS_BIAS>
__global__ void __launch_bounds__(256, kBlocksPerSm<DSLOT>)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const float* __restrict__ bias,  // [B, Skv] (HAS_BIAS)
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,  // [B, H, Sq]
                 int sq, int skv, int num_heads, int d, float sm_scale) {
  using L = FwdLayout<DSLOT>;
  using hopper::Wgmma;
  constexpr int BK = kBlockK;
  constexpr int kDSteps = DSLOT / 16;   // k-steps of Q K^T
  constexpr int kKSteps = BK / 16;      // k-steps of P V

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
  const float* bias_row = HAS_BIAS ? bias + static_cast<size_t>(b) * skv : nullptr;
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

  // this warpgroup's 64 q rows (the K-major A operand)
  const uint32_t q_rows = base + L::kQ + wg * 64 * hopper::kSwizzleBytes;
  constexpr uint32_t kQPanel = L::kQRows * hopper::kSwizzleBytes;
  constexpr uint32_t kKvPanel = BK * hopper::kSwizzleBytes;

  // S = Q K^T of kv tile t, for 64 q rows x BK kv columns (asynchronous)
  auto issue_scores = [&](float (&sc)[BK / 2], int t) {
    const uint32_t k_tile = base + L::kK + (t % L::kStages) * L::kKvTile;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      Wgmma<BK>::ss(sc, hopper::desc_k_major(q_rows + (ks / 4) * kQPanel + (ks % 4) * 32),
                    hopper::desc_k_major(k_tile + (ks / 4) * kKvPanel + (ks % 4) * 32),
                    ks > 0);
    }
  };

  // O += bf16(P) V of kv tile t (asynchronous; V is a MN-major B)
  auto issue_pv = [&](float (&acc)[DSLOT / 2], const uint32_t (&pa)[kKSteps][4], int t) {
    const uint32_t v_tile = base + L::kV + (t % L::kStages) * L::kKvTile;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      Wgmma<DSLOT>::rs(acc, pa[kk],
                       hopper::desc_mn_major(v_tile + kk * 16 * hopper::kSwizzleBytes, kKvPanel),
                       1);
    }
  };

  const float scale_l2 = sm_scale * kLog2e;
  float m_run[2] = {kNegInit, kNegInit};   // running max, log2 units
  float l_run[2] = {0.f, 0.f};             // per-thread partial row sums

  // The online softmax of kv tile t's scores (raw q.k in sc): the new
  // running max and sum, P = exp(s*scale + bias - max) in sc (fp32), and
  // alpha, the factor that rescales the earlier O.
  auto softmax = [&](float (&sc)[BK / 2], int t, float (&alpha)[2]) {
    const int kv0 = t * BK;
    if (kv0 + BK > skv) {   // ragged last tile: -inf, exactly zero weight
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (kv0 + 8 * (i / 4) + 2 * c + (i & 1) >= skv) sc[i] = __int_as_float(0xff800000);
      }
    }
    float mx[2];
    if (HAS_BIAS) {
      mx[0] = mx[1] = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float bj[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + 8 * j + 2 * c + e;
          bj[e] = col < skv ? __ldg(bias_row + col) * kLog2e : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(sc[4 * j + e], scale_l2, bj[e & 1]);
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    } else {
      // scale > 0: the max of the raw scores, scaled once per row
      mx[0] = mx[1] = __int_as_float(0xff800000);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale_l2;
      mx[1] *= scale_l2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(mx[r], m_run[r]);
      alpha[r] = hopper::exp2_approx(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = HAS_BIAS ? hopper::exp2_approx(sc[i] - mx[r])
                               : hopper::exp2_approx(fmaf(sc[i], scale_l2, -mx[r]));
      sc[i] = p;
      rsum[r] += p;
    }
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
  };

  float acc[DSLOT / 2];
#pragma unroll
  for (int i = 0; i < DSLOT / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[kKSteps][4];
  float alpha[2];

  const int lead = nk < L::kStages ? nk : L::kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(base + L::kFull + 8 * s, 1);
      hopper::mbar_init(base + L::kEmpty + 8 * s, L::kThreads);
    }
    hopper::mbar_init(base + L::kQBar, 1);
    hopper::mbar_init_fence();
    hopper::mbar_arrive_expect_tx(base + L::kQBar, L::kQTile);
#pragma unroll
    for (int p = 0; p < DSLOT / 64; ++p) {
      hopper::tma_load_4d(base + L::kQ + p * L::kQRows * hopper::kSwizzleBytes, &q_map,
                          base + L::kQBar, 64 * p, h, q0, b);
    }
    for (int t = 0; t < lead; ++t) issue_kv_tile(t);
  }
  __syncthreads();   // the barriers are initialised
  auto wait_tile = [&](int t) {
    hopper::mbar_wait(base + L::kFull + 8 * (t % L::kStages), (t / L::kStages) & 1);
  };
  hopper::mbar_wait(base + L::kQBar, 0);
  wait_tile(0);

  // tile 0's scores and softmax; then each step t issues tile t+1's scores
  // and tile t's P V, and runs tile t+1's softmax while P V runs; the last
  // tile's P V follows the loop (no wgmma is issued under a condition)
  hopper::wgmma_fence();
  issue_scores(sc, 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  softmax(sc, 0, alpha);
  hopper::acc_to_a<BK / 2>(pa, sc);

  // rescale O by tile t's alpha, then O += P V (asynchronous). Once the
  // running max settles, alpha is exactly 1 for a whole warp's rows and
  // the multiplies are skipped (a product with 1 changes no bit).
  auto rescale_and_issue_pv = [&](int t) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DSLOT / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
    issue_pv(acc, pa, t);
    hopper::wgmma_commit();
  };
  // tile t+1 landed; thread 0 refills the stage of tile t-1 once every
  // thread has released it
  auto next_tile = [&](int t) {
    if (tid == 0 && t >= 1 && t - 1 + L::kStages < nk) {
      const int s = (t - 1) % L::kStages;
      hopper::mbar_wait(base + L::kEmpty + 8 * s, ((t - 1) / L::kStages) & 1);
      issue_kv_tile(t - 1 + L::kStages);
    }
    wait_tile(t + 1);
  };
  // every thread is done with tile t's stage (K read by S(t), V by P V(t))
  auto release_tile = [&](int t) {
    hopper::mbar_arrive(base + L::kEmpty + 8 * (t % L::kStages));
  };

  for (int t = 0; t + 1 < nk; ++t) {
    next_tile(t);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    issue_scores(sc, t + 1);
    hopper::wgmma_commit();
    rescale_and_issue_pv(t);
    hopper::wgmma_wait<1>();   // the scores; P V may still run
    hopper::fence_regs(sc);
    softmax(sc, t + 1, alpha);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    release_tile(t);
    hopper::acc_to_a<BK / 2>(pa, sc);
  }
  rescale_and_issue_pv(nk - 1);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(pa);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* orow = o + q_head + static_cast<size_t>(row) * inner;
#pragma unroll
    for (int j = 0; j < DSLOT / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
    if (c == 0) {
      lse[(static_cast<size_t>(b) * num_heads + h) * sq + row] =
          m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

template <int DSLOT, bool HAS_BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int batch, int sq, int skv, int num_heads,
           int head_dim, float sm_scale, cudaStream_t stream) {
  using L = FwdLayout<DSLOT>;
  // the dynamic shared memory limit, set once per template instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DSLOT, HAS_BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap q_map, k_map, v_map;
  if (!hopper::head_map(&q_map, q, batch, sq, num_heads, head_dim, L::kQRows) ||
      !hopper::head_map(&k_map, k, batch, skv, num_heads, head_dim, kBlockK) ||
      !hopper::head_map(&v_map, v, batch, skv, num_heads, head_dim, kBlockK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + L::kQRows - 1) / L::kQRows, num_heads, batch);
  flash_fwd_kernel<DSLOT, HAS_BIAS><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), sq, skv,
      num_heads, head_dim, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors; the wrapper checks shapes, dtypes and alignment.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ot_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, void* lse, int batch,
                            int sq, int skv, int num_heads, int head_dim,
                            float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool slot64 = head_dim <= 64;
  if (bias) {
    return (slot64 ? launch<64, true> : launch<128, true>)(
        q, k, v, bias, o, lse, batch, sq, skv, num_heads, head_dim, sm_scale, s);
  }
  return (slot64 ? launch<64, false> : launch<128, false>)(
      q, k, v, bias, o, lse, batch, sq, skv, num_heads, head_dim, sm_scale, s);
}
