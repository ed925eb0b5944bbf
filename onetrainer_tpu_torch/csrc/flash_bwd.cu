// Folded-layout flash-attention backward for Hopper (sm_90a): K2 (dq), K3
// (dk, dv) and K3's delta pre-pass.
//
// Replaces, in onetrainer_tpu/ops/flash_folded.py (all launched by `_bwd`):
//   K2  _dq_kernel          (:196, launch :401)  -> flash_bwd_dq_kernel
//   K3a _dkv_kernel         (:248, launch :447)  -> flash_bwd_delta_kernel
//   K3b _dkv_stream_kernel  (:305, launch :494)     + flash_bwd_dkv_kernel
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
// K2 (mma.sync m16n8k16 bf16 -> fp32): grid (ceil(Sq/64), H, B), 4 warps x
// 16 q rows. q and dO rows stay in shared memory; the block loops over kv
// tiles (32 rows in the 128 slot) and keeps dq in fp32 registers. delta
// comes from the block's own dO and O rows. Bound by tensor-core FLOPs:
// 6*B*H*Sq*Skv*d. Left for later: wgmma and pipelined tile copies.
//
// K3 is two launches:
// - flash_bwd_delta_kernel computes delta [B, H, Sq] once (the TPU kernels
//   recompute it for every kv block);
// - flash_bwd_dkv_kernel: grid (ceil(Skv/128), H, B), 256 threads = two
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

constexpr int kRows = 64;       // K2: q rows per block
constexpr int kThreads = 128;   // K2: 4 warps x 16 rows

template <int DSLOT>
struct Slot {
  static constexpr int kStride = DSLOT + 8;     // +8 bf16 keeps banks apart
  static constexpr int kInner = DSLOT == 128 ? 32 : 64;   // inner tile rows
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(2 * kRows + 2 * kInner) * kStride * sizeof(__nv_bfloat16) +
      2 * kInner * sizeof(float);
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + nrows_tile) x lanes [0, DSLOT) of one head into
// shared memory, 16 bytes per thread per step; rows >= nrows and lanes >= d
// are zero-filled.
template <int DSLOT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, int nrows_tile,
                                          const __nv_bfloat16* head_base,
                                          int row0, int nrows, int row_stride,
                                          int d) {
  constexpr int kChunks = DSLOT / 8;
  for (int idx = threadIdx.x; idx < nrows_tile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int col = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && col < d) {
      val = *reinterpret_cast<const uint4*>(
          head_base + static_cast<size_t>(row) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(smem + r * Slot<DSLOT>::kStride + col) = val;
  }
}

// A fragment (m16 x k16, row-major) of rows [row0, row0 + 16), k-step ks.
template <int DSLOT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int row0, int ks, int g, int c) {
  constexpr int kStride = Slot<DSLOT>::kStride;
  const __nv_bfloat16* p = s + (row0 + g) * kStride + ks * 16 + 2 * c;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * kStride);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * kStride + 8);
}

// acc[nt] += X[rows] . Y[nt*8 .. nt*8+8)^T over the head dim, where X rows
// (16 per warp, from row0) and Y rows live in shared memory as [row][d].
template <int DSLOT, int NT>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NT][4],
                                              const __nv_bfloat16* x, int row0,
                                              const __nv_bfloat16* y, int g, int c) {
  constexpr int kStride = Slot<DSLOT>::kStride;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < DSLOT / 16; ++ks) {
    uint32_t a[4];
    load_a<DSLOT>(a, x, row0, ks, g, c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* p = y + (nt * 8 + g) * kStride + ks * 16 + 2 * c;
      mma_16816(acc[nt], a, ld_u32(p), ld_u32(p + 8));
    }
  }
}

// out[nt] += W . Z over NT8*8 inner rows, where W is a 16 x (NT8*8) score
// tile held as C fragments (rounded to bf16 here) and Z [inner][d] lives in
// shared memory; out covers the head dim in 8-wide tiles.
template <int DSLOT, int NT8>
__device__ __forceinline__ void scores_times_rows(float (&out)[DSLOT / 8][4],
                                                  float (&w)[NT8][4],
                                                  const __nv_bfloat16* z, int g,
                                                  int c) {
  constexpr int kStride = Slot<DSLOT>::kStride;
  const uint16_t* z16 = reinterpret_cast<const uint16_t*>(z);
#pragma unroll
  for (int kk = 0; kk < NT8 / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(w[2 * kk][0], w[2 * kk][1]);
    a[1] = pack_bf16x2(w[2 * kk][2], w[2 * kk][3]);
    a[2] = pack_bf16x2(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    a[3] = pack_bf16x2(w[2 * kk + 1][2], w[2 * kk + 1][3]);
    const int r0 = kk * 16 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < DSLOT / 8; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = static_cast<uint32_t>(z16[r0 * kStride + n]) |
                          (static_cast<uint32_t>(z16[(r0 + 1) * kStride + n]) << 16);
      const uint32_t b1 = static_cast<uint32_t>(z16[(r0 + 8) * kStride + n]) |
                          (static_cast<uint32_t>(z16[(r0 + 9) * kStride + n]) << 16);
      mma_16816(out[nt], a, b0, b1);
    }
  }
}

// sum_d dO[row, d] * O[row, d] in fp32 over this thread's share of the
// lanes (chunks of 8 starting at chunk `part`, every `parts` chunks).
__device__ __forceinline__ float partial_delta(const __nv_bfloat16* dorow,
                                               const __nv_bfloat16* orow, int d,
                                               int part, int parts) {
  float sum = 0.f;
  for (int col = part * 8; col < d; col += parts * 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dorow + col);
    const uint4 b = *reinterpret_cast<const uint4*>(orow + col);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]);
      const float2 fb = __bfloat1622float2(b2[i]);
      sum += fa.x * fb.x + fa.y * fb.y;
    }
  }
  return sum;
}

template <int DSLOT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out_head,
                                           const float (&acc)[DSLOT / 8][4],
                                           int row_base, int nrows, int inner,
                                           int d, int c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* orow = out_head + static_cast<size_t>(row) * inner;
#pragma unroll
    for (int nt = 0; nt < DSLOT / 8; ++nt) {
      const int col = nt * 8 + 2 * c;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ K2: dq

template <int DSLOT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,   // [B, H, Sq]
                    const float* __restrict__ bias,  // [B, Skv] or nullptr
                    __nv_bfloat16* __restrict__ dq,
                    int sq, int skv, int num_heads, int d, float sm_scale) {
  constexpr int kStride = Slot<DSLOT>::kStride;
  constexpr int kBlockK = Slot<DSLOT>::kInner;
  constexpr int kKTiles = kBlockK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kRows * kStride;
  __nv_bfloat16* k_s = do_s + kRows * kStride;
  __nv_bfloat16* v_s = k_s + kBlockK * kStride;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = num_heads * d;
  const size_t q_head = static_cast<size_t>(b) * sq * inner + static_cast<size_t>(h) * d;
  const size_t kv_head = static_cast<size_t>(b) * skv * inner + static_cast<size_t>(h) * d;
  const float* bias_row = bias ? bias + static_cast<size_t>(b) * skv : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int wrow = warp * 16;

  load_tile<DSLOT>(q_s, kRows, q + q_head, q0, sq, inner, d);
  load_tile<DSLOT>(do_s, kRows, dout + q_head, q0, sq, inner, d);

  // per-thread rows wrow+g and wrow+g+8: lse and delta (the quad of lanes
  // sharing a row splits its lanes and sums with two shuffles)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    float part = 0.f;
    lse_r[r] = 0.f;
    if (row < sq) {
      const size_t off = q_head + static_cast<size_t>(row) * inner;
      part = partial_delta(dout + off, o + off, d, c, 4);
      lse_r[r] = lse[(static_cast<size_t>(b) * num_heads + h) * sq + row];
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[r] = part;
  }

  float acc[DSLOT / 8][4];
#pragma unroll
  for (int nt = 0; nt < DSLOT / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < skv; kv0 += kBlockK) {
    __syncthreads();  // q/dO staged; every warp is done with the last k/v tile
    load_tile<DSLOT>(k_s, kBlockK, k + kv_head, kv0, skv, inner, d);
    load_tile<DSLOT>(v_s, kBlockK, v + kv_head, kv0, skv, inner, d);
    __syncthreads();

    float s[kKTiles][4], dp[kKTiles][4];
    rows_dot_rows<DSLOT, kKTiles>(s, q_s, wrow, k_s, g, c);
    rows_dot_rows<DSLOT, kKTiles>(dp, do_s, wrow, v_s, g, c);

    // P and dS for this warp's 16 rows x kBlockK kv columns; columns past
    // Skv get exactly zero weight
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * c + (e & 1);
        float p = 0.f;
        if (col < skv) {
          float x = s[nt][e] * sm_scale;
          if (bias_row) x += bias_row[col];
          p = __expf(x - lse_r[e >> 1]);
        }
        dp[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * sm_scale;
      }
    }
    // dq += dS k
    scores_times_rows<DSLOT, kKTiles>(acc, dp, k_s, g, c);
  }

  store_rows<DSLOT>(dq + q_head, acc, q0 + wrow + g, sq, inner, d, c);
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
  constexpr float kLog2e = 1.4426950408889634f;

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
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* bias, void* dq,
              int batch, int sq, int skv, int num_heads, int head_dim,
              float sm_scale, cudaStream_t stream) {
  const size_t smem = Slot<DSLOT>::kSmemBytes;
  // the dynamic shared memory limit, set once per template instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DSLOT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kRows - 1) / kRows, num_heads, batch);
  flash_bwd_dq_kernel<DSLOT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dq), sq, skv,
      num_heads, head_dim, sm_scale);
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
                               const void* o, const void* dout, const void* lse,
                               const void* bias, void* dq, int batch, int sq,
                               int skv, int num_heads, int head_dim,
                               float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 64) {
    return launch_dq<64>(q, k, v, o, dout, lse, bias, dq, batch, sq, skv,
                         num_heads, head_dim, sm_scale, s);
  }
  return launch_dq<128>(q, k, v, o, dout, lse, bias, dq, batch, sq, skv,
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
