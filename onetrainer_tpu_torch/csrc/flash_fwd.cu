// Folded-layout flash-attention forward for Hopper (sm_90a).
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
// - Grid (ceil(Sq/64), H, B), 4 warps per block; each warp owns 16 q rows.
//   Heads are read by stride straight from the packed layout (row stride
//   H*d): no transpose and no [B, H, S, d] copy.
// - d is a runtime value <= 128 (multiple of 8) placed in a 64- or
//   128-wide template slot; lanes d..slot are zero-filled on load, so
//   SD 1.5's d=40/80 need no padded copy. Ragged Sq/Skv edges are masked in
//   the kernel (rows past Sq are zero-filled and never stored; kv columns
//   past Skv get -inf and contribute exactly zero).
// - The q tile is loaded once into registers as mma A fragments. The block
//   loops over 64-row kv tiles staged in shared memory and keeps fp32
//   running max, sum and accumulator (online softmax) in registers.
// - Matrix products use mma.sync m16n8k16 bf16 -> fp32. P is rounded to
//   bf16 for the P.V product, as the TPU kernel does (p.astype(v.dtype)).
//
// Bound: at SDXL's S=4096, d=64 the work is 4*S*S*d FLOPs per (b, h)
// against 4*S*d*2 bytes of q/k/v/o, about S/2 = 2048 FLOP per byte, far
// above the H100's ~295 FLOP/byte ridge: tensor-core FLOPs bound it.
// What this simple design gives up: wgmma (warpgroup MMA, the only path to
// full Hopper tensor-core rate), TMA and cp.async pipelining of kv tiles
// (loads here are synchronous, so tensor cores idle while a tile lands),
// warp specialisation, and ldmatrix for the V operand (gathered with
// 16-bit shared loads). Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kNegInit = -1e30f;

template <int DSLOT>
struct Tile {
  // +8 bf16 of row padding keeps the strided fragment reads off one bank
  static constexpr int kStride = DSLOT + 8;
  static constexpr int kElems = kBlockQ * kStride;
  static constexpr size_t kSmemBytes = 3 * kElems * sizeof(__nv_bfloat16);
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

// Stage rows [row0, row0 + 64) x lanes [0, DSLOT) of one head into shared
// memory, 16 bytes per thread per step. Rows >= nrows and lanes >= d are
// zero-filled (d % 8 == 0, so a 16-byte chunk is wholly in or out).
template <int DSLOT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* head_base,
                                          int row0, int nrows, int row_stride,
                                          int d) {
  constexpr int kChunks = DSLOT / 8;
  for (int idx = threadIdx.x; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int col = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && col < d) {
      val = *reinterpret_cast<const uint4*>(
          head_base + static_cast<size_t>(row) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(smem + r * Tile<DSLOT>::kStride + col) = val;
  }
}

template <int DSLOT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,  // [B, Skv] or nullptr
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,  // [B, H, Sq]
                 int sq, int skv, int num_heads, int d, float sm_scale) {
  constexpr int kStride = Tile<DSLOT>::kStride;
  constexpr int kDSteps = DSLOT / 16;  // k-steps of Q.K^T
  constexpr int kDTiles = DSLOT / 8;   // n-tiles of the P.V output
  constexpr int kKTiles = kBlockK / 8; // n-tiles of the score block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + Tile<DSLOT>::kElems;
  __nv_bfloat16* v_s = k_s + Tile<DSLOT>::kElems;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = num_heads * d;
  const size_t q_head = static_cast<size_t>(b) * sq * inner + static_cast<size_t>(h) * d;
  const size_t kv_head = static_cast<size_t>(b) * skv * inner + static_cast<size_t>(h) * d;
  const float* bias_row = bias ? bias + static_cast<size_t>(b) * skv : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int c = lane % 4;  // fragment column pair
  const int wrow = warp * 16;

  load_tile<DSLOT>(q_s, q + q_head, q0, sq, inner, d);
  __syncthreads();

  // q rows (wrow + g, wrow + g + 8) as A fragments, kept for the whole loop
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks) {
    const __nv_bfloat16* p = q_s + (wrow + g) * kStride + ks * 16 + 2 * c;
    qf[ks][0] = ld_u32(p);
    qf[ks][1] = ld_u32(p + 8 * kStride);
    qf[ks][2] = ld_u32(p + 8);
    qf[ks][3] = ld_u32(p + 8 * kStride + 8);
  }

  float m_run[2] = {kNegInit, kNegInit};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  const uint16_t* v_u16 = reinterpret_cast<const uint16_t*>(v_s);

  for (int kv0 = 0; kv0 < skv; kv0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DSLOT>(k_s, k + kv_head, kv0, skv, inner, d);
    load_tile<DSLOT>(v_s, v + kv_head, kv0, skv, inner, d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        const __nv_bfloat16* p = k_s + (nt * 8 + g) * kStride + ks * 16 + 2 * c;
        mma_16816(s[nt], qf[ks], ld_u32(p), ld_u32(p + 8));
      }
    }

    // scale, bias, ragged-edge mask; running max over this tile
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * c + (e & 1);
        float x = s[nt][e] * sm_scale;
        if (col >= skv) {
          x = __int_as_float(0xff800000);  // -inf: exactly zero weight
        } else if (bias_row) {
          x += bias_row[col];
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {__expf(m_run[0] - mx[0]), __expf(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];

    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // O += P V: the score C fragments are re-used as A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int r0 = kk * 16 + 2 * c;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        const int n = nt * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(v_u16[r0 * kStride + n]) |
                            (static_cast<uint32_t>(v_u16[(r0 + 1) * kStride + n]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(v_u16[(r0 + 8) * kStride + n]) |
                            (static_cast<uint32_t>(v_u16[(r0 + 9) * kStride + n]) << 16);
        mma_16816(acc[nt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    __nv_bfloat16* orow = o + q_head + static_cast<size_t>(rows[r]) * inner;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      const int col = nt * 8 + 2 * c;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
      }
    }
    if (c == 0) {
      lse[(static_cast<size_t>(b) * num_heads + h) * sq + rows[r]] =
          m_run[r] + logf(l_run[r]);
    }
  }
}

template <int DSLOT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int batch, int sq, int skv, int num_heads,
           int head_dim, float sm_scale, cudaStream_t stream) {
  const size_t smem = Tile<DSLOT>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DSLOT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  flash_fwd_kernel<DSLOT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
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
  if (head_dim <= 64) {
    return launch<64>(q, k, v, bias, o, lse, batch, sq, skv, num_heads,
                      head_dim, sm_scale, s);
  }
  return launch<128>(q, k, v, bias, o, lse, batch, sq, skv, num_heads,
                     head_dim, sm_scale, s);
}
