// Folded-layout flash-attention backward for Hopper (sm_90a): K2 (dq) and
// K3 (dk, dv).
//
// Replaces, in onetrainer_tpu/ops/flash_folded.py (all launched by `_bwd`):
//   K2  _dq_kernel          (:196, launch :401)  -> flash_bwd_dq_kernel
//   K3a _dkv_kernel         (:248, launch :447)  -> flash_bwd_dkv_kernel
//   K3b _dkv_stream_kernel  (:305, launch :494)  -> flash_bwd_dkv_kernel
// It computes the same function as the TPU kernels, not the same blocks.
// With S = q k^T * sm_scale + bias[b, j], P = exp(S - lse) (lse saved by
// the forward, csrc/flash_fwd.cu), delta_i = sum_d dO[i, d] * O[i, d]:
//
//   dS = P * (dO v^T - delta) * sm_scale      (rounded to bf16, as the TPU
//                                              kernels round it to k.dtype)
//   dq = dS k,   dk = dS^T q,   dv = bf16(P)^T dO
//
// over packed [B, S, H*d] bf16 tensors, non-causal, optional fp32 kv bias
// (0 keep / -1e30 drop). The bias gets no gradient.
//
// Design (K1's conventions: mma.sync m16n8k16 bf16 -> fp32, heads read by
// stride from the packed layout, runtime d <= 128 (d % 8 == 0) in a 64- or
// 128-wide slot zero-filled on load, ragged Sq/Skv masked in the kernel):
// - K2: grid (ceil(Sq/64), H, B), 4 warps x 16 q rows. q and dO rows stay
//   in shared memory; the block loops over kv tiles and keeps dq in fp32
//   registers. delta comes from the block's own dO and O rows.
// - K3: grid (ceil(Skv/64), H, B), 4 warps x 16 kv rows. k and v rows
//   stay in shared memory; the block loops over ALL q tiles, recomputing
//   P^T from lse and delta from dO*O per tile, and keeps dk and dv in fp32
//   registers. No atomics and no sequence threshold: the TPU's resident /
//   streaming split (6144 tokens) is a VMEM limit that a loop inside the
//   block does not have, so one kernel covers K3a and K3b, and its sums run
//   in a fixed order (deterministic from run to run).
// - In the 128 slot the inner tile is 32 rows (kv tiles in K2, q tiles in
//   K3) so that two 16x128 fp32 accumulators and the score tiles fit in
//   registers without spilling.
//
// Bound: K2 does 6*B*H*Sq*Skv*d FLOPs, K3 8*B*H*Sq*Skv*d (the TPU kernels'
// cost estimates, :409 and :456), against ~5 bf16 [B, S, H*d] tensors of
// traffic; at SDXL's S=4096 (and 1024), d=64 that is far above the H100's
// ~295 FLOP/byte ridge, so tensor-core FLOPs bound both: at 989 TFLOP/s,
// B2 S4096 H10 d64 takes >= 0.130 ms (K2) and >= 0.174 ms (K3), B2 S1024
// H20 d64 >= 0.016 ms and >= 0.022 ms. What this simple design gives up:
// wgmma, TMA / cp.async pipelining (tile loads are synchronous), ldmatrix
// (the k-major operands are gathered with 16-bit shared loads), and K3's
// recomputation of delta per kv block (a separate pass could compute it
// once). Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // q rows (K2) or kv rows (K3) per block
constexpr int kThreads = 128;   // 4 warps x 16 rows

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

// -------------------------------------------------------------- K3: dk, dv

template <int DSLOT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,   // [B, H, Sq]
                     const float* __restrict__ bias,  // [B, Skv] or nullptr
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int sq, int skv, int num_heads, int d, float sm_scale) {
  constexpr int kStride = Slot<DSLOT>::kStride;
  constexpr int kBlockQ = Slot<DSLOT>::kInner;
  constexpr int kQTiles = kBlockQ / 8;
  constexpr int kRowThreads = kThreads / kBlockQ;  // threads per q row for delta

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kRows * kStride;
  __nv_bfloat16* q_s = v_s + kRows * kStride;
  __nv_bfloat16* do_s = q_s + kBlockQ * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kBlockQ * kStride);
  float* delta_s = lse_s + kBlockQ;

  const int kv0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = num_heads * d;
  const size_t q_head = static_cast<size_t>(b) * sq * inner + static_cast<size_t>(h) * d;
  const size_t kv_head = static_cast<size_t>(b) * skv * inner + static_cast<size_t>(h) * d;
  const float* lse_head = lse + (static_cast<size_t>(b) * num_heads + h) * sq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int wrow = warp * 16;

  load_tile<DSLOT>(k_s, kRows, k + kv_head, kv0, skv, inner, d);
  load_tile<DSLOT>(v_s, kRows, v + kv_head, kv0, skv, inner, d);

  // the bias of this thread's kv rows wrow+g and wrow+g+8
  float bias_r[2] = {0.f, 0.f};
  if (bias) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + wrow + g + 8 * r;
      if (row < skv) bias_r[r] = bias[static_cast<size_t>(b) * skv + row];
    }
  }

  float dk_acc[DSLOT / 8][4], dv_acc[DSLOT / 8][4];
#pragma unroll
  for (int nt = 0; nt < DSLOT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  }

  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // every warp is done with the last q/dO tile
    load_tile<DSLOT>(q_s, kBlockQ, q + q_head, q0, sq, inner, d);
    load_tile<DSLOT>(do_s, kBlockQ, dout + q_head, q0, sq, inner, d);
    {
      const int r = threadIdx.x / kRowThreads;
      const int part = threadIdx.x % kRowThreads;
      const int row = q0 + r;
      float sum = 0.f;
      if (row < sq) {
        const size_t off = q_head + static_cast<size_t>(row) * inner;
        sum = partial_delta(dout + off, o + off, d, part, kRowThreads);
      }
#pragma unroll
      for (int m = 1; m < kRowThreads; m *= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, m);
      }
      if (part == 0) {
        delta_s[r] = sum;
        lse_s[r] = row < sq ? lse_head[row] : 0.f;
      }
    }
    __syncthreads();

    // transposed scores for this warp's 16 kv rows x kBlockQ q columns
    float st[kQTiles][4], dpt[kQTiles][4];
    rows_dot_rows<DSLOT, kQTiles>(st, k_s, wrow, q_s, g, c);
    rows_dot_rows<DSLOT, kQTiles>(dpt, v_s, wrow, do_s, g, c);

#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * c + (e & 1);
        float p = 0.f;
        if (q0 + qc < sq) {
          p = __expf(st[nt][e] * sm_scale + bias_r[e >> 1] - lse_s[qc]);
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[qc]) * sm_scale;
      }
    }
    // dv += bf16(P)^T dO;  dk += dS^T q
    scores_times_rows<DSLOT, kQTiles>(dv_acc, st, do_s, g, c);
    scores_times_rows<DSLOT, kQTiles>(dk_acc, dpt, q_s, g, c);
  }

  store_rows<DSLOT>(dk + kv_head, dk_acc, kv0 + wrow + g, skv, inner, d, c);
  store_rows<DSLOT>(dv + kv_head, dv_acc, kv0 + wrow + g, skv, inner, d, c);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int DSLOT>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* bias, void* dq,
              int batch, int sq, int skv, int num_heads, int head_dim,
              float sm_scale, cudaStream_t stream) {
  const size_t smem = Slot<DSLOT>::kSmemBytes;
  const int err = prepare(flash_bwd_dq_kernel<DSLOT>, smem);
  if (err != 0) return err;
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
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* bias, void* dk,
               void* dv, int batch, int sq, int skv, int num_heads, int head_dim,
               float sm_scale, cudaStream_t stream) {
  const size_t smem = Slot<DSLOT>::kSmemBytes;
  const int err = prepare(flash_bwd_dkv_kernel<DSLOT>, smem);
  if (err != 0) return err;
  const dim3 grid((skv + kRows - 1) / kRows, num_heads, batch);
  flash_bwd_dkv_kernel<DSLOT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, skv, num_heads, head_dim, sm_scale);
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

extern "C" int ot_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse,
                                const void* bias, void* dk, void* dv, int batch,
                                int sq, int skv, int num_heads, int head_dim,
                                float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 64) {
    return launch_dkv<64>(q, k, v, o, dout, lse, bias, dk, dv, batch, sq, skv,
                          num_heads, head_dim, sm_scale, s);
  }
  return launch_dkv<128>(q, k, v, o, dout, lse, bias, dk, dv, batch, sq, skv,
                         num_heads, head_dim, sm_scale, s);
}
