// K4: NF4 dequantization for sm_90a (H100).
//
// Replaces onetrainer_tpu/ops/nf4_pallas.py `_nf4_kernel` (launched by
// `nf4_dequant_flat`). Same function: packed uint8 codes [n_half] in the
// half-split layout (byte j holds element j in its high nibble and element
// j + n_half in its low nibble) and fp32 block-64 absmax scales
// [n_half / 32] over the original element order -> [2 * n_half] values in
// bf16 or fp32, value = NF4_CODE[nibble] * scale in fp32, then one
// round-to-nearest cast. The plain PyTorch version
// (ops/nf4.py:nf4_dequant_reference) does the same multiply and cast, so
// the two agree bit for bit.
//
// Bound: bytes. Per output element the card reads 1/2 code byte and 1/16
// scale byte and writes 2 (bf16) or 4 (fp32) bytes; there is one multiply.
// Design: one thread decodes 8 packed bytes (one 8-byte load) into 8 values
// of each half and writes each half with 16-byte stores, so both write
// streams coalesce. 8 consecutive elements starting at a multiple of 8 lie
// in one 64-element scale block, so each half needs one scale load. The
// TPU kernel's 16 vector selects (it has no gathers) become a lookup in a
// 16-entry shared-memory copy of the code table: 16 words in 16 banks, so
// the lookups of a warp never conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The reference's NF4_CODE (QLoRA, arXiv:2305.14314) as exact fp32 values.
__constant__ float kCode[16] = {
    -0x1.0p+0f,        -0x1.647362p-1f, -0x1.0cd66p-1f,   -0x1.94654p-2f,
    -0x1.23449ap-2f,   -0x1.7a6a7ep-3f, -0x1.74f0e2p-4f,  0x0.0p+0f,
    0x1.45f5fep-4f,    0x1.4995c6p-3f,  0x1.f809bap-3f,   0x1.5a0674p-2f,
    0x1.c3497p-2f,     0x1.200f56p-1f,  0x1.722766p-1f,   0x1.0p+0f,
};

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 8;
constexpr int kBlock = 64;            // NF4 scale block
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond this

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  __align__(16) __nv_bfloat16 packed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) packed[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nf4_dequant_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, T* __restrict__ out,
                   long long n_half) {
  __shared__ float code[16];
  if (threadIdx.x < 16) code[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const long long groups = n_half / kBytesPerThread;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long j = g * kBytesPerThread;
    const uint2 word = *reinterpret_cast<const uint2*>(packed + j);
    const float s_hi = scales[j / kBlock];
    const float s_lo = scales[(n_half + j) / kBlock];
    float hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = ((i < 4 ? word.x : word.y) >> (8 * (i & 3))) & 0xFFu;
      hi[i] = code[b >> 4] * s_hi;
      lo[i] = code[b & 0xFu] * s_lo;
    }
    store8(out + j, hi);
    store8(out + n_half + j, lo);
  }
}

template <typename T>
int launch(const void* packed, const void* scales, void* out, long long n_half,
           cudaStream_t stream) {
  const long long groups = n_half / kBytesPerThread;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  nf4_dequant_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<T*>(out), n_half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). n_half must be a multiple of 8
// (the wrapper pads to multiples of 1024); packed must be 8-byte and out
// 16-byte aligned. out_fp32 selects fp32 output, else bf16. Returns the
// launch's cudaError_t (0 on success).
extern "C" int ot_nf4_dequant(const void* packed, const void* scales, void* out,
                              long long n_half, int out_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_fp32) return launch<float>(packed, scales, out, n_half, s);
  return launch<__nv_bfloat16>(packed, scales, out, n_half, s);
}
