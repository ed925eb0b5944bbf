// K5: fused stochastic-rounding bf16 parameter update for sm_90a (H100).
//
// Replaces onetrainer_tpu/ops/pallas_sr.py `_sr_update_kernel` (launched by
// `sr_update_pallas`). Same function: out = bf16(p + u) with p bf16 and u
// bf16 or fp32, summed in fp32, then 16 random bits added to the fp32 bit
// pattern and the low 16 bits dropped, which rounds up with probability
// equal to the dropped fraction (unbiased). The plain PyTorch version
// (ops/stochastic.py:stochastic_round_to_bf16) does the same bit
// arithmetic given the bits.
//
// Random bits: the TPU kernel seeds its hardware generator per tile; here
// a counter-based Philox 4x32-10 (Salmon et al., SC'11) keyed by the 64-bit
// seed, with the index of each group of 4 elements as the counter, gives
// each element its own 16 bits. The output is a function of (seed, index)
// alone: it does not depend on the launch configuration. The seed is read
// from device memory, so the caller draws it on the card without a sync.
//
// Bound: bytes (2 bytes of p and 2 or 4 of u read, 2 written per element;
// 10 Philox rounds per 4 elements are well below the card's integer rate).
// Design: one thread per 4 elements, 8-byte (bf16) or 16-byte (fp32)
// vector loads, one 8-byte store, a scalar tail; out may alias p (each
// element is read and written by one thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      key.x += kW0;
      key.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

__device__ __forceinline__ __nv_bfloat16 round_sr(float sum, uint32_t rand) {
  const uint32_t bits = (__float_as_uint(sum) + (rand & 0xFFFFu)) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* u, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(u);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* u, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(u);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
sr_update_kernel(__nv_bfloat16* out, const __nv_bfloat16* p, const U* u,
                 const unsigned long long* seed_ptr, long long n) {
  const unsigned long long seed = *seed_ptr;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u),
        key);
    const uint32_t rand[4] = {r.x, r.y, r.z, r.w};
    const long long e = 4 * g;
    if (e + 4 <= n) {
      float pv[4], uv[4];
      load4(p + e, pv);
      load4(u + e, uv);
      __align__(8) __nv_bfloat16 res[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) res[i] = round_sr(pv[i] + uv[i], rand[i]);
      *reinterpret_cast<uint2*>(out + e) = *reinterpret_cast<const uint2*>(res);
    } else {
      for (int i = 0; e + i < n; ++i) {
        out[e + i] = round_sr(__bfloat162float(p[e + i]) + to_float(u[e + i]), rand[i]);
      }
    }
  }
}

template <typename U>
int launch(void* out, const void* p, const void* u, const void* seed, long long n,
           cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  sr_update_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(p),
      static_cast<const U*>(u), static_cast<const unsigned long long*>(seed), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). out and p are bf16, u is fp32
// when u_fp32 else bf16, all contiguous with n elements and 8-byte (u fp32:
// 16-byte) aligned; seed points to one 64-bit integer on the device. out
// may be p. Returns the launch's cudaError_t (0 on success).
extern "C" int ot_sr_update(void* out, const void* p, const void* u, int u_fp32,
                            const void* seed, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_fp32) return launch<float>(out, p, u, seed, n, s);
  return launch<__nv_bfloat16>(out, p, u, seed, n, s);
}
