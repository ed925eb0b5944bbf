// K5: fused stochastic-rounding bf16 parameter update over a list of leaves,
// for sm_90a (H100).
//
// Replaces onetrainer_tpu/ops/pallas_sr.py `_sr_update_kernel` (launched by
// `sr_update_pallas`, once per leaf). Same function on each leaf: out =
// bf16(p + u) with p bf16 and u bf16 or fp32, summed in fp32, then 16
// random bits added to the fp32 bit pattern and the low 16 bits dropped,
// which rounds up with probability equal to the dropped fraction
// (unbiased). The plain PyTorch version
// (ops/stochastic.py:stochastic_round_to_bf16) does the same bit arithmetic
// given the bits.
//
// Random bits: the TPU kernel seeds its hardware generator per tile; here
// a counter-based Philox 4x32-10 (Salmon et al., SC'11) keyed by the leaf's
// 64-bit seed, with the index of each group of 4 elements within the leaf
// as the counter, gives each element its own 16 bits. A leaf's output is a
// function of (its seed, the index) alone: it does not depend on the launch
// configuration or on the other leaves of the list. Seeds are read from
// device memory, so the caller draws them on the card without a sync.
//
// One launch covers every leaf of an optimizer step (1588 adapter tensors
// of the SDXL QLoRA step, most a few hundred KB: one launch each never
// reached HBM rate). The wrapper (ops/sr_update.py) writes a leaf table and
// copies it to the card in one asynchronous copy: the first group of each
// leaf in the flat range of 4-element groups (a prefix of group counts,
// closed by the total), then per leaf the out, p and u pointers, the
// element count and the index of its seed. Each block stages the prefix in
// shared memory, takes a contiguous share of the flat range, finds the leaf
// of its threads' first groups by binary search and then steps leaf by
// leaf as the groups cross into the next one.
//
// Bound: bytes. 2 bytes of p and 2 (bf16) or 4 (fp32) of u read and 2
// written per element: the QLoRA step's 49,412,736 adapter elements move
// 296 MB, 0.089 ms at 3.35 TB/s. The Philox work comes close: ~25 integer
// operations per element (10 rounds of 2 32-bit multiplies, their high
// halves, 4 xors and 2 key adds per 4 elements), ~1.2 G per step, some
// 0.07-0.09 ms at the H100's 64 integer lanes per SM and clock. The one
// launch over that set took 0.172 ms on an H100 SXM at 700 W (1.9x the
// byte bound), about the two bounds added: the integer work, and not the
// bytes alone, is what a faster version has to hide.
//
// Design: one thread per 4 elements, 8-byte (bf16) or 16-byte (fp32)
// vector loads, one 8-byte store, a scalar tail per leaf; out may alias p
// (each element is read and written by one thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// One leaf of the table (5 x 64 bits), after the prefix of first groups.
struct Leaf {
  unsigned long long out, p, u;   // device pointers
  long long n;                    // elements
  long long seed_index;           // into the seeds array
};
static_assert(sizeof(Leaf) == 40, "the wrapper writes 5 int64 per leaf");

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

__device__ __forceinline__ uint2 key_of(unsigned long long seed) {
  return make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

// Elements 4*group .. 4*group+3 of one leaf.
template <typename U>
__device__ __forceinline__ void update_group(const Leaf& leaf, uint2 key, long long group) {
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(leaf.out);
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(leaf.p);
  const U* u = reinterpret_cast<const U*>(leaf.u);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(group), static_cast<uint32_t>(group >> 32), 0u, 0u),
      key);
  const uint32_t rand[4] = {r.x, r.y, r.z, r.w};
  const long long e = 4 * group;
  if (e + 4 <= leaf.n) {
    float pv[4], uv[4];
    load4(p + e, pv);
    load4(u + e, uv);
    __align__(8) __nv_bfloat16 res[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) res[i] = round_sr(pv[i] + uv[i], rand[i]);
    *reinterpret_cast<uint2*>(out + e) = *reinterpret_cast<const uint2*>(res);
  } else {
    for (int i = 0; e + i < leaf.n; ++i) {
      out[e + i] = round_sr(__bfloat162float(p[e + i]) + to_float(u[e + i]), rand[i]);
    }
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
sr_update_kernel(const long long* __restrict__ first,   // [n_leaves + 1]
                 const Leaf* __restrict__ leaves,       // [n_leaves]
                 int n_leaves, long long groups,
                 const unsigned long long* __restrict__ seeds) {
  extern __shared__ long long first_s[];
  for (int i = threadIdx.x; i <= n_leaves; i += blockDim.x) first_s[i] = first[i];
  __syncthreads();

  const long long per_block = (groups + gridDim.x - 1) / gridDim.x;
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < groups ? begin + per_block : groups;
  long long g = begin + threadIdx.x;
  if (g >= end) return;
  // the leaf of group g: first_s[leaf] <= g < first_s[leaf + 1] (an empty
  // leaf has first_s[leaf] == first_s[leaf + 1] and is never chosen)
  int lo = 0, hi = n_leaves;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first_s[mid] <= g) lo = mid; else hi = mid;
  }
  int leaf = lo;
  long long next = first_s[leaf + 1];
  Leaf cur = leaves[leaf];
  uint2 key = key_of(seeds[cur.seed_index]);
  for (; g < end; g += blockDim.x) {
    if (g >= next) {
      do {
        ++leaf;
        next = first_s[leaf + 1];
      } while (g >= next);
      cur = leaves[leaf];
      key = key_of(seeds[cur.seed_index]);
    }
    update_group<U>(cur, key, g - first_s[leaf]);
  }
}

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return count;
}

template <typename U>
int launch(const void* table, int n_leaves, long long groups, const void* seeds,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_leaves + 1) * sizeof(long long);
  // as many blocks as the card holds at once, each a contiguous share
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sr_update_kernel<U>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const long long* first = static_cast<const long long*>(table);
  sr_update_kernel<U><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      first, reinterpret_cast<const Leaf*>(first + n_leaves + 1), n_leaves, groups,
      static_cast<const unsigned long long*>(seeds));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). `table` is the leaf table on the
// device: n_leaves + 1 int64 first groups (the last is `groups`), then 5
// int64 per leaf (out, p, u pointers, n, seed index). Every p and out is
// bf16, every u fp32 when u_fp32 else bf16, contiguous, 8-byte (u fp32:
// 16-byte) aligned; seeds holds 64-bit integers on the device. out may be
// p; (n_leaves + 1) * 8 bytes of prefix must fit in 48 KB of shared memory.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ot_sr_update(const void* table, int n_leaves, long long groups, int u_fp32,
                            const void* seeds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_fp32) return launch<float>(table, n_leaves, groups, seeds, s);
  return launch<__nv_bfloat16>(table, n_leaves, groups, seeds, s);
}
