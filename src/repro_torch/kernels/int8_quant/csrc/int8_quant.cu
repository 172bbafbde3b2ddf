// Blockwise symmetric int8 codec for the federated uplink, for Hopper (sm_90a).
//
// K1 int8_quantize_many replaces the TPU kernel
//   src/repro/kernels/int8_quant/kernel.py::quantize_pallas (_quant_kernel).
// K2 int8_dequant_accumulate replaces
//   src/repro/kernels/int8_quant/kernel.py::dequant_accumulate_pallas
//   (_deq_acc_kernel).
//
// What bounds them on this card: both are elementwise passes with a tiny
// per-block reduction, so device memory bandwidth bounds them. K1 moves about
// 5 bytes per element (4 read, 1 written, 4/block for the scales), K2 about 9
// (4 read from the accumulator, 1 from q, 4 written), or 5 with no
// accumulator (plain dequantize).
//
// What the design does about it: every element is read from and written to
// device memory once, with 16-byte loads (float4) and 4-byte int8 stores
// (char4) where the data is aligned; neighbouring lanes touch neighbouring
// addresses. K1 gives each quantization block to one warp: the TPU kernel's
// tile of 8 blocks in VMEM becomes a warp's blocks with the |x| maximum
// reduced by __shfl_xor_sync. One launch quantizes a whole table of leaves
// (a round's client delta: 24 tensors of 16 to 134M elements), so the small
// leaves do not each pay a launch: the table (each leaf's pointer, element
// count and first block, up to kMaxLeaves of them) is passed by value as a
// __grid_constant__ parameter, so no host-to-device copy is made and a CUDA
// graph captures it with the launch. A warp finds its leaf by a binary
// search over the first blocks; a leaf's blocks are contiguous in the
// output, so a block never spans two leaves, and each leaf's ragged tail is
// zero-padded inside the kernel, so no padded copy of the input is ever
// written. For the main path's block of 256 a warp takes 4 consecutive
// blocks and starts all their loads (8 float4 a lane) before the first
// maximum, keeping them in registers for the quantization: enough bytes in
// flight to reach near the memory rate with one warp's search amortised
// over its blocks. Other blocks of up to 1024 elements keep theirs in
// registers too (one block a warp); longer ones re-read theirs from L1.
// K2 is one thread per 4 elements.
//
// Numerics: build WITHOUT --use_fast_math. x / scale and amax / 127 are IEEE
// divisions, and rintf rounds half to even like jnp.round (roundf would round
// half away from zero), so q is bit-equal to the reference. K2 uses the
// _rn intrinsics so that no multiply-add is contracted into an fma and the
// result is bit-equal to acc + w * (q * s) evaluated in that order.
//
// Each entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_or_zero(const float* __restrict__ x,
                                              long long i, long long n) {
  return i < n ? x[i] : 0.0f;
}

__device__ __forceinline__ int8_t quant_one(float v, float scale) {
  float r = rintf(v / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

constexpr int kMaxLeaves = 64;      // leaves one launch takes
constexpr int kRegBlock = 1024;     // longest block kept in registers

// The leaves of one launch: leaf i is x[i][0, n[i]) and owns output blocks
// [first[i], first[i + 1]); first[count] is the launch's block count.
struct LeafTable {
  const float* x[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first[kMaxLeaves + 1];
  int count;
};

// Elements [i, i + 4) of a leaf, zeros past n: one 16-byte load where the
// leaf's data is 16-byte aligned (vec), else four 4-byte loads.
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long i, long long n, bool vec) {
  if (vec && i + 4 <= n) return *reinterpret_cast<const float4*>(x + i);
  return make_float4(load_or_zero(x, i, n), load_or_zero(x, i + 1, n),
                     load_or_zero(x, i + 2, n), load_or_zero(x, i + 3, n));
}

__device__ __forceinline__ float amax4(float a, float4 v) {
  return fmaxf(a, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

__device__ __forceinline__ char4 quant4(float4 v, float scale) {
  char4 o;
  o.x = quant_one(v.x, scale);
  o.y = quant_one(v.y, scale);
  o.z = quant_one(v.z, scale);
  o.w = quant_one(v.w, scale);
  return o;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ float block_scale(float amax) {
  return amax > 0.0f ? amax / 127.0f : 1.0f;
}

// The leaf that owns output block `row`: the last one with first <= row.
__device__ __forceinline__ int find_leaf(const LeafTable& tab, long long row) {
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const float* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// K1 for the main path's block of kRowBlock = 256: a warp quantizes kRows
// consecutive output blocks, lane l holding elements 4 l and 4 l + 128 of
// each. Every load of the warp's blocks is in flight before the first
// maximum is taken (8 float4 a lane), and the quantization reads the
// registers.
constexpr int kRowBlock = 256;
constexpr int kRows = 4;

__global__ void __launch_bounds__(kThreads)
int8_quantize_rows_kernel(const __grid_constant__ LeafTable tab,
                          int8_t* __restrict__ q, float* __restrict__ s) {
  constexpr int kChunks = kRowBlock / 128;
  const int lane = threadIdx.x & 31;
  const long long total = tab.first[tab.count];
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * kRows;
  if (row0 >= total) return;  // uniform over the warp
  int leaf = find_leaf(tab, row0);
  float4 v[kRows][kChunks];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const long long row = row0 + rr;
    if (row < total) {
      while (tab.first[leaf + 1] <= row) ++leaf;
      const float* __restrict__ x = tab.x[leaf];
      const long long n = tab.n[leaf];
      const bool vec = aligned16(x);
      const long long base = (row - tab.first[leaf]) * kRowBlock + lane * 4;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) v[rr][c] = load4(x, base + c * 128, n, vec);
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const long long row = row0 + rr;
    if (row >= total) break;  // uniform over the warp
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) amax = amax4(amax, v[rr][c]);
    const float scale = block_scale(warp_max(amax));
    if (lane == 0) s[row] = scale;
    int8_t* __restrict__ qr = q + row * kRowBlock + lane * 4;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      *reinterpret_cast<char4*>(qr + c * 128) = quant4(v[rr][c], scale);
  }
}

// K1 for any other block (a multiple of 32): one warp a block; up to
// kRegBlock elements kept in registers (lane l: elements l + 32 c), longer
// blocks re-read from L1.
__global__ void __launch_bounds__(kThreads)
int8_quantize_any_kernel(const __grid_constant__ LeafTable tab,
                         int8_t* __restrict__ q, float* __restrict__ s, int block) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= tab.first[tab.count]) return;  // uniform over the warp
  const int leaf = find_leaf(tab, row);
  const float* __restrict__ x = tab.x[leaf];
  const long long n = tab.n[leaf];
  const long long base = (row - tab.first[leaf]) * block;
  int8_t* __restrict__ qr = q + row * block;
  float amax = 0.0f;
  if (block <= kRegBlock) {
    float v[kRegBlock / 32];
#pragma unroll
    for (int c = 0; c < kRegBlock / 32; ++c)
      if (c * 32 < block) v[c] = load_or_zero(x, base + lane + c * 32, n);
#pragma unroll
    for (int c = 0; c < kRegBlock / 32; ++c)
      if (c * 32 < block) amax = fmaxf(amax, fabsf(v[c]));
    const float scale = block_scale(warp_max(amax));
    if (lane == 0) s[row] = scale;
#pragma unroll
    for (int c = 0; c < kRegBlock / 32; ++c)
      if (c * 32 < block) qr[lane + c * 32] = quant_one(v[c], scale);
  } else {
    const bool vec = block % 128 == 0 && aligned16(x);
    if (vec) {
      for (int j = lane * 4; j < block; j += 128)
        amax = amax4(amax, load4(x, base + j, n, true));
    } else {
      for (int j = lane; j < block; j += 32)
        amax = fmaxf(amax, fabsf(load_or_zero(x, base + j, n)));
    }
    const float scale = block_scale(warp_max(amax));
    if (lane == 0) s[row] = scale;
    if (vec) {
      for (int j = lane * 4; j < block; j += 128)
        *reinterpret_cast<char4*>(qr + j) = quant4(load4(x, base + j, n, true), scale);
    } else {
      for (int j = lane; j < block; j += 32)
        qr[j] = quant_one(load_or_zero(x, base + j, n), scale);
    }
  }
}

__device__ __forceinline__ float deq_acc_one(float a, int8_t qv, float sc, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fmul_rn(static_cast<float>(qv), sc)));
}

// out[i] = acc[i] + w * (q[i] * s[i / block]) over the first n elements of
// the (nb, block) layout; acc == nullptr reads as zeros.
__global__ void int8_dequant_accumulate_kernel(const float* __restrict__ acc,
                                               const int8_t* __restrict__ q,
                                               const float* __restrict__ s,
                                               float w, float* __restrict__ out,
                                               long long n, int block, bool vec) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    // block is a multiple of 32, so the 4 elements share one row
    const float sc = s[i / block];
    const char4 qq = *reinterpret_cast<const char4*>(q + i);
    const float4 a = acc ? *reinterpret_cast<const float4*>(acc + i)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o;
    o.x = deq_acc_one(a.x, qq.x, sc, w);
    o.y = deq_acc_one(a.y, qq.y, sc, w);
    o.z = deq_acc_one(a.z, qq.z, sc, w);
    o.w = deq_acc_one(a.w, qq.w, sc, w);
    *reinterpret_cast<float4*>(out + i) = o;
  } else {
    for (int k = 0; k < 4 && i + k < n; ++k) {
      const long long e = i + k;
      out[e] = deq_acc_one(acc ? acc[e] : 0.0f, q[e], s[e / block], w);
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

extern "C" int int8_max_leaves() { return kMaxLeaves; }

// Quantizes `count` (1..kMaxLeaves) leaves in one launch: leaf i is xs[i]
// (f32, contiguous, ns[i] elements) and its blocks are rows
// [firsts[i], firsts[i + 1]) of q (int8, (firsts[count], block)) and s
// (f32, (firsts[count],)). q must be 4-byte aligned.
extern "C" int int8_quantize_many(const void* const* xs, const long long* ns,
                                  const long long* firsts, int count, void* q,
                                  void* s, int block, void* stream) {
  if (count <= 0 || count > kMaxLeaves || block <= 0 || block % 32 ||
      !aligned(q, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable tab;
  for (int i = 0; i < count; ++i) {
    tab.x[i] = static_cast<const float*>(xs[i]);
    tab.n[i] = ns[i];
    tab.first[i] = firsts[i];
  }
  tab.first[count] = firsts[count];
  tab.count = count;
  const long long nb = firsts[count];
  if (nb <= 0) return 0;
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block == kRowBlock) {
    const long long rows_per_cta = (kThreads / 32) * kRows;
    const unsigned grid = static_cast<unsigned>((nb + rows_per_cta - 1) / rows_per_cta);
    int8_quantize_rows_kernel<<<grid, kThreads, 0, st>>>(tab, qq, ss);
  } else {
    const long long warps_per_cta = kThreads / 32;
    const unsigned grid = static_cast<unsigned>((nb + warps_per_cta - 1) / warps_per_cta);
    int8_quantize_any_kernel<<<grid, kThreads, 0, st>>>(tab, qq, ss, block);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_dequant_accumulate(const void* acc, const void* q,
                                       const void* s, float w, void* out,
                                       long long n, int block, void* stream) {
  if (n <= 0) return 0;
  const bool vec = aligned(q, 4) && aligned(out, 16) &&
                   (acc == nullptr || aligned(acc, 16));
  const long long per_cta = static_cast<long long>(kThreads) * 4;
  const unsigned grid = static_cast<unsigned>((n + per_cta - 1) / per_cta);
  int8_dequant_accumulate_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), w, static_cast<float*>(out), n, block, vec);
  return static_cast<int>(cudaGetLastError());
}
