// Blockwise symmetric int8 codec for the federated uplink, for Hopper (sm_90a).
//
// K1 int8_quantize replaces the TPU kernel
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
// (char4) where the row is aligned; neighbouring lanes touch neighbouring
// addresses. K1 gives one warp to each quantization block: the TPU kernel's
// tile of 8 blocks in VMEM becomes one warp per block with the |x| maximum
// reduced by __shfl_xor_sync, and the second pass re-reads the block's 1 KB
// from L1 rather than holding it in registers for any runtime block size.
// K1 zero-pads the ragged tail itself, so no padded copy of the input is
// ever written. K2 is one thread per 4 elements.
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

// One warp per quantization block of `block` (a multiple of 32) elements.
__global__ void int8_quantize_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s, long long n,
                                     int block, long long nb, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= nb) return;  // uniform over the warp
  const long long base = row * block;

  float amax = 0.0f;
  if (vec) {
    for (int j = lane * 4; j < block; j += 128) {
      const long long i = base + j;
      if (i + 4 <= n) {
        const float4 v = *reinterpret_cast<const float4*>(x + i);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                 fmaxf(fabsf(v.z), fabsf(v.w))));
      } else {
        for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(load_or_zero(x, i + k, n)));
      }
    }
  } else {
    for (int j = lane; j < block; j += 32)
      amax = fmaxf(amax, fabsf(load_or_zero(x, base + j, n)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? amax / 127.0f : 1.0f;
  if (lane == 0) s[row] = scale;

  if (vec) {
    for (int j = lane * 4; j < block; j += 128) {
      const long long i = base + j;
      float4 v;
      if (i + 4 <= n) {
        v = *reinterpret_cast<const float4*>(x + i);
      } else {
        v = make_float4(load_or_zero(x, i, n), load_or_zero(x, i + 1, n),
                        load_or_zero(x, i + 2, n), load_or_zero(x, i + 3, n));
      }
      char4 o;
      o.x = quant_one(v.x, scale);
      o.y = quant_one(v.y, scale);
      o.z = quant_one(v.z, scale);
      o.w = quant_one(v.w, scale);
      *reinterpret_cast<char4*>(q + i) = o;
    }
  } else {
    for (int j = lane; j < block; j += 32)
      q[base + j] = quant_one(load_or_zero(x, base + j, n), scale);
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

extern "C" int int8_quantize(const void* x, void* q, void* s, long long n,
                             int block, long long nb, void* stream) {
  if (nb <= 0) return 0;
  const bool vec = block % 128 == 0 && aligned(x, 16) && aligned(q, 4);
  const long long warps_per_cta = kThreads / 32;
  const unsigned grid = static_cast<unsigned>((nb + warps_per_cta - 1) / warps_per_cta);
  int8_quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), n, block, nb, vec);
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
