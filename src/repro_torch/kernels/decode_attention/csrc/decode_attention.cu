// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// K4 decode_attention_fwd replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//   (_decode_kernel).
//
// What bounds it on this card: each step reads the valid part of the K and
// V caches once and does 4 * D operations per (query head, cache slot), so
// it is bound by device memory bytes (about 13 MB per layer at the serving
// shape, 8 x 1088 slots x 3 kv heads x 64 dims in f32).
//
// What the design does about it: split-K ("flash-decoding"). The TPU kernel
// walks the cache of one (batch, kv head) in order on one core; here that
// would be 24 blocks on 132 SMs at the serving shape. Instead the cache is
// cut into chunks of 32 slots and one block takes one (chunk, batch, kv
// head): it stages the chunk's keys and values in shared memory (rows of
// keys padded to D + 1 floats so that the per-slot dot products are free of
// bank conflicts), scores the g query heads of the group against them,
// and writes a partial (max m, sum l, unnormalised accumulator) per query
// head. A chunk wholly at or past valid_len[b] reads nothing. A second,
// small kernel in this file combines the partials of each (batch, query
// head) with their max-rescaling and writes the output. The two launches
// are one call of K4.
//
// Layout: q (B, Hq, D) and the caches (B, C, Hkv, D) are read through their
// strides (the last dimension must be contiguous); the cache is never
// copied into the Pallas wrapper's (B * Hkv, C, D) transpose. The output is
// written contiguous (B, Hq, D). Any cache length C is taken.
//
// Numerics: f32 or bf16 inputs, f32 scores, softmax and accumulation,
// output in the input type. Build WITHOUT --use_fast_math.
//
// The entry point launches on the stream it is given, allocates nothing
// (the partials are scratch the caller allocates) and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;       // cache slots per block (one per lane)
constexpr int kThreads = 128;
constexpr int kMaxG = 16;        // query heads per kv head

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Partials are indexed by (b * Hq + query head) * n_chunks + chunk.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ vlen,
                      int vl_scalar, int C, int Hq, int Hkv, long long qsb,
                      long long qsh, long long ksb, long long kss,
                      long long ksh, long long vsb, long long vss,
                      long long vsh, float scale, float* __restrict__ pm,
                      float* __restrict__ pl, float* __restrict__ pacc) {
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[kChunk][D + 1];
  __shared__ float vs[kChunk][D];
  __shared__ float ss[kMaxG][kChunk];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int g = Hq / Hkv;
  const int vl = min(vlen ? vlen[b] : vl_scalar, C);
  const int c0 = chunk * kChunk;
  const int n = min(kChunk, vl - c0);       // valid slots of this chunk
  const long long p0 = static_cast<long long>(b * Hq + hk * g) * n_chunks + chunk;

  if (n <= 0) {                              // uniform over the block
    if (tid < g) {
      pm[p0 + static_cast<long long>(tid) * n_chunks] = -INFINITY;
      pl[p0 + static_cast<long long>(tid) * n_chunks] = 0.0f;
    }
    return;
  }
  for (int e = tid; e < g * D; e += kThreads) {
    const int i = e / D, d = e % D;
    qs[i][d] = to_f32(q[b * qsb + (hk * g + i) * qsh + d]);
  }
  const T* kb = kc + b * ksb + hk * ksh;
  const T* vb = vc + b * vsb + hk * vsh;
  for (int e = tid; e < n * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const long long slot = c0 + j;
    ks[j][d] = to_f32(kb[slot * kss + d]);
    vs[j][d] = to_f32(vb[slot * vss + d]);
  }
  __syncthreads();

  for (int e = tid; e < g * kChunk; e += kThreads) {
    const int i = e / kChunk, j = e % kChunk;
    float s = -INFINITY;
    if (j < n) {
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qs[i][d], ks[j][d], dot);
      s = dot * scale;
    }
    ss[i][j] = s;
  }
  __syncthreads();

  // one warp per query head: the chunk's max and sum, p written back
  const int lane = tid & 31;
  for (int i = tid >> 5; i < g; i += kThreads / 32) {
    const float s = ss[i][lane];
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float p = expf(s - mx);            // n >= 1, so mx is finite
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    ss[i][lane] = p;
    if (lane == 0) {
      pm[p0 + static_cast<long long>(i) * n_chunks] = mx;
      pl[p0 + static_cast<long long>(i) * n_chunks] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * D; e += kThreads) {
    const int i = e / D, d = e % D;
    float a = 0.0f;
    for (int j = 0; j < n; ++j) a = fmaf(ss[i][j], vs[j][d], a);
    pacc[(p0 + static_cast<long long>(i) * n_chunks) * D + d] = a;
  }
}

// One block of D threads per (batch, query head).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pm,
                                      const float* __restrict__ pl,
                                      const float* __restrict__ pacc,
                                      T* __restrict__ out, int n_chunks, int D) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = pm + row * n_chunks;
  const float* l = pl + row * n_chunks;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m[c]);
  float den = 0.0f, a = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    if (m[c] == -INFINITY) continue;         // an empty chunk: its acc is unset
    const float w = expf(m[c] - mx);
    den = fmaf(l[c], w, den);
    a = fmaf(pacc[(row * n_chunks + c) * D + d], w, a);
  }
  out[row * D + d] = from_f32<T>(a / fmaxf(den, 1e-30f));
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, const int* vlen,
            int vl_scalar, void* out, float* pm, float* pl, float* pacc, int B,
            int C, int Hq, int Hkv, const long long* st, float scale,
            cudaStream_t stream) {
  const int n_chunks = (C + kChunk - 1) / kChunk;
  decode_partial_kernel<T, D><<<dim3(n_chunks, B * Hkv), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), vlen, vl_scalar, C, Hq, Hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], scale, pm, pl, pacc);
  decode_combine_kernel<T><<<B * Hq, D, 0, stream>>>(pm, pl, pacc,
                                                     static_cast<T*>(out),
                                                     n_chunks, D);
}

template <typename T>
int launch_d(int D, const void* q, const void* kc, const void* vc,
             const int* vlen, int vl_scalar, void* out, float* pm, float* pl,
             float* pacc, int B, int C, int Hq, int Hkv, const long long* st,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C, Hq, Hkv, st, scale, stream); break;
    case 32: launch<T, 32>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C, Hq, Hkv, st, scale, stream); break;
    case 64: launch<T, 64>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C, Hq, Hkv, st, scale, stream); break;
    case 128: launch<T, 128>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C, Hq, Hkv, st, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_chunk() { return kChunk; }

// vlen: device pointer to B int32 valid lengths, or null to use vl_scalar.
// strides: 8 element strides, (b, h) of q, then (b, c, h) of k and of v.
// pm, pl: B * Hq * n_chunks floats; pacc: that times D (n_chunks =
// ceil(C / decode_attention_chunk())). dtype: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const int* vlen,
                                    int vl_scalar, void* out, float* pm,
                                    float* pl, float* pacc, int B, int C,
                                    int Hq, int Hkv, int D, int dtype,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C, Hq, Hkv,
                           strides, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, B, C,
                                   Hq, Hkv, strides, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
