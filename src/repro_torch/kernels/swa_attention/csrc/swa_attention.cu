// Forward flash attention (causal, sliding-window or non-causal; GQA) for
// Hopper (sm_90a).
//
// K3 swa_attention_fwd replaces the TPU kernel
//   src/repro/kernels/swa_attention/kernel.py::flash_attention_pallas
//   (_attn_kernel).
//
// What bounds it on this card: the q.k and p.v products, 4 * D operations
// for every attended (query, key) pair, against q, k, v and o read and
// written once. At the serving shape (8 x 1024 tokens, 9/3 heads, D = 64,
// causal) that is about 9.7 GFLOP against 50 MB, so it is bound by
// operations, here done in f32 on the SIMT units (67 TFLOP/s at most,
// without tensor cores).
//
// What the design does about it: one block owns 64 query rows of one
// (batch, query head). It streams the key/value tiles of kv head h / g (32
// keys at a time) through shared memory and keeps each row's running max m,
// denominator l and accumulator in registers (online softmax), so the
// (S, S) score matrix never exists. Only the tiles that intersect the
// block's causal or window band are loaded, as the TPU kernel's
// pl.when(diag_ok) skips the others. Each row is owned by D / 16 lanes of
// one warp, each holding 16 of its D dimensions (dims r, r + D/16, ...), so
// the q.k partial sums meet by __shfl_xor_sync and every shared-memory read
// is a broadcast or a run of consecutive words (no bank conflicts).
// Tensor cores (wgmma) and TMA are later work.
//
// Layout: q, k, v are read in the JAX layout (B, S, H, D) through their
// strides (the last dimension must be contiguous); no transposed copy is
// made. o is written contiguous (B, S, Hq, D). Any S is taken: keys and
// query rows past S are masked here, where the Pallas kernel asserts
// S % block == 0.
//
// Numerics: f32 or bf16 inputs, f32 accumulation, output in the input
// type. Build WITHOUT --use_fast_math (expf, IEEE division). A row with no
// valid key in a chunk (possible with a window) adds nothing and makes no
// NaN: the running max is taken as 0 while it is still -inf, as the
// reference's models/common.py flash_attention guards it.
//
// The entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per shared-memory tile
constexpr int kKC = 16;          // keys per register chunk of the softmax
constexpr int kDims = 16;        // dimensions of a row held by one thread

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

template <typename T, int D>
__global__ void __launch_bounds__(kBQ * (D / kDims))
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
                     int Hkv, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, int causal,
                     int window, float scale) {
  constexpr int TPR = D / kDims;           // threads per query row
  constexpr int NT = kBQ * TPR;
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];

  const int tid = threadIdx.x;
  const int r = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + tid / TPR;
  const bool row_ok = qpos < S;

  float qr[kDims], acc[kDims];
  const T* qrow = q + b * qsb + static_cast<long long>(row_ok ? qpos : 0) * qss + h * qsh;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qr[i] = row_ok ? to_f32(qrow[r + TPR * i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  // the keys any row of this block can see
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = lo / kBK * kBK;
  const int hi = causal ? q_last + 1 : S;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();                       // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += NT) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kp < S) {
        kv = to_f32(kb[kp * kss + d]);
        vv = to_f32(vb[kp * vss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kBK; c += kKC) {
      float s[kKC];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < kDims; ++i) part = fmaf(qr[i], ks[c + j][r + TPR * i], part);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kp = k0 + c + j;
        const bool ok = kp < S && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
        s[j] = ok ? part * scale : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m - m_use);  // 0 while m is -inf
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        s[j] = expf(s[j] - m_use);         // a masked key gives exp(-inf) = 0
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
#pragma unroll
        for (int i = 0; i < kDims; ++i)
          acc[i] = fmaf(s[j], vs[c + j][r + TPR * i], acc[i]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + qpos) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < kDims; ++i) orow[r + TPR * i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S,
            int Hq, int Hkv, const long long* st, int causal, int window,
            float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  swa_attention_kernel<T, D><<<grid, kBQ * (D / kDims), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale);
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int S, int Hq, int Hkv, const long long* st, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, S, Hq, Hkv, st, causal, window, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, S, Hq, Hkv, st, causal, window, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, st, causal, window, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, st, causal, window, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 9 element strides (b, s, h) of q, then of k, then of v.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int Hq, int Hkv, int D,
                                 int dtype, const long long* strides,
                                 int causal, int window, float scale,
                                 void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, S, Hq, Hkv, strides, causal, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Hq, Hkv, strides, causal, window,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
