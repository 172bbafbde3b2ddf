// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// K4 decode_attention_fwd replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//   (_decode_kernel).
//
// What bounds it on this card: each step reads the valid part of the K and
// V caches once and does 4 * D operations per (query head, cache slot), so
// it is bound by device memory bytes (about 13 MB per layer at the serving
// shape, 8 x 1088 slots x 3 kv heads x 64 dims x 2 in f32, which a decode
// step finds cold in L2: each layer has its own cache).
//
// What the design does about it: one launch that streams the cache. The
// TPU kernel walks the cache of one (batch, kv head) in order on one core;
// here that would be 24 blocks on 132 SMs at the serving shape. So the
// grid is (split, batch * kv head), the split length chosen on the host
// (kernel.py plan_splits) so that the grid holds about four blocks an SM,
// which the card keeps resident at once (at most 32 splits). A block takes the g query heads of its kv head and walks its
// split in tiles of kTile slots through a kStages-deep ring in shared
// memory, filled by 16-byte cp.async copies (an f32 row of D 64 is 16
// copies, a bf16 row 8), so that the next tiles' bytes are in flight while
// one tile is scored. Rows are padded by 16 bytes, so the per-slot dot
// products (one slot per lane, 16-byte shared loads) are free of bank
// conflicts. Across its tiles a block keeps an online softmax (m, l, acc)
// per query head, so it writes one partial per query head, not one per
// tile; tiles at or past valid_len[b] are not read. The combine happens
// in the same launch: each block writes its partials, fences, and counts
// itself in on a per-(batch, kv head) counter with atomicAdd; the block
// that arrives last merges the group's partials and writes the output,
// then resets the counter to 0.
//
// The counters are an int32 buffer of B * Hkv zeros that the caller keeps
// (kernel.py keeps one per device). Every launch leaves them at 0, and
// their address does not change, so a launch captured in a CUDA graph
// replays correctly. Two launches that run at the same time on different
// streams with the same buffer would count into each other's counters:
// the port calls K4 on one stream only.
//
// Layout: q (B, Hq, D) and the caches (B, C, Hkv, D) are read through their
// strides (the last dimension contiguous; the caches 16-byte aligned, which
// the wrapper ensures); nothing is transposed. The output is written
// contiguous (B, Hq, D). Any cache length C is taken.
//
// Numerics: f32 or bf16 inputs, f32 scores, softmax and accumulation,
// output in the input type. A row with no valid slot gives 0. Build
// WITHOUT --use_fast_math.
//
// The entry point launches on the stream it is given, allocates nothing
// (the partials and the counters are buffers the caller owns) and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // cache slots per tile (one per lane)
constexpr int kStages = 3;       // tiles in the shared-memory ring
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxSplits = 32;   // splits per (batch, kv head): one per lane

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
struct Cfg {
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // per copy
  static constexpr int kCpr = D / kEpc;                            // copies a row
  static constexpr int kLds = D + kEpc;          // padded shared row (elements)
  static constexpr int kStage = 2 * kTile * kLds;  // K tile then V tile
  static constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
};

template <typename T, int D>
size_t smem_bytes(int g) {
  using F = Cfg<T, D>;
  return kStages * F::kStage * sizeof(T) +
         (static_cast<size_t>(g) * (D + kTile) + 3 * g) * sizeof(float);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q (f32 in shared) . one cached key row (T in shared), both 16-byte aligned
// (four partial sums, so that the chain of dependent FMAs is D / 4 long)
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const float* k) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 kv = reinterpret_cast<const float4*>(k)[c];
    const float4 qv = reinterpret_cast<const float4*>(q)[c];
    a[0] = fmaf(qv.x, kv.x, a[0]);
    a[1] = fmaf(qv.y, kv.y, a[1]);
    a[2] = fmaf(qv.z, kv.z, a[2]);
    a[3] = fmaf(qv.w, kv.w, a[3]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(k)[c];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {      // bf16 -> f32 is exact: the top 16 bits
      a[h] = fmaf(q[8 * c + 2 * h], __uint_as_float(w[h] << 16), a[h]);
      a[h] = fmaf(q[8 * c + 2 * h + 1], __uint_as_float(w[h] & 0xffff0000u), a[h]);
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Partials are indexed by (b * Hq + query head) * n_split + split.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_combine_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ vlen,
              int vl_scalar, int C, int Hq, int Hkv, int split_len,
              long long qsb, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh,
              float scale, T* __restrict__ out, float* __restrict__ pm,
              float* __restrict__ pl, float* __restrict__ pacc,
              int* __restrict__ counters) {
  using F = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int g = Hq / Hkv;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + kStages * F::kStage * sizeof(T));
  float* ss = qs + g * D;          // g x kTile scores, then probabilities
  float* ms = ss + g * kTile;      // running max per query head
  float* ls = ms + g;              // running sum
  float* cs = ls + g;              // this tile's rescale of acc

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int grp = blockIdx.y, b = grp / Hkv, hk = grp % Hkv;
  const int vl = max(0, min(vlen ? vlen[b] : vl_scalar, C));
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, vl);          // this split's valid end
  const int n_tiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;
  const T* kb = kc + b * ksb + hk * ksh;
  const T* vb = vc + b * vsb + hk * vsh;

  auto load = [&](int tile) {
    const int t0 = s0 + tile * kTile;
    T* kd = ring + (tile % kStages) * F::kStage;
    T* vd = kd + kTile * F::kLds;
    for (int c = tid; c < kTile * F::kCpr; c += kThreads) {
      const int row = c / F::kCpr, off = (c % F::kCpr) * F::kEpc;
      const bool ok = t0 + row < s1;               // else zero-filled
      const long long slot = ok ? t0 + row : 0;
      cp_async16(kd + row * F::kLds + off, kb + slot * kss + off, ok);
      cp_async16(vd + row * F::kLds + off, vb + slot * vss + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }
  for (int e = tid; e < g * D; e += kThreads)
    qs[e] = to_f32(q[b * qsb + (hk * g + e / D) * qsh + e % D]);
  for (int i = tid; i < g; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.0f;
  }
  float acc[F::kAcc];
#pragma unroll
  for (int r = 0; r < F::kAcc; ++r) acc[r] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();      // tile it has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) load(it + kStages - 1);
    cp_async_commit();
    const T* kt = ring + (it % kStages) * F::kStage;
    const T* vt = kt + kTile * F::kLds;
    // slots at or past the split's valid end: masked here, zero-filled V
    const int nv = min(kTile, s1 - (s0 + it * kTile));   // >= 1

    for (int e = tid; e < g * kTile; e += kThreads) {
      const int i = e / kTile, j = e % kTile;
      ss[e] = j < nv ? dot_row<D>(qs + i * D, kt + j * F::kLds) * scale
                     : -INFINITY;
    }
    __syncthreads();
    // one warp per query head: the tile's max, the rescale, p written back
    for (int i = warp; i < g; i += kWarps) {
      const float s = ss[i * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[i];
      const float m_new = fmaxf(m_old, mx);        // finite: nv >= 1
      const float p = expf(s - m_new);             // a masked slot gives 0
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[i * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);    // 0 while m_old is -inf
        ms[i] = m_new;
        ls[i] = ls[i] * corr + sum;
        cs[i] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < F::kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * D) {
        const int i = e / D, d = e % D;
        const float* p = ss + i * kTile;
        float a[4] = {acc[r] * cs[i], 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kTile; ++j)      // p is 0 past nv, V zero-filled
          a[j & 3] = fmaf(p[j], to_f32(vt[j * F::kLds + d]), a[j & 3]);
        acc[r] = (a[0] + a[1]) + (a[2] + a[3]);
      }
    }
  }
  __syncthreads();                     // ms / ls final for every thread

  const long long row0 = static_cast<long long>(b) * Hq + hk * g;
#pragma unroll
  for (int r = 0; r < F::kAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * D)
      pacc[((row0 + e / D) * n_split + split) * D + e % D] = acc[r];
  }
  for (int i = tid; i < g; i += kThreads) {
    pm[(row0 + i) * n_split + split] = ms[i];
    pl[(row0 + i) * n_split + split] = ls[i];
  }
  // publish the partials, then count this block in; the last one combines
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + grp, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // one warp per query head, lane c holding split c (n_split <= 32): the
  // weight of each split, exp(m_c - max) / sum, into ss
  for (int i = warp; i < g; i += kWarps) {
    const long long row = row0 + i;
    const float mc = lane < n_split ? __ldcg(pm + row * n_split + lane) : -INFINITY;
    const float lc = lane < n_split ? __ldcg(pl + row * n_split + lane) : 0.0f;
    float mx = mc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float w = mc == -INFINITY ? 0.0f : expf(mc - mx);   // an empty split: 0
    float den = lc * w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    ss[i * kTile + lane] = w / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < g * D; e += kThreads) {
    const int i = e / D;
    const float* a = pacc + (row0 + i) * n_split * D + e % D;
    float num = 0.0f;
#pragma unroll 8
    for (int c = 0; c < n_split; ++c)
      num = fmaf(__ldcg(a + static_cast<long long>(c) * D), ss[i * kTile + c], num);
    out[row0 * D + e] = from_f32<T>(num);
  }
  if (tid == 0) counters[grp] = 0;
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* vlen,
           int vl_scalar, void* out, float* pm, float* pl, float* pacc,
           int* counters, int B, int C, int Hq, int Hkv, int split_len,
           const long long* st, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {     // room for kMaxG query heads, set once per type
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partial_combine_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, D>(kMaxG)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_split = (C + split_len - 1) / split_len;
  decode_partial_combine_kernel<T, D><<<dim3(n_split, B * Hkv), kThreads,
                        smem_bytes<T, D>(Hq / Hkv), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), vlen, vl_scalar, C, Hq, Hkv, split_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale,
      static_cast<T*>(out), pm, pl, pacc, counters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* kc, const void* vc,
             const int* vlen, int vl_scalar, void* out, float* pm, float* pl,
             float* pacc, int* counters, int B, int C, int Hq, int Hkv,
             int split_len, const long long* st, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, counters, B, C, Hq, Hkv, split_len, st, scale, stream);
    case 32: return launch<T, 32>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, counters, B, C, Hq, Hkv, split_len, st, scale, stream);
    case 64: return launch<T, 64>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, counters, B, C, Hq, Hkv, split_len, st, scale, stream);
    case 128: return launch<T, 128>(q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc, counters, B, C, Hq, Hkv, split_len, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_tile() { return kTile; }

// vlen: device pointer to B int32 valid lengths, or null to use vl_scalar.
// strides: 8 element strides, (b, h) of q, then (b, c, h) of k and of v.
// split_len: cache slots per split (a multiple of decode_attention_tile());
// n_split = ceil(C / split_len), at most 32. pm, pl: B * Hq * n_split
// floats; pacc: that times D.
// counters: B * Hkv int32 zeros, left zero. dtype: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const int* vlen,
                                    int vl_scalar, void* out, float* pm,
                                    float* pl, float* pacc, int* counters,
                                    int B, int C, int Hq, int Hkv, int D,
                                    int dtype, int split_len,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || split_len <= 0 ||
      split_len % kTile != 0 || (C + split_len - 1) / split_len > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, kc, vc, vlen, vl_scalar, out, pm, pl, pacc,
                           counters, B, C, Hq, Hkv, split_len, strides, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, kc, vc, vlen, vl_scalar, out, pm, pl,
                                   pacc, counters, B, C, Hq, Hkv, split_len,
                                   strides, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
