// The RWKV6 WKV recurrence for Hopper (sm_90a).
//
// K5 wkv_fwd replaces the TPU kernel
//   src/repro/kernels/wkv/kernel.py::wkv_pallas (_wkv_kernel).
//
// For each (batch, head) panel, with a (D, D) f32 state S:
//   o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// and the final S is written back over the state it started from.
//
// What bounds it on this card: each input is read once and o written once,
// and the state is read and written once per panel; the work is 4 * D^2
// operations per (token, head). At the serving prefill shape (B 8, T 1024,
// H 64, D 64, f32) that is 671 MB of r/k/v/w/o plus 16.8 MB of state,
// about 0.205 ms at 3.35 TB/s, against 8.6 GFLOP, about 0.128 ms at the 67
// TFLOP/s f32 rate: bound by bytes. But a step costs three f32 instructions
// per state entry (o's fma, k v's product, the decay's fma), 6.4e9 of them
// at that shape, about 0.19 ms on 132 SMs x 128 lanes at 1.98 GHz: the two
// limits are nearly equal, so loads must overlap the arithmetic. At a
// decode step (T 1) the state dominates: 17.4 MB, about 5.2 us.
//
// What the design does about it: the TPU kernel keeps S in VMEM across a
// sequential grid axis of time chunks. Blocks here run in parallel and in
// no order, so the time loop is inside one block, one block per panel, and
// the state stays in registers for the whole sequence:
// * Rows split over kR = 4 row groups. Thread (group g, pair p) holds the
//   state entries of columns 2p and 2p+1 in the rows of its group, the
//   4-row chunks g, g + 4, g + 8, ... (D / 4 rows, 32 values at D 64), so a
//   block has 2 D threads (4 warps at D 64, 16 warps on an SM at the
//   serving shape instead of 8). A warp is one row group (at D >= 64), so
//   the r, k, w chunks of a step are 16-byte shared loads at one address
//   for the whole warp (broadcasts), and v one 8-byte load a lane. Each
//   thread sums o over its rows in two partial sums a column (rows 0 and 2
//   of its chunks, rows 1 and 3), adds them and stores the pair to a
//   partial buffer in shared memory; after the tile, the block adds the
//   groups' partials as ((g0 + g1) + (g2 + g3)) and writes o with 16-byte
//   stores.
// * Loads overlap the recurrence. r, k, v, w are staged kTT timesteps at a
//   time through a ring of kStages tiles in dynamic shared memory, filled
//   by 16-byte cp.async copies of the raw input (bf16 stays 2 bytes and is
//   converted on read). While tile n runs, tiles n+1 to n+3 are in flight.
// * The bonus term folds into a scalar:
//     o_t[j] = sum_i r_t[i] S[i][j] + a_t v_t[j],  a_t = sum_i r_t[i] u[i] k_t[i],
//   and a_t for the steps of a tile is computed by every lane before the
//   tile's steps, each lane one 4-row chunk of one step (D / 4 lanes a
//   step, added by a butterfly of __shfl_xor_sync); the combine adds
//   a_t v_t[j].
//   A tile costs two __syncthreads: one before its steps, one before its
//   combine.
// This changes the order of summation against the plain version (within
// its f32 / bf16 tolerances); tests/test_torch_wkv_design.py emulates this
// order on the CPU against the JAX reference.
//
// Layout: r, k, v, w are (B, T, H, D), the model's layout, read through
// their strides (the last dimension contiguous; pointers and other strides
// multiples of 16 bytes, which the wrapper ensures), never transposed into
// the Pallas wrapper's (B * H, T, D). u is f32 (H, D) or (B, H, D) (a batch
// stride of 0 shares it over the batch). The state is f32 (B, H, D, D)
// with contiguous (D, D) panels. o is written through its strides (16-byte
// aligned rows, as the wrapper's contiguous allocation gives), in the
// input type. Any T, including 1 (a decode step) and a ragged T (the
// Pallas kernel needs T % chunk == 0); T = 0 leaves S as it was.
//
// Numerics: f32 or bf16 r/k/v/w, f32 u, state and sums. Build WITHOUT
// --use_fast_math.
//
// The entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 4;          // row groups: threads that share a column's rows
constexpr int kC = 2;          // state columns a thread holds
constexpr int kTT = 8;         // timesteps per tile
constexpr int kStages = 4;     // tiles in the shared-memory ring
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int D>
struct Cfg {
  static constexpr int kThreads = kR * D / kC;          // 2 D
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCols = D / kC;                  // threads of a row group
  static constexpr int kChunks = D / (4 * kR);          // 4-row chunks a thread
  static constexpr int kArr = kTT * D;                  // elements of one array's tile
  static constexpr int kStage = 4 * kArr;               // r, k, v, w
  static constexpr int kCopies = D * static_cast<int>(sizeof(T)) / 16;  // a row
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kStage * sizeof(T) +
      (static_cast<size_t>(kTT) * kR * D + kTT + D) * sizeof(float);
  static_assert(kChunks >= 1 && kThreads % 32 == 0 && kThreads <= 1024, "tiling");
};

// Element strides: (b, t, h) of r, k, v, w and o, then (b, h) of u and of
// the state.
struct Strides {
  long long r[3], k[3], v[3], w[3], o[3];
  long long u[2], s[2];
};

// 4 consecutive staged elements as floats (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// 2 consecutive staged elements as floats
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
// 4 consecutive outputs (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x.x)) |
                      (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x.y))) << 16);
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(x.z)) |
                      (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x.w))) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
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

// Copies timesteps [t0, t0 + kTT) of r, k, v, w into one stage (steps past
// T_len are zero-filled), as one cp.async group; a tile wholly past T_len
// copies nothing and commits an empty group.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* stage, const T* const (&src)[4],
                                          const long long (&tstride)[4], int t0,
                                          int T_len, int tid) {
  using F = Cfg<T, D>;
  constexpr int kPer = kTT * F::kCopies;             // copies of one array
  constexpr int kIters = (kPer + F::kThreads - 1) / F::kThreads;
  constexpr int kEl = 16 / static_cast<int>(sizeof(T));
  if (t0 < T_len) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int c = tid + it * F::kThreads;
        if (kPer % F::kThreads == 0 || c < kPer) {
          const int tt = c / F::kCopies, part = c % F::kCopies;
          const bool ok = t0 + tt < T_len;
          const T* g = src[a] + (ok ? static_cast<long long>(t0 + tt) * tstride[a] : 0) +
                       part * kEl;
          cp_async16(stage + a * F::kArr + tt * D + part * kEl, g, ok);
        }
      }
  }
  cp_async_commit();
}

// a_t = sum_i r_t[i] u[i] k_t[i] for the kTT steps of one stage: warp w
// takes steps w kSpw ... (w + 1) kSpw - 1 with kLps = D / 4 lanes a step;
// lane l sums the 4 rows of chunk l % kLps of step w kSpw + l / kLps, and a
// butterfly of __shfl_xor_sync over the step's lanes adds the chunks.
template <typename T, int D>
__device__ __forceinline__ void bonus_pass(const T* stage, const float* us,
                                           float* as, int warp, int lane) {
  using F = Cfg<T, D>;
  constexpr int kSpw = kTT / F::kWarps;      // steps a warp
  constexpr int kLps = 32 / kSpw;            // lanes a step: D / 4
  static_assert(kLps * 4 == D, "one 4-row chunk a lane");
  const int tt = warp * kSpw + lane / kLps, c = lane % kLps;
  const float4 r4 = ld4(stage + tt * D + 4 * c);
  const float4 k4 = ld4(stage + F::kArr + tt * D + 4 * c);
  const float4 u4 = *reinterpret_cast<const float4*>(us + 4 * c);
  float x = 0.0f;
  x = fmaf(r4.x * u4.x, k4.x, x);
  x = fmaf(r4.y * u4.y, k4.y, x);
  x = fmaf(r4.z * u4.z, k4.z, x);
  x = fmaf(r4.w * u4.w, k4.w, x);
#pragma unroll
  for (int off = kLps / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  if (c == 0) as[tt] = x;
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads, Cfg<T, D>::kMinBlocks)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ state,
               T* __restrict__ o, int T_len, int H, Strides st) {
  using F = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* ps = reinterpret_cast<float*>(smem + kStages * F::kStage * sizeof(T));  // [kTT][kR][D]
  float* as = ps + kTT * kR * D;                                                 // [kTT]
  float* us = as + kTT;                                                          // [D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / F::kCols;          // row group (one per warp at D >= 64)
  const int j0 = kC * (tid % F::kCols);  // the thread's columns: j0, j0 + 1
  const long long b = blockIdx.x / H;
  const long long h = blockIdx.x % H;
  const T* const src[4] = {r + b * st.r[0] + h * st.r[2], k + b * st.k[0] + h * st.k[2],
                           v + b * st.v[0] + h * st.v[2], w + b * st.w[0] + h * st.w[2]};
  const long long tstride[4] = {st.r[1], st.k[1], st.v[1], st.w[1]};
  T* op = o + b * st.o[0] + h * st.o[2];
  float* sp = state + b * st.s[0] + h * st.s[1];
  const int n_tiles = (T_len + kTT - 1) / kTT;

  // the first kStages - 1 tiles in flight before anything else
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    load_tile<T, D>(ring + s * F::kStage, src, tstride, s * kTT, T_len, tid);
  if (tid < D) us[tid] = u[b * st.u[0] + h * st.u[1] + tid];
  // S[m][e][c] = state[4 (g + kR m) + e][j0 + c]
  float S[F::kChunks][4][kC];
#pragma unroll
  for (int m = 0; m < F::kChunks; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 s2 = *reinterpret_cast<const float2*>(
          sp + (4 * (g + kR * m) + e) * D + j0);
      S[m][e][0] = s2.x;
      S[m][e][1] = s2.y;
    }

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<kStages - 2>();        // tile n (this thread's copies)
    // everyone's copies of tile n are visible, and tile n - 1's stage, its
    // partials and its a_t are consumed
    __syncthreads();
    const int nxt = n + kStages - 1;
    load_tile<T, D>(ring + (nxt % kStages) * F::kStage, src, tstride, nxt * kTT,
                    T_len, tid);
    const T* rs = ring + (n % kStages) * F::kStage;
    const T* ks = rs + F::kArr;
    const T* vs = rs + 2 * F::kArr;
    const T* ws = rs + 3 * F::kArr;
    const int t0 = n * kTT, steps = min(kTT, T_len - t0);
    bonus_pass<T, D>(rs, us, as, warp, lane);
    for (int tt = 0; tt < steps; ++tt) {
      const float2 v2 = ld2(vs + tt * D + j0);
      const float vv[kC] = {v2.x, v2.y};
      float acc[kC][2] = {};              // rows e = 0, 2 and e = 1, 3
#pragma unroll
      for (int m = 0; m < F::kChunks; ++m) {
        const int i = 4 * (g + kR * m);
        const float4 r4 = ld4(rs + tt * D + i);
        const float4 k4 = ld4(ks + tt * D + i);
        const float4 w4 = ld4(ws + tt * D + i);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc[c][e & 1] = fmaf(rr[e], S[m][e][c], acc[c][e & 1]);
            S[m][e][c] = fmaf(ww[e], S[m][e][c], kk[e] * vv[c]);
          }
      }
      *reinterpret_cast<float2*>(ps + (tt * kR + g) * D + j0) =
          make_float2(acc[0][0] + acc[0][1], acc[1][0] + acc[1][1]);
    }
    __syncthreads();                     // the tile's partials and a_t
    // o_t[j] = a_t v_t[j] + ((g0 + g1) + (g2 + g3)) over the groups'
    // partials, 4 columns a thread
    for (int q = tid; q < steps * (D / 4); q += F::kThreads) {
      const int tt = q / (D / 4), j = 4 * (q % (D / 4));
      const float* pt = ps + tt * kR * D + j;
      const float4 p0 = *reinterpret_cast<const float4*>(pt);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + D);
      const float4 p2 = *reinterpret_cast<const float4*>(pt + 2 * D);
      const float4 p3 = *reinterpret_cast<const float4*>(pt + 3 * D);
      const float4 v4 = ld4(vs + tt * D + j);
      const float a = as[tt];
      st4(op + static_cast<long long>(t0 + tt) * st.o[1] + j,
          make_float4(fmaf(a, v4.x, (p0.x + p1.x) + (p2.x + p3.x)),
                      fmaf(a, v4.y, (p0.y + p1.y) + (p2.y + p3.y)),
                      fmaf(a, v4.z, (p0.z + p1.z) + (p2.z + p3.z)),
                      fmaf(a, v4.w, (p0.w + p1.w) + (p2.w + p3.w))));
    }
  }
  cp_async_wait<0>();                    // no copy outlives the block
  // the block read its whole panel above, before any write
#pragma unroll
  for (int m = 0; m < F::kChunks; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float2*>(sp + (4 * (g + kR * m) + e) * D + j0) =
          make_float2(S[m][e][0], S[m][e][1]);
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, float* state, void* o, int B, int T_len, int H,
           const Strides& st, cudaStream_t stream) {
  using F = Cfg<T, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(F::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  wkv_fwd_kernel<T, D><<<B * H, F::kThreads, F::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state,
      static_cast<T*>(o), T_len, H, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* r, const void* k, const void* v,
             const void* w, const float* u, float* state, void* o, int B,
             int T_len, int H, const Strides& st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, state, o, B, T_len, H, st, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, state, o, B, T_len, H, st, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, state, o, B, T_len, H, st, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, state, o, B, T_len, H, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 19 element strides, (b, t, h) of r, k, v, w and o, then (b, h)
// of u and of the state. dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, o).
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const void* w, const float* u, float* state, void* o,
                       int B, int T_len, int H, int D, int dtype,
                       const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  if (static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* dst[7] = {st.r, st.k, st.v, st.w, st.o, st.u, st.s};
  const int n[7] = {3, 3, 3, 3, 3, 2, 2};
  for (int a = 0, q = 0; a < 7; ++a)
    for (int i = 0; i < n[a]; ++i) dst[a][i] = strides[q++];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, r, k, v, w, u, state, o, B, T_len, H, st, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, r, k, v, w, u, state, o, B, T_len, H, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
