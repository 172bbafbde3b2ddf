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
// TFLOP/s f32 rate: bound by bytes. At a decode step (T 1) the state
// dominates: 17.4 MB, about 5.2 us.
//
// What the design does about it: the TPU kernel keeps S in VMEM across a
// sequential grid axis of time chunks. Blocks here run in parallel and in
// no order, so the time loop is inside one block: one block of D threads
// per panel, thread j holding column j of S in D registers for the whole
// sequence, so the state never leaves the SM between steps. Timesteps are
// staged a tile at a time in shared memory (r, k, w read by every thread as
// broadcasts, v by its own thread). The bonus term folds into a scalar:
//   o_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j],
// and the scalar a_t = sum_i r_t[i] u[i] k_t[i] of each staged step is
// computed once per tile; so a step costs 4 * D operations per thread
// instead of the reference's 7 * D. This changes the order of summation
// against the plain version (within its f32 / bf16 tolerances).
//
// Layout: r, k, v, w are (B, T, H, D), the model's layout, read through
// their strides (the last dimension must be contiguous), never transposed
// into the Pallas wrapper's (B * H, T, D). u is f32 (H, D) or (B, H, D)
// (a batch stride of 0 shares it over the batch). The state is f32
// (B, H, D, D) with contiguous (D, D) panels. o is written through its
// strides, in the input type. Any T, including 1 (a decode step) and a
// ragged T (the Pallas kernel needs T % chunk == 0); T = 0 leaves S as it
// was.
//
// Numerics: f32 or bf16 r/k/v/w, f32 u, state and sums. Build WITHOUT
// --use_fast_math.
//
// The entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// Element strides: (b, t, h) of r, k, v, w and o, then (b, h) of u and of
// the state.
struct Strides {
  long long r[3], k[3], v[3], w[3], o[3];
  long long u[2], s[2];
};

// Timesteps staged per tile: 4 arrays of TT x D floats, 32 KB at D >= 32.
template <int D> struct Tile { static constexpr int TT = D >= 64 ? 2048 / D : 64; };

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ state,
               T* __restrict__ o, int T_len, int H, Strides st) {
  constexpr int TT = Tile<D>::TT;
  __shared__ __align__(16) float rs[TT][D];
  __shared__ __align__(16) float ks[TT][D];
  __shared__ __align__(16) float ws[TT][D];
  __shared__ float vs[TT][D];
  __shared__ float us[D];
  __shared__ float as[TT];

  const int j = threadIdx.x;
  const long long b = blockIdx.x / H;
  const long long h = blockIdx.x % H;
  const T* rp = r + b * st.r[0] + h * st.r[2];
  const T* kp = k + b * st.k[0] + h * st.k[2];
  const T* vp = v + b * st.v[0] + h * st.v[2];
  const T* wp = w + b * st.w[0] + h * st.w[2];
  T* op = o + b * st.o[0] + h * st.o[2];
  float* sp = state + b * st.s[0] + h * st.s[1];

  us[j] = u[b * st.u[0] + h * st.u[1] + j];
  float S[D];                      // column j of the panel's state
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = sp[i * D + j];

  for (int t0 = 0; t0 < T_len; t0 += TT) {
    const int n = min(TT, T_len - t0);
    __syncthreads();               // the previous tile is consumed
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      rs[tt][j] = to_f32(rp[t * st.r[1] + j]);
      ks[tt][j] = to_f32(kp[t * st.k[1] + j]);
      vs[tt][j] = to_f32(vp[t * st.v[1] + j]);
      ws[tt][j] = to_f32(wp[t * st.w[1] + j]);
    }
    __syncthreads();
    // a_t = sum_i r_t[i] u[i] k_t[i] for the tile's steps; thread j starts
    // at column j so that a warp's shared-memory reads hit 32 banks
    for (int tt = j; tt < n; tt += D) {
      float a = 0.0f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) {
        const int i = (e + j) % D;
        a = fmaf(rs[tt][i] * us[i], ks[tt][i], a);
      }
      as[tt] = a;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i]);
        acc0 = fmaf(r4.x, S[i], acc0);
        acc1 = fmaf(r4.y, S[i + 1], acc1);
        acc2 = fmaf(r4.z, S[i + 2], acc2);
        acc3 = fmaf(r4.w, S[i + 3], acc3);
        S[i] = fmaf(w4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
      }
      const float out = fmaf(as[tt], vj, (acc0 + acc1) + (acc2 + acc3));
      op[(t0 + tt) * st.o[1] + j] = from_f32<T>(out);
    }
  }
  // the block read its whole panel above, before any write
#pragma unroll
  for (int i = 0; i < D; ++i) sp[i * D + j] = S[i];
}

template <typename T, int D>
void launch(const void* r, const void* k, const void* v, const void* w,
            const float* u, float* state, void* o, int B, int T_len, int H,
            const Strides& st, cudaStream_t stream) {
  wkv_fwd_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state,
      static_cast<T*>(o), T_len, H, st);
}

template <typename T>
int launch_d(int D, const void* r, const void* k, const void* v,
             const void* w, const float* u, float* state, void* o, int B,
             int T_len, int H, const Strides& st, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(r, k, v, w, u, state, o, B, T_len, H, st, stream); break;
    case 32: launch<T, 32>(r, k, v, w, u, state, o, B, T_len, H, st, stream); break;
    case 64: launch<T, 64>(r, k, v, w, u, state, o, B, T_len, H, st, stream); break;
    case 128: launch<T, 128>(r, k, v, w, u, state, o, B, T_len, H, st, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  for (int a = 0, p = 0; a < 7; ++a)
    for (int i = 0; i < n[a]; ++i) dst[a][i] = strides[p++];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, r, k, v, w, u, state, o, B, T_len, H, st, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, r, k, v, w, u, state, o, B, T_len, H, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
