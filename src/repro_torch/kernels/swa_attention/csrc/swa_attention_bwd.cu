// Backward of flash attention (causal, sliding-window or non-causal; GQA)
// for Hopper (sm_90a), f32, in two kernels and no atomics.
//
// The TPU kernel K3 (src/repro/kernels/swa_attention/kernel.py::
// flash_attention_pallas) has no backward: the reference differentiates its
// jnp flash_attention (src/repro/models/common.py) with jax.checkpoint
// recompute. These kernels are the gradient of the port's K3 forward
// (swa_attention.cu), from the forward's o and the log-sum-exp lse it saves:
//
//   D_i = sum_d dO_id O_id           P_ij = exp(S_ij scale - lse_i)
//   dV = P^T dO    dP = dO V^T       dS = P (dP - D)
//   dQ = dS K scale                  dK = dS^T Q scale
//
// with dK and dV summed over each kv head's group of query heads.
//
// * swa_attention_bwd_dq_kernel: one block per 32-row query tile of one
//   (batch, query head). It computes D_i for its rows (and writes them to
//   `delta` for the second kernel), then loops over the 32-key tiles of
//   the band, recomputing S and dP for the tile, and keeps its dQ rows in
//   registers.
// * swa_attention_bwd_dkdv_kernel: one block per 32-key tile of one
//   (batch, kv head). It loops over the group's query heads and, for each,
//   over the query tiles of the band, in that fixed order, recomputing S,
//   P, dP and dS, and keeps its dK and dV rows in registers.
// Each output element is summed by one thread in a fixed order, so a
// result does not depend on the batch size or on the launch, and no two
// blocks write one element: a run reproduces itself bit for bit. The
// second kernel reads the first one's `delta`, so they run in that order
// on one stream.
//
// What bounds it: the backward does 10 D operations for every attended
// (query, key) pair (S, dP, dV, dQ, dK; these kernels recompute S and dP in
// both, 14 D), against q, k, v, o, dO read and dq, dk, dv written once. At
// the training shape (48 x 64 tokens, 9/3 heads, D 64, causal) that is
// bytes at 3.35 TB/s; at the serving length (8 x 1024) operations. The
// design is plain SIMT f32 FMA from shared memory: every tile (32 rows of
// D, padded by one float, so no fragment read conflicts) is staged once per
// use, and each thread owns a 2 x 2 block of the 32 x 32 score tile and
// 1 x D/8 of an output tile. Each FMA of the products reads one operand
// from shared memory, so it is bound by shared-memory bandwidth at about a
// quarter of the f32 rate; tensor cores (3xTF32, as the forward),
// register-blocked micro-tiles and cp.async or TMA staging are later work.
//
// Layout: q, k, v, o, dO are read in the JAX layout (B, S, H, D) through
// their strides (the last dimension contiguous); lse and delta are f32
// (B, Hq, S); dq, dk, dv are written contiguous (B, S, H, D). Any S is
// taken: rows and keys past S are zero-filled and masked. f32 only (the
// learner trains in f32). Build WITHOUT --use_fast_math.
//
// The entry points launch on the stream they are given, allocate nothing
// and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;                    // query rows and keys per tile

template <int D>
struct Cfg {
  static constexpr int kLd = D + 1;       // padded row of a D-wide tile
  static constexpr int kTile = kT * kLd;
  static constexpr int kPLd = kT + 1;     // padded row of a score tile
  static constexpr int kPTile = kT * kPLd;
  // Q, dO, K, V tiles, P and dS tiles, lse and delta of the query rows
  static constexpr int kSmem = (4 * kTile + 2 * kPTile + 2 * kT) * 4;
};

struct Shape {
  int S, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qi, int kj, const Shape& sh) {
  return qi < sh.S && kj < sh.S && (!sh.causal || kj <= qi) &&
         (sh.window <= 0 || kj > qi - sh.window);
}

// rows r0 .. r0 + 31 of one head of x (B, S, H, D), zero past S
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int r0,
                                          long long ss, int S) {
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * Cfg<D>::kLd + d] =
        r0 + r < S ? x[static_cast<long long>(r0 + r) * ss + d] : 0.0f;
  }
}

// For query tile q0 and key tile k0 in shared memory: P and
// dS = P (dP - delta) of the 32 x 32 tile. Thread (ty, tx) owns rows ty,
// ty + 16 and keys tx, tx + 16.
template <int D, bool kWriteP>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s,
                                       const float* delta_s, float* ps,
                                       float* dss, int q0, int k0,
                                       const Shape& sh) {
  constexpr int L = Cfg<D>::kLd, PL = Cfg<D>::kPLd;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float qa[2] = {qs[ty * L + d], qs[(ty + 16) * L + d]};
    const float oa[2] = {dos[ty * L + d], dos[(ty + 16) * L + d]};
    const float kb[2] = {ks[tx * L + d], ks[(tx + 16) * L + d]};
    const float vb[2] = {vs[tx * L + d], vs[(tx + 16) * L + d]};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vb[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = ty + 16 * a, j = tx + 16 * c;
      const float p = visible(q0 + i, k0 + j, sh)
                          ? expf(s[a][c] * sh.scale - lse_s[i])
                          : 0.0f;
      if (kWriteP) ps[i * PL + j] = p;
      dss[i * PL + j] = p * (dp[a][c] - delta_s[i]);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ o,
                            const float* __restrict__ lse,
                            const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ delta,
                            Shape sh, long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            long long osb, long long oss, long long osh,
                            long long dsb, long long dss_, long long dsh) {
  using F = Cfg<D>;
  constexpr int L = F::kLd;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + F::kTile;
  float* ks = dos + F::kTile;
  float* vs = ks + F::kTile;
  float* dss = vs + F::kTile + F::kPTile;       // (the P tile is not used)
  float* lse_s = dss + F::kPTile;
  float* delta_s = lse_s + kT;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % sh.Hq, b = blockIdx.x / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int q0 = blockIdx.y * kT;
  const int S = sh.S;
  const long long row0 = (static_cast<long long>(b) * sh.Hq + h) * S;

  load_tile<D>(qs, q + b * qsb + h * qsh, q0, qss, S);
  load_tile<D>(dos, dout + b * dsb + h * dsh, q0, dss_, S);
  __syncthreads();
  // delta_i = dO_i . O_i: 8 lanes a row, D / 8 columns each, then a fixed
  // butterfly over the 8 lanes
  const int i = tid >> 3, c = tid & 7;
  {
    float part = 0.0f;
    if (q0 + i < S) {
      const float* orow = o + b * osb + h * osh +
                          static_cast<long long>(q0 + i) * oss;
#pragma unroll
      for (int m = 0; m < D / 8; ++m)
        part = fmaf(dos[i * L + c + 8 * m], orow[c + 8 * m], part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if (c == 0) {
      delta_s[i] = part;
      lse_s[i] = q0 + i < S ? lse[row0 + q0 + i] : 0.0f;
      if (q0 + i < S) delta[row0 + q0 + i] = part;
    }
  }

  // the keys any row of this tile can see, in whole tiles
  int lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  lo = lo / kT * kT;
  const int hi = sh.causal ? min(q0 + kT, S) : S;
  float acc[D / 8];
#pragma unroll
  for (int m = 0; m < D / 8; ++m) acc[m] = 0.0f;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  for (int k0 = lo; k0 < hi; k0 += kT) {
    __syncthreads();                 // the last tile's K and dS are read
    load_tile<D>(ks, kb, k0, kss, S);
    load_tile<D>(vs, vb, k0, vss, S);
    __syncthreads();
    scores<D, false>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0,
                     sh);
    __syncthreads();
    // dQ_i += dS_i . K, row i, columns c + 8m
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float ds = dss[i * F::kPLd + j];
#pragma unroll
      for (int m = 0; m < D / 8; ++m)
        acc[m] = fmaf(ds, ks[j * L + c + 8 * m], acc[m]);
    }
  }
  if (q0 + i < S) {
    float* out = dq + ((static_cast<long long>(b) * S + q0 + i) * sh.Hq + h) * D;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) out[c + 8 * m] = acc[m] * sh.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ lse,
                              const float* __restrict__ dout,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape sh,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              long long dsb, long long dss_, long long dsh) {
  using F = Cfg<D>;
  constexpr int L = F::kLd, PL = F::kPLd;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + F::kTile;
  float* ks = dos + F::kTile;
  float* vs = ks + F::kTile;
  float* ps = vs + F::kTile;
  float* dss = ps + F::kPTile;
  float* lse_s = dss + F::kPTile;
  float* delta_s = lse_s + kT;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x % sh.Hkv, b = blockIdx.x / sh.Hkv;
  const int g = sh.Hq / sh.Hkv;
  const int k0 = blockIdx.y * kT;
  const int S = sh.S;

  load_tile<D>(ks, k + b * ksb + hk * ksh, k0, kss, S);
  load_tile<D>(vs, v + b * vsb + hk * vsh, k0, vss, S);

  // the queries that can see any key of this tile, in whole tiles
  int lo = sh.causal ? k0 : 0;
  lo = lo / kT * kT;
  const int hi = sh.window > 0 ? min(S, k0 + kT - 1 + sh.window) : S;
  const int j = tid >> 3, c = tid & 7;
  float dka[D / 8], dva[D / 8];
#pragma unroll
  for (int m = 0; m < D / 8; ++m) dka[m] = dva[m] = 0.0f;
  for (int hg = 0; hg < g; ++hg) {
    const int h = hk * g + hg;
    const long long row0 = (static_cast<long long>(b) * sh.Hq + h) * S;
    const float* qb = q + b * qsb + h * qsh;
    const float* db = dout + b * dsb + h * dsh;
    for (int q0 = lo; q0 < hi; q0 += kT) {
      __syncthreads();               // the last tile's Q, dO, P, dS are read
      load_tile<D>(qs, qb, q0, qss, S);
      load_tile<D>(dos, db, q0, dss_, S);
      if (tid < kT) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[row0 + q0 + tid] : 0.0f;
        delta_s[tid] = in ? delta[row0 + q0 + tid] : 0.0f;
      }
      __syncthreads();
      scores<D, true>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, sh);
      __syncthreads();
      // dV_j += P_:j^T dO, dK_j += dS_:j^T Q; key row j, columns c + 8m
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float p = ps[i * PL + j], ds = dss[i * PL + j];
#pragma unroll
        for (int m = 0; m < D / 8; ++m) {
          dva[m] = fmaf(p, dos[i * L + c + 8 * m], dva[m]);
          dka[m] = fmaf(ds, qs[i * L + c + 8 * m], dka[m]);
        }
      }
    }
  }
  if (k0 + j < S) {
    const long long off =
        ((static_cast<long long>(b) * S + k0 + j) * sh.Hkv + hk) * D;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      dk[off + c + 8 * m] = dka[m] * sh.scale;
      dv[off + c + 8 * m] = dva[m];
    }
  }
}

template <typename K>
int configure(K kernel, int smem, bool& configured) {
  if (!configured) {                 // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  return 0;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, void* delta, int B,
              const Shape& sh, const long long* st, cudaStream_t stream) {
  static bool configured = false;
  const int err = configure(swa_attention_bwd_dq_kernel<D>, Cfg<D>::kSmem,
                            configured);
  if (err) return err;
  const dim3 grid(B * sh.Hq, (sh.S + kT - 1) / kT);
  swa_attention_bwd_dq_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(delta), sh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse,
                const void* dout, const void* delta, void* dk, void* dv, int B,
                const Shape& sh, const long long* st, cudaStream_t stream) {
  static bool configured = false;
  const int err = configure(swa_attention_bwd_dkdv_kernel<D>, Cfg<D>::kSmem,
                            configured);
  if (err) return err;
  const dim3 grid(B * sh.Hkv, (sh.S + kT - 1) / kT);
  swa_attention_bwd_dkdv_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sh, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B > 0 && S > 0 && Hkv > 0 && Hq % Hkv == 0;
}

}  // namespace

// strides: element strides (b, s, h) of q, k, v, o, then dO for the dQ
// kernel (15), of q, k, v, then dO for the dK/dV kernel (12). lse and
// delta: f32 (B, Hq, S), contiguous. dq: (B, S, Hq, D), dk and dv:
// (B, S, Hkv, D), contiguous. f32 only.
extern "C" int swa_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* delta, int B, int S,
                                    int Hq, int Hkv, int D,
                                    const long long* strides, int causal,
                                    int window, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, Hq, Hkv, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, o, lse, dout, dq, delta, B, sh, strides, st);
    case 32: return launch_dq<32>(q, k, v, o, lse, dout, dq, delta, B, sh, strides, st);
    case 64: return launch_dq<64>(q, k, v, o, lse, dout, dq, delta, B, sh, strides, st);
    case 128: return launch_dq<128>(q, k, v, o, lse, dout, dq, delta, B, sh, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int swa_attention_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* lse,
                                      const void* dout, const void* delta,
                                      void* dk, void* dv, int B, int S, int Hq,
                                      int Hkv, int D, const long long* strides,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, Hq, Hkv, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkdv<16>(q, k, v, lse, dout, delta, dk, dv, B, sh, strides, st);
    case 32: return launch_dkdv<32>(q, k, v, lse, dout, delta, dk, dv, B, sh, strides, st);
    case 64: return launch_dkdv<64>(q, k, v, lse, dout, delta, dk, dv, B, sh, strides, st);
    case 128: return launch_dkdv<128>(q, k, v, lse, dout, delta, dk, dv, B, sh, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
