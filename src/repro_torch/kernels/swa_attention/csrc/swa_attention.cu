// Forward flash attention (causal, sliding-window or non-causal; GQA) for
// Hopper (sm_90a), on the tensor cores.
//
// K3 swa_attention_fwd replaces the TPU kernel
//   src/repro/kernels/swa_attention/kernel.py::flash_attention_pallas
//   (_attn_kernel).
//
// What bounds it on this card: the q.k and p.v products, 4 * D operations
// for every attended (query, key) pair, against q, k, v and o read and
// written once. At the serving shape (8 x 1024 tokens, 9/3 heads, D = 64,
// causal) that is about 9.7 GFLOP against 50 MB, so it is bound by
// operations: on the tensor cores, at the TF32 rate (495 TFLOP/s, three
// products each, see below) for f32 inputs and the bf16 rate (989) for
// bf16 inputs.
//
// What the design does about it (the FA2 layout, with mma.sync):
// * One block of 4 warps owns 64 query rows of one (batch, query head);
//   each warp owns 16 of them and keeps their running max m, sum l and
//   output accumulator in registers, as mma fragments (online softmax), so
//   the (S, S) score matrix never exists.
// * Both products run on the tensor cores through inline PTX mma.sync. For
//   f32 inputs, m16n8k8 in TF32 with the 3xTF32 split: x = hi + lo with
//   hi = rna.tf32(x), lo = rna.tf32(x - hi), and a.b ~ hi_a.hi_b +
//   hi_a.lo_b + lo_a.hi_b accumulated in f32, which keeps the products
//   close to f32 (one TF32 pass keeps about 3 decimal digits, outside the
//   reference's f32 tolerance). For bf16 inputs, m16n8k16 in bf16 with f32
//   accumulation; p is rounded to bf16 for p.v.
// * The score fragment feeds p.v without a trip through shared memory. For
//   bf16 the m16n8k16 C layout is the A layout (the FA2 trick). For TF32 it
//   is not (C holds columns 2t, 2t+1 of a row, A columns t and t+4), so the
//   keys of each 8-key step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7:
//   A's column t is key 2t and column t + 4 is key 2t + 1, which is exactly
//   what C holds, and the V fragment reads its rows in the same order.
// * K/V tiles (32 keys; 64 for bf16 at D <= 64) come through a double-buffered ring in
//   shared memory filled by 16-byte cp.async copies, so the next tile loads
//   while this one is multiplied. Rows are padded by 16 bytes, which keeps
//   every fragment load free of bank conflicts. Only the tiles that meet the
//   block's causal or window band are loaded, as the TPU kernel's
//   pl.when(diag_ok) skips the others; masks are applied only on tiles that
//   cross the band's edge or the end of S.
// * Causal blocks are launched longest first (the query-tile index is the
//   slow grid axis, reversed), so the short ones fill the tail.
// wgmma and TMA are later work: wgmma takes TF32 operands K-major only, so
// p.v would need V transposed in shared memory.
//
// Layout: q, k, v are read in the JAX layout (B, S, H, D) through their
// strides (the last dimension contiguous; 16-byte aligned rows, which the
// wrapper ensures); no transposed copy is made. o is written contiguous
// (B, S, Hq, D). Any S is taken: keys and query rows past S are masked
// here, where the Pallas kernel asserts S % block == 0.
//
// Numerics: f32 or bf16 inputs, f32 accumulation and softmax (exp2 of
// log2-scaled scores), output in the input type. A row with no valid key in
// a tile adds nothing and makes no NaN: the running max is taken as 0 while
// it is still -inf, as the reference's models/common.py flash_attention
// guards it; a row with no valid key at all gives 0. Build WITHOUT
// --use_fast_math.
//
// Training also asks for each row's natural log-sum-exp of its scaled
// scores, lse = (m + log2 l) ln 2 from the running max m and sum l in log2
// units (-inf for a row with no key), written to an f32 (B, Hq, S) buffer
// when the lse pointer is not null; o is computed the same way either way.
// The backward kernels (swa_attention_bwd.cu) recompute the probabilities
// from it.
//
// The entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;          // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct Cfg {
  // keys per tile: 32 for f32 (fewer live registers, three blocks an SM)
  static constexpr int kBK = sizeof(T) == 2 && D <= 64 ? 64 : 32;
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));
  static constexpr int kCpr = D / kEpc;             // 16-byte copies a row
  static constexpr int kLds = D + kEpc;             // padded shared row
  static constexpr int kTile = kBK * kLds;          // elements of one tile
  static constexpr int kSmem = 4 * kTile * static_cast<int>(sizeof(T));
  // at D <= 64, registers for three blocks an SM (at D 128 that would spill)
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;                        // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for finite x (round the magnitude to 10 mantissa bits,
// half away from zero) in two integer operations; the instruction itself
// also screens NaN and infinity, which scores and probabilities never are
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the A fragment a = ah + al, split once for all the B fragments it meets
struct ASplit {
  uint32_t h[4], l[4];
  __device__ __forceinline__ explicit ASplit(const float* a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], h[i], l[i]);
  }
};
// c += a.b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const ASplit& a,
                                           const float* b) {
  uint32_t bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(c, a.l, bh);
  mma_tf32(c, a.h, bl);
  mma_tf32(c, a.h, bh);
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// The A fragment of Q for one warp: f32 inputs keep the values (split per
// use), bf16 inputs the packed pairs. gr = lane / 4, t = lane % 4.
template <typename T, int D>
struct QFrag;
template <int D>
struct QFrag<float, D> {
  float a[D / 8][4];
  __device__ void load(const float* r0p, const float* r1p, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      a[kk][0] = r0p ? r0p[8 * kk + t] : 0.0f;
      a[kk][1] = r1p ? r1p[8 * kk + t] : 0.0f;
      a[kk][2] = r0p ? r0p[8 * kk + t + 4] : 0.0f;
      a[kk][3] = r1p ? r1p[8 * kk + t + 4] : 0.0f;
    }
  }
};
template <int D>
struct QFrag<__nv_bfloat16, D> {
  uint32_t a[D / 16][4];
  __device__ void load(const __nv_bfloat16* r0p, const __nv_bfloat16* r1p, int t) {
    auto w = [](const __nv_bfloat16* p, int c) -> uint32_t {
      return p ? *reinterpret_cast<const uint32_t*>(p + c) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a[kk][0] = w(r0p, 16 * kk + 2 * t);
      a[kk][1] = w(r1p, 16 * kk + 2 * t);
      a[kk][2] = w(r0p, 16 * kk + 8 + 2 * t);
      a[kk][3] = w(r1p, 16 * kk + 8 + 2 * t);
    }
  }
};

// s[j] (keys 8j..8j+7 of the tile) = Q . K^T for this warp's 16 rows
template <int D, int BK, int LDS>
__device__ __forceinline__ void qk(const QFrag<float, D>& qf, const float* kt,
                                   float (&s)[BK / 8][4], int gr, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const ASplit a(qf.a[kk]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* kr = kt + (8 * j + gr) * LDS + 8 * kk + t;
      const float b[2] = {kr[0], kr[4]};
      mma_3xtf32(s[j], a, b);
    }
  }
}
template <int D, int BK, int LDS>
__device__ __forceinline__ void qk(const QFrag<__nv_bfloat16, D>& qf,
                                   const __nv_bfloat16* kt,
                                   float (&s)[BK / 8][4], int gr, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const __nv_bfloat16* kr = kt + (8 * j + gr) * LDS + 16 * kk + 2 * t;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                             *reinterpret_cast<const uint32_t*>(kr + 8)};
      mma_bf16(s[j], qf.a[kk], b);
    }
  }
}

// o += P . V, P in the score fragments' layout
template <int D, int BK, int LDS>
__device__ __forceinline__ void pv(const float (&p)[BK / 8][4], const float* vt,
                                   float (&o)[D / 8][4], int gr, int t, int) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // A column t is key 2t, column t + 4 key 2t + 1 (see the note above)
    const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    const ASplit a(pa);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* vr = vt + (8 * kk + 2 * t) * LDS + 8 * n + gr;
      const float b[2] = {vr[0], vr[LDS]};
      mma_3xtf32(o[n], a, b);
    }
  }
}
template <int D, int BK, int LDS>
__device__ __forceinline__ void pv(const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* vt,
                                   float (&o)[D / 8][4], int, int, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, vt + (16 * kk + (lane & 15)) * LDS + 8 * n);
      mma_bf16(o[n], a, b);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Cfg<T, D>::kMinBlocks))
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int Hq,
                     int Hkv, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, int causal,
                     int window, float scale) {
  using F = Cfg<T, D>;
  constexpr int BK = F::kBK, LDS = F::kLds;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);          // [2][BK][LDS]
  T* vs = ks + 2 * F::kTile;                   // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // longest first
  const int row[2] = {q0 + 16 * warp + gr, q0 + 16 * warp + gr + 8};

  // the keys any row of this block can see, in whole tiles
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = lo / BK * BK;
  const int hi = causal ? q_last + 1 : S;
  const int n_tiles = (hi - lo + BK - 1) / BK;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  auto load = [&](int it) {
    const int k0 = lo + it * BK;
    T* kd = ks + (it & 1) * F::kTile;
    T* vd = vs + (it & 1) * F::kTile;
    for (int c = tid; c < BK * F::kCpr; c += kThreads) {
      const int r = c / F::kCpr, off = (c % F::kCpr) * F::kEpc;
      const bool ok = k0 + r < S;                 // else zero-filled
      const long long key = ok ? k0 + r : 0;
      cp_async16(kd + r * LDS + off, kb + key * kss + off, ok);
      cp_async16(vd + r * LDS + off, vb + key * vss + off, ok);
    }
  };
  load(0);
  cp_async_commit();

  QFrag<T, D> qf;
  const T* qb = q + b * qsb + h * qsh;
  qf.load(row[0] < S ? qb + row[0] * qss : nullptr,
          row[1] < S ? qb + row[1] * qss : nullptr, t);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load(it + 1);
    cp_async_commit();
    cp_async_wait1();                  // tile it has landed (this thread's)
    __syncthreads();                   // ... everyone's
    const T* kt = ks + (it & 1) * F::kTile;
    const T* vt = vs + (it & 1) * F::kTile;
    const int k0 = lo + it * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    qk<D, BK, LDS>(qf, kt, s, gr, t);

    // scale to log2 units; mask only where the tile crosses an edge
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int r = row[e >> 1];
          if (key >= S || (causal && key > r) || (window > 0 && key <= r - window))
            x = -INFINITY;
        }
        s[j][e] = x;
      }
    }
    // online softmax; row e>>1 of this lane, its 4 lanes meet by shuffles
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m[rr] - m_use);   // 0 while m is -inf
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use);       // a masked key gives 0
          sum += s[j][e];
        }
      }
      l[rr] = l[rr] * corr + sum;                 // this lane's columns only
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * rr] *= corr;
        acc[n][2 * rr + 1] *= corr;
      }
      m[rr] = m_new;
    }
    pv<D, BK, LDS>(s, vt, acc, gr, t, lane);
    __syncthreads();                   // this stage is free for tile it + 2
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float den = l[rr];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float lsum = den;
    den = fmaxf(den, 1e-30f);
    if (row[rr] < S) {
      T* orow = o + ((static_cast<long long>(b) * S + row[rr]) * Hq + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + 8 * n + 2 * t, acc[n][2 * rr] / den,
               acc[n][2 * rr + 1] / den);
      if (lse != nullptr && t == 0)      // -inf + log2(0) for a keyless row
        lse[(static_cast<long long>(b) * Hq + h) * S + row[rr]] =
            (m[rr] + log2f(lsum)) * kLn2;
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<T, D>::kSmem;
  static bool configured = false;
  if (!configured) {                   // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        swa_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  swa_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Hq, Hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int Hq, int Hkv, const long long* st,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, Hq, Hkv, st, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, Hq, Hkv, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, Hq, Hkv, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, Hq, Hkv, st, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 9 element strides (b, s, h) of q, then of k, then of v.
// dtype: 0 = float32, 1 = bfloat16. lse: null, or an f32 (B, Hq, S) buffer.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int Hq,
                                 int Hkv, int D, int dtype,
                                 const long long* strides,
                                 int causal, int window, float scale,
                                 void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, static_cast<float*>(lse), B, S, Hq, Hkv,
                           strides, causal, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, static_cast<float*>(lse), B, S, Hq,
                                   Hkv, strides, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
