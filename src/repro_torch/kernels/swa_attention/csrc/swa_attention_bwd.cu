// Backward of flash attention (causal, sliding-window or non-causal; GQA)
// for Hopper (sm_90a), f32, in two kernels, on the tensor cores, with no
// atomics.
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
// What bounds it on this card: the backward does 10 D operations for every
// attended (query, key) pair (S, dP, dV, dQ, dK; these kernels recompute S
// and dP in both, 14 D), against q, k, v, o, dO read and dq, dk, dv written
// once. At the training shape (48 x 64 tokens, 9/3 heads, D 64, causal)
// that is bytes at 3.35 TB/s (0.011 ms); at the serving length (8 x 1024)
// operations, on the tensor cores at the TF32 rate, three products each
// (0.147 ms; see below).
//
// What the design does about it (the forward's two patterns, swa_attention.cu):
// * Every product runs on the tensor cores, mma.sync m16n8k8 in TF32 with
//   the 3xTF32 split (x = hi + lo, both rna.tf32; a.b ~ lo_a.hi_b +
//   hi_a.lo_b + hi_a.hi_b accumulated in f32). Each is one of two
//   patterns. "a b^T" (as the forward's q.k): the A fragment from rows of
//   one shared tile, B from rows of another. "p b" (as the forward's p.v):
//   A is a score fragment still in registers, the columns of each 8-wide
//   step taken in the order 0, 2, 4, 6, 1, 3, 5, 7 so that the C layout
//   is the A layout, and B reads the rows of a shared tile in that order.
// * The tensor cores' f32 accumulation truncates, so many small terms
//   summed straight into one large accumulator (dK and dV sum every query
//   of the group's heads) drift with S. "p b" sums each tile's product in
//   zeroed fragments and adds it to the running sum once, rounded, which
//   keeps the kernels' error against a float64 gradient at the plain f32
//   backward's order up to S 2048 (scripts/attention_bwd_error.py).
// * swa_attention_bwd_dq_kernel: a block of 4 warps owns 64 query rows of
//   one (batch, query head), a warp 16 of them. It computes D_i for its
//   rows (and writes them to `delta` for the second kernel), then walks the
//   32-key tiles of the band: S = Q K^T and dP = dO V^T ("a b^T", Q and dO
//   staged once in shared memory), P and dS in registers, dQ += dS K ("p
//   b", K in V's place), dQ kept in registers as mma fragments.
// * swa_attention_bwd_dkdv_kernel: a block of 4 warps owns 64 keys of one
//   (batch, kv head), a warp 16 of them, and walks query heads of the
//   group and, for each, the 32-query tiles of the band, in that fixed
//   order: S^T = K Q^T and dP^T = V dO^T ("a b^T", with lse and delta
//   taken per column), then dV += P^T dO and dK += dS^T Q ("p b", queries
//   in the permuted order). P^T and dS^T never leave registers. The group
//   is shared by a thread-block cluster of C blocks (C the largest divisor
//   of the group size up to 8: 3 for 9/3 heads), the block of rank r
//   walking heads r, r + C, ...; at the end each block writes its partial
//   dK and dV to its shared memory, and the cluster sums them in rank
//   order through distributed shared memory, each block for every C-th
//   group of 8 columns. So the walk is C times shorter, and the card gets
//   C times the blocks.
// * The tiles a block walks (K and V in dQ; Q, dO and their lse and delta
//   rows in dK/dV) come through a double-buffered ring in shared memory
//   filled by cp.async (16-byte copies, 4-byte ones for the row values),
//   so the next tile loads while this one is multiplied. Rows are padded
//   by 16 bytes, which keeps every fragment load free of bank conflicts.
//   Only tiles that meet the band are loaded (dQ from q0 - window + 1; dK/dV
//   below k0 + 63 + window); a warp skips a tile none of its rows meets,
//   and masks only a tile that crosses the band's edge or the end of S.
// * Causal dQ blocks are launched longest first (the query-tile index is
//   the slow grid axis, reversed); in dK/dV the first key tiles are the
//   longest and come first already.
// Grids at 9/3 heads: dQ B Hq x S/64 blocks, dK/dV B Hkv C x S/64 blocks
// in clusters of C = 3: 432 each at the training shape, 1,152 each at the
// serving length, on 132 SMs. Shared memory a block: 20,992 / 37,376 /
// 70,144 / 135,680 bytes at D 16 / 32 / 64 / 128, so three blocks an SM
// at D 64. ptxas (-Xptxas -v, sm_90a), registers at D 16 / 32 / 64 / 128:
// dQ 124 / 140 / 162 / 223, dK/dV 128 / 161 / 168 / 255 (at D <= 64
// capped at 168 for three blocks an SM); no spills at any D. At the
// training shape the time grows with the batch from B 48 on (PERF.md §6),
// so it is bound by instruction throughput, not by too few blocks. Each
// 3xTF32 product spends ten operations splitting its B operands, so
// splitting the walked tiles once in shared memory, wgmma (which takes
// TF32 operands K-major only, so "p b" would need its B tiles transposed
// in shared memory), TMA and a bf16 backward are later work.
//
// Each output element is summed in a fixed order (key tiles in order for
// dQ; for dK/dV, each rank's heads, then query tiles, in order, then the
// ranks in order; within a tile, the mma's own order), so a result does
// not depend on the batch size or on the launch, and no two blocks write
// one element: a run reproduces itself bit for bit. The second kernel
// reads the first one's `delta`, so they run in that order on one stream.
//
// Layout: q, k, v, o, dO are read in the JAX layout (B, S, H, D) through
// their strides (the last dimension contiguous; 16-byte aligned rows, which
// the wrapper ensures); lse and delta are f32 (B, Hq, S); dq, dk, dv are
// written contiguous (B, S, H, D). Any S is taken: rows and keys past S are
// zero-filled and masked. f32 only (the learner trains in f32). Build
// WITHOUT --use_fast_math.
//
// The entry points launch on the stream they are given, allocate nothing
// and return cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBR = 16 * kWarps;          // a block's own rows (dQ) or keys (dK/dV)
constexpr int kBT = 32;                   // rows of a walked tile: keys (dQ), queries (dK/dV)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kLds = D + 4;                // padded shared row
  static constexpr int kCpr = D / 4;                // 16-byte copies a row
  static constexpr int kOwn = kBR * kLds;           // a block's own tile
  static constexpr int kTile = kBT * kLds;          // one walked tile
  // two own tiles, a ring of two stages of two walked tiles, and the row
  // values (dQ: delta of the own rows; dK/dV: two stages of lse and delta)
  static constexpr int kSmem = (2 * kOwn + 4 * kTile + 4 * kBT) * 4;
  // at D <= 64, registers for three blocks an SM (at D 128 that would spill)
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

struct Shape {
  int S, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;                        // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
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
// half away from zero) in two integer operations
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

// "a b^T": c[j] += A . B^T for a warp's 16 rows `a` (D wide, in shared
// memory) against rows 8j .. 8j + 7 of `b` (N rows); c[j] in the mma C
// layout (row gr, columns 2t, 2t + 1; row gr + 8, the same).
template <int D, int N>
__device__ __forceinline__ void abt(const float* a, const float* b,
                                    float (&c)[N / 8][4], int gr, int t) {
  constexpr int L = Cfg<D>::kLds;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* ar = a + gr * L + 8 * kk + t;
    const float af[4] = {ar[0], ar[8 * L], ar[4], ar[8 * L + 4]};
    const ASplit as(af);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float* br = b + (8 * j + gr) * L + 8 * kk + t;
      const float bf[2] = {br[0], br[4]};
      mma_3xtf32(c[j], as, bf);
    }
  }
}

// "p b": c[n] += P . B, P (16 x N) in the C layout of an "a b^T" product,
// B the N rows of `b` (D wide, in shared memory). A's column t is P's
// column 2t and column t + 4 is 2t + 1, which is what C holds, and B reads
// its rows in the same order. The tile's product is summed in zeroed
// fragments, kNB at a time, and added to c once, rounded (the tensor
// cores' f32 sums truncate: see the note above).
template <int D, int N>
__device__ __forceinline__ void pb(const float (&p)[N / 8][4], const float* b,
                                   float (&c)[D / 8][4], int gr, int t) {
  constexpr int L = Cfg<D>::kLds;
  constexpr int kNB = D / 8 < 4 ? D / 8 : 4;
#pragma unroll
  for (int nb = 0; nb < D / 8; nb += kNB) {
    float part[kNB][4];
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      const ASplit as(pa);
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        const float* br = b + (8 * kk + 2 * t) * L + 8 * (nb + i) + gr;
        const float bf[2] = {br[0], br[L]};
        mma_3xtf32(part[i], as, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nb + i][e] += part[i][e];
  }
}

// ROWS rows r0 .. of one head of x (B, S, H, D) into a padded shared tile,
// zero-filled past S
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* x, int r0,
                                          long long ss, int S) {
  for (int c = threadIdx.x; c < ROWS * Cfg<D>::kCpr; c += kThreads) {
    const int r = c / Cfg<D>::kCpr, off = (c % Cfg<D>::kCpr) * 4;
    const bool ok = r0 + r < S;
    const long long row = ok ? r0 + r : 0;
    cp_async16(dst + r * Cfg<D>::kLds + off, x + row * ss + off, ok);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <int D>
__global__ void __launch_bounds__(kThreads, (Cfg<D>::kMinBlocks))
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
  constexpr int L = F::kLds;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kBR][L]
  float* dos = qs + F::kOwn;                 // [kBR][L]
  float* ring = dos + F::kOwn;               // [2][K, V][kBT][L]
  float* delta_s = ring + 4 * F::kTile;      // [kBR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % sh.Hq, b = blockIdx.x / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;     // longest first
  const int S = sh.S;
  const long long row0 = (static_cast<long long>(b) * sh.Hq + h) * S;

  load_rows<D, kBR>(qs, q + b * qsb + h * qsh, q0, qss, S);
  load_rows<D, kBR>(dos, dout + b * dsb + h * dsh, q0, dss_, S);
  cp_async_commit();

  // the keys any row of this block can see, in whole tiles
  int lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  lo = lo / kBT * kBT;
  const int hi = sh.causal ? min(q0 + kBR, S) : S;
  const int n_tiles = (hi - lo + kBT - 1) / kBT;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  auto load_kv = [&](int it) {
    float* st = ring + (it & 1) * 2 * F::kTile;
    load_rows<D, kBT>(st, kb, lo + it * kBT, kss, S);
    load_rows<D, kBT>(st + F::kTile, vb, lo + it * kBT, vss, S);
  };
  load_kv(0);
  cp_async_commit();

  // delta_i = dO_i . O_i for this warp's 16 rows: D / 4 lanes a row, a
  // float4 each, then a fixed butterfly over those lanes; O is read while
  // the tiles land
  constexpr int kC4 = D / 4, kRows = 32 / kC4, kSteps = 16 / kRows;
  const int c4 = lane % kC4, rsub = lane / kC4;
  const float* ob = o + b * osb + h * osh;
  float4 ov[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int r = q0 + 16 * warp + rsub + kRows * i;
    ov[i] = r < S ? *reinterpret_cast<const float4*>(ob + r * oss + 4 * c4)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  cp_async_wait1();                  // Q and dO have landed (this thread's)
  __syncthreads();                   // ... everyone's
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int r = 16 * warp + rsub + kRows * i;
    const float4 d4 = *reinterpret_cast<const float4*>(dos + r * L + 4 * c4);
    float part = d4.x * ov[i].x;
    part = fmaf(d4.y, ov[i].y, part);
    part = fmaf(d4.z, ov[i].z, part);
    part = fmaf(d4.w, ov[i].w, part);
#pragma unroll
    for (int m = 1; m < kC4; m <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (c4 == 0) {
      delta_s[r] = part;
      if (q0 + r < S) delta[row0 + q0 + r] = part;
    }
  }
  __syncwarp();
  // this lane's rows gr and gr + 8 of the warp's 16
  const int qw = q0 + 16 * warp;
  const int row[2] = {qw + gr, qw + gr + 8};
  float dl[2], lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    dl[rr] = delta_s[16 * warp + gr + 8 * rr];
    lse2[rr] = row[rr] < S ? lse[row0 + row[rr]] * kLog2e : 0.0f;
  }

  const float sl2 = sh.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait1();                // tile it has landed (this thread's)
    __syncthreads();                 // ... everyone's
    const float* kt = ring + (it & 1) * 2 * F::kTile;
    const float* vt = kt + F::kTile;
    const int k0 = lo + it * kBT;
    // does any of this warp's rows see a key of the tile; must it mask
    const bool any = qw < S && !(sh.causal && k0 > qw + 15) &&
                     !(sh.window > 0 && k0 + kBT - 1 <= qw - sh.window);
    const bool edge = k0 + kBT > S || (sh.causal && k0 + kBT - 1 > qw) ||
                      (sh.window > 0 && k0 <= qw + 15 - sh.window);
    if (any) {
      float s[kBT / 8][4], dp[kBT / 8][4];
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      abt<D, kBT>(qs + 16 * warp * L, kt, s, gr, t);     // S = Q K^T
      abt<D, kBT>(dos + 16 * warp * L, vt, dp, gr, t);   // dP = dO V^T
      // dS = P (dP - delta), P = exp(S scale - lse), in s's place
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], sl2, -lse2[e >> 1]));
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int r = row[e >> 1];
            if (key >= S || (sh.causal && key > r) ||
                (sh.window > 0 && key <= r - sh.window))
              p = 0.0f;
          }
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      pb<D, kBT>(s, kt, acc, gr, t);                      // dQ += dS K
    }
    __syncthreads();                 // this stage is free for tile it + 2
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] < S) {
      float* out =
          dq + ((static_cast<long long>(b) * S + row[rr]) * sh.Hq + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + 8 * n + 2 * t, acc[n][2 * rr] * sh.scale,
               acc[n][2 * rr + 1] * sh.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, (Cfg<D>::kMinBlocks))
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
  constexpr int L = F::kLds;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kBR][L]
  float* vs = ks + F::kOwn;                  // [kBR][L]
  float* ring = vs + F::kOwn;                // [2][Q, dO][kBT][L]
  float* rows_s = ring + 4 * F::kTile;       // [2][lse, delta][kBT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  // a cluster of C blocks shares one (batch, kv head, key tile); the block
  // of rank r walks the group's heads r, r + C, ...
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / C;
  const int hk = bh % sh.Hkv, b = bh / sh.Hkv;
  const int g = sh.Hq / sh.Hkv;
  const int k0 = blockIdx.y * kBR;           // longest first when causal
  const int S = sh.S;

  load_rows<D, kBR>(ks, k + b * ksb + hk * ksh, k0, kss, S);
  load_rows<D, kBR>(vs, v + b * vsb + hk * vsh, k0, vss, S);
  cp_async_commit();

  // the queries that can see any key of this block, in whole tiles; the
  // walk is the group's heads, each over these tiles
  const int lo = sh.causal ? k0 : 0;         // a multiple of kBT
  const int hi = sh.window > 0 ? min(S, k0 + kBR - 1 + sh.window) : S;
  const int nq = (hi - lo + kBT - 1) / kBT;
  const int n_tiles = g / C * nq;
  // head hk g + rank + C j is the block's j-th: its q, dO and row values
  const int h0 = hk * g + rank;
  const float* qh = q + b * qsb + h0 * qsh;
  const float* dh = dout + b * dsb + h0 * dsh;
  const float* rh = (tid < kBT ? lse : delta) +
                    (static_cast<long long>(b) * sh.Hq + h0) * S;
  auto load_q = [&](int it) {
    const int j = it / nq, q0 = lo + (it % nq) * kBT;
    float* st = ring + (it & 1) * 2 * F::kTile;
    load_rows<D, kBT>(st, qh + j * C * qsh, q0, qss, S);
    load_rows<D, kBT>(st + F::kTile, dh + j * C * dsh, q0, dss_, S);
    if (tid < 2 * kBT) {
      const int i = tid % kBT;
      const bool ok = q0 + i < S;
      cp_async4(rows_s + (it & 1) * 2 * kBT + tid,
                rh + static_cast<long long>(j) * C * S + (ok ? q0 + i : 0),
                ok);
    }
  };
  load_q(0);
  cp_async_commit();

  // this lane's keys gr and gr + 8 of the warp's 16
  const int kw = k0 + 16 * warp;
  const int key[2] = {kw + gr, kw + gr + 8};
  const float sl2 = sh.scale * kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait1();                // K, V and tile it have landed
    __syncthreads();
    const float* qt = ring + (it & 1) * 2 * F::kTile;
    const float* dot = qt + F::kTile;
    const float* lse_s = rows_s + (it & 1) * 2 * kBT;
    const float* delta_s = lse_s + kBT;
    const int q0 = lo + (it % nq) * kBT;
    // does any of this warp's keys meet a query of the tile; must it mask
    const bool any = kw < S && !(sh.causal && q0 + kBT - 1 < kw) &&
                     !(sh.window > 0 && q0 >= kw + 15 + sh.window);
    const bool edge = kw + 16 > S || q0 + kBT > S ||
                      (sh.causal && q0 < kw + 15) ||
                      (sh.window > 0 && q0 + kBT - 1 >= kw + sh.window);
    if (any) {
      float s[kBT / 8][4], dp[kBT / 8][4];
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      abt<D, kBT>(ks + 16 * warp * L, qt, s, gr, t);     // S^T = K Q^T
      abt<D, kBT>(vs + 16 * warp * L, dot, dp, gr, t);   // dP^T = V dO^T
      // P^T in s's place, dS^T in dp's; lse and delta by column (query)
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          float p = exp2f(fmaf(s[j][e], sl2, -(lse_s[c] * kLog2e)));
          if (edge) {
            const int qi = q0 + c, kj = key[e >> 1];
            if (qi >= S || kj >= S || (sh.causal && kj > qi) ||
                (sh.window > 0 && kj <= qi - sh.window))
              p = 0.0f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[c]);
        }
      }
      pb<D, kBT>(s, dot, dva, gr, t);                     // dV += P^T dO
      pb<D, kBT>(dp, qt, dka, gr, t);                     // dK += dS^T Q
    }
    __syncthreads();                 // this stage is free for tile it + 2
  }

  // dK and dV: the cluster's partials summed in rank order, each block
  // taking every C-th group of 8 columns, read from the others' shared
  // memory (the ring, free now) in the mma fragment layout
  float* part = ring;                        // [dK, dV][kWarps][D / 8][4][32]
  constexpr int kPart = kWarps * (D / 8) * 4 * 32;
  if (C > 1) {
    __syncthreads();                         // the ring's last tile is read
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ((warp * (D / 8) + n) * 4 + e) * 32 + lane;
        part[i] = dka[n][e];
        part[kPart + i] = dva[n][e];
      }
    cluster.sync();                          // every partial is written
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n % C != rank) continue;
    float sk[4], sv[4];                      // rank 0's, then + rank 1's ...
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sk[e] = dka[n][e];
      sv[e] = dva[n][e];
      if (C == 1) continue;
      const int i = ((warp * (D / 8) + n) * 4 + e) * 32 + lane;
      for (int r = 0; r < C; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        sk[e] = r == 0 ? pr[i] : sk[e] + pr[i];
        sv[e] = r == 0 ? pr[kPart + i] : sv[e] + pr[kPart + i];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (key[rr] < S) {
        const long long off =
            ((static_cast<long long>(b) * S + key[rr]) * sh.Hkv + hk) * D +
            8 * n + 2 * t;
        store2(dk + off, sk[2 * rr] * sh.scale, sk[2 * rr + 1] * sh.scale);
        store2(dv + off, sv[2 * rr], sv[2 * rr + 1]);
      }
    }
  }
  if (C > 1) cluster.sync();                 // keep the partials until read
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
  const dim3 grid(B * sh.Hq, (sh.S + kBR - 1) / kBR);
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
  // a cluster of the largest divisor of the group size up to 8 (the
  // portable cluster size) for each (batch, kv head, key tile)
  const int g = sh.Hq / sh.Hkv;
  int c = 8;
  while (g % c) --c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * sh.Hkv * c, (sh.S + kBR - 1) / kBR);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, swa_attention_bwd_dkdv_kernel<D>,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sh, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B > 0 && S > 0 && Hkv > 0 && Hq % Hkv == 0;
}

}  // namespace

// strides: element strides (b, s, h) of q, k, v, o, then dO for the dQ
// kernel (15), of q, k, v, then dO for the dK/dV kernel (12); each row
// 16-byte aligned. lse and delta: f32 (B, Hq, S), contiguous. dq: (B, S,
// Hq, D), dk and dv: (B, S, Hkv, D), contiguous. f32 only.
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
