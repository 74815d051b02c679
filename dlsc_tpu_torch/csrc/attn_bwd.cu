// K2 (backward): masked multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlsc_tpu/ops/attn_fast.py `make_fast_mha` ->
// `bwd_kernel` (the custom VJP's backward). Given the forward's inputs q
// (pre-scaled), k, v, its output O and lse = logsumexp of the masked scores,
// and dO, for each (batch, head):
//   P  = exp(q k^T - lse)        (keys >= n_real masked: P = 0)
//   D  = rowsum(dO * O)           in f32, once per query row
//   dP = dO v^T,  dS = P * (dP - D)
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO
// Layout (B, H, N, 64) contiguous; lse (B, H, N) f32; dQ/dK/dV in the input
// type. dK and dV rows >= n_real are written as exact zeros.
//
// What bounds it here: at AST-Base (N 1664, dh 64) the five products are
// 10 N^2 dh = 1.8 GFLOP per head against about 1.5 MB of operands, so the
// kernels are bound by the tensor cores and the exponentials. The TPU kernel
// carries the dK/dV sums in VMEM across a sequential grid over query blocks;
// H100 blocks run in parallel and in no order, so the work is split into two
// deterministic kernels with no atomics:
//  - dQ: one block (4 warps) per (batch x head, 64 query rows). Its prologue
//    computes D for its rows (and stores it for the next kernel); then it
//    streams 64-key tiles, recomputes S and dP, and accumulates dQ += dS k;
//  - dK/dV: one block per (batch x head, 64 keys). Each warp keeps its 16
//    keys' k and v as mma.sync A fragments, streams all query tiles,
//    recomputes S^T and dP^T, and accumulates dV += P^T dO and dK += dS^T q
//    in registers; stored once.
// Products are bf16 mma.sync.m16n8k16 with f32 accumulators. P and dS are
// rounded to bf16 before their products, where the TPU kernel rounds them.
// Operand tiles needed as B fragments along the tile's row axis are kept
// transposed in shared memory, so every fragment is one 32-bit load.
// n_real is the static boundary: key tiles entirely at or past it are never
// loaded (their dK/dV blocks write zeros and exit) and only the straddling
// tile is masked. A float32 path (scalar FMA, one thread per row) serves the
// tight-tolerance parity checks. wgmma, TMA and warp specialisation are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int BT = 64;          // rows (queries or keys) per tile, bf16 path
constexpr int STR = DH + 8;     // row stride (bf16) of a row-major tile in shared memory
constexpr int TSTR = BT + 8;    // row stride (bf16) of a transposed tile
constexpr int BR32 = 64;        // rows per block, f32 path (one thread each)
constexpr int BKV32 = 32;       // keys per tile, f32 dQ kernel
constexpr int BQ32 = 16;        // queries per tile, f32 dK/dV kernel

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// Rows [r0, r0 + BT) of X (N x 64) into shared memory: row-major into `row`
// and/or transposed into `tr`, whichever is non-null. Rows >= N read as 0.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ X, int r0, int N,
                                          __nv_bfloat16* row, __nv_bfloat16* tr) {
  for (int c = threadIdx.x; c < BT * DH / 8; c += blockDim.x) {
    const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) x = *reinterpret_cast<const uint4*>(X + (size_t)(r0 + r) * DH + col);
    if (row) *reinterpret_cast<uint4*>(row + r * STR + col) = x;
    if (tr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(col + i) * TSTR + r] = e[i];
    }
  }
}

// The A fragments (16 rows x 64, four k-steps of 16) of rows ra, rb of X.
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ X, int ra, int rb,
                                       int N, int t, uint32_t a[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = ra < N ? ld32(X + (size_t)ra * DH + c) : 0u;
    a[ks][1] = rb < N ? ld32(X + (size_t)rb * DH + c) : 0u;
    a[ks][2] = ra < N ? ld32(X + (size_t)ra * DH + c + 8) : 0u;
    a[ks][3] = rb < N ? ld32(X + (size_t)rb * DH + c + 8) : 0u;
  }
}

// acc (16 x 64) = A (16 x 64, fragments) . B^T, B's 64 rows row-major in shared memory.
__device__ __forceinline__ void mma_rows(float acc[8][4], const uint32_t a[4][4],
                                         const __nv_bfloat16* B, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const __nv_bfloat16* br = B + (nt * 8 + g) * STR + ks * 16 + 2 * t;
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(acc[nt], a[ks], b);
    }
  }
}

// acc (16 x 64) += X (16 x 64, the f32 accumulators of an earlier product,
// rounded to bf16) . B, with B (64 x 64) stored transposed in shared memory.
__device__ __forceinline__ void mma_acc_t(float acc[8][4], const float x[8][4],
                                          const __nv_bfloat16* Bt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* br = Bt + (nt * 8 + g) * TSTR + kk * 16 + 2 * t;
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(acc[nt], a, b);
    }
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ X, int ra, int rb,
                                           int N, int t, const float acc[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (ra < N)
      *reinterpret_cast<uint32_t*>(X + (size_t)ra * DH + c) = pack_bf16(acc[nt][0], acc[nt][1]);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(X + (size_t)rb * DH + c) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int N,
                        int n_real) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BT * STR];
  __shared__ __align__(16) __nv_bfloat16 Vs[BT * STR];
  __shared__ __align__(16) __nv_bfloat16 Kt[DH * TSTR];

  const size_t base = (size_t)blockIdx.y * N * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BT + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[4][4], da[4][4];
  load_a(q + base, r0, r1, N, t, qa);
  load_a(dout + base, r0, r1, N, t, da);

  // D = rowsum(dO * O) in f32: each thread sums the 16 columns its dO
  // fragments hold, then the row group's four threads add up.
  const __nv_bfloat16* O = out + base;
  float D0 = 0.f, D1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    if (r0 < N) D0 += dot2(da[ks][0], ld32(O + (size_t)r0 * DH + c)) +
                      dot2(da[ks][2], ld32(O + (size_t)r0 * DH + c + 8));
    if (r1 < N) D1 += dot2(da[ks][1], ld32(O + (size_t)r1 * DH + c)) +
                      dot2(da[ks][3], ld32(O + (size_t)r1 * DH + c + 8));
  }
  D0 += __shfl_xor_sync(0xffffffffu, D0, 1);
  D0 += __shfl_xor_sync(0xffffffffu, D0, 2);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 1);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 2);
  const float* L = lse + (size_t)blockIdx.y * N;
  const float L0 = r0 < N ? L[r0] : 0.f, L1 = r1 < N ? L[r1] : 0.f;
  if (t == 0) {
    if (r0 < N) delta[(size_t)blockIdx.y * N + r0] = D0;
    if (r1 < N) delta[(size_t)blockIdx.y * N + r1] = D1;
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_tiles = (n_real + BT - 1) / BT;  // tiles past n_real are skipped
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BT;
    __syncthreads();
    load_tile(k + base, kv0, N, Ks, Kt);
    load_tile(v + base, kv0, N, Vs, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows(s, qa, Ks, g, t);    // S = Q K^T
    mma_rows(dp, da, Vs, g, t);   // dP = dO V^T
    const bool edge = kv0 + BT > n_real;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float p = expf(s[nt][e] - (hi ? L1 : L0));
        if (edge && kv0 + nt * 8 + 2 * t + (e & 1) >= n_real) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - (hi ? D1 : D0));  // dS
      }
    mma_acc_t(acc, s, Kt, g, t);  // dQ += dS K
  }
  store_rows(dq + base, r0, r1, N, t, acc);
}

__global__ void __launch_bounds__(128)
attn_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                         int n_real) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BT * STR];
  __shared__ __align__(16) __nv_bfloat16 dOs[BT * STR];
  __shared__ __align__(16) __nv_bfloat16 Qt[DH * TSTR];
  __shared__ __align__(16) __nv_bfloat16 dOt[DH * TSTR];
  __shared__ float Ls[BT], Ds[BT];

  const size_t base = (size_t)blockIdx.y * N * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * BT;
  const int k0 = kv0 + warp * 16 + g, k1 = k0 + 8;

  float ak[8][4], av[8][4];  // dK, dV accumulators of this warp's 16 keys
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    ak[nt][0] = ak[nt][1] = ak[nt][2] = ak[nt][3] = 0.f;
    av[nt][0] = av[nt][1] = av[nt][2] = av[nt][3] = 0.f;
  }

  if (kv0 < n_real) {  // else the whole tile is masked: store zeros, load nothing
    uint32_t ka[4][4], va[4][4];
    load_a(k + base, k0, k1, N, t, ka);
    load_a(v + base, k0, k1, N, t, va);
    const bool edge = kv0 + BT > n_real;
    const float* L = lse + (size_t)blockIdx.y * N;
    const float* Dl = delta + (size_t)blockIdx.y * N;

    for (int q0 = 0; q0 < N; q0 += BT) {
      __syncthreads();
      load_tile(q + base, q0, N, Qs, Qt);
      load_tile(dout + base, q0, N, dOs, dOt);
      for (int r = threadIdx.x; r < BT; r += blockDim.x) {
        // a query row past N gets P = exp(s - inf) = 0 and dO = 0
        Ls[r] = q0 + r < N ? L[q0 + r] : INFINITY;
        Ds[r] = q0 + r < N ? Dl[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];
      mma_rows(s, ka, Qs, g, t);    // S^T = K Q^T  (16 keys x 64 queries)
      mma_rows(dp, va, dOs, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          float p = expf(s[nt][e] - Ls[col]);
          if (edge && (e >= 2 ? k1 : k0) >= n_real) p = 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - Ds[col]);  // dS^T
        }
      mma_acc_t(av, s, dOt, g, t);   // dV += P^T dO
      mma_acc_t(ak, dp, Qt, g, t);   // dK += dS^T Q
    }
  }
  // rows >= n_real are exact zeros (the accumulators never left 0 there,
  // and the masked tile's are 0 by construction); store once
  if (k0 >= n_real)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) ak[nt][0] = ak[nt][1] = av[nt][0] = av[nt][1] = 0.f;
  if (k1 >= n_real)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) ak[nt][2] = ak[nt][3] = av[nt][2] = av[nt][3] = 0.f;
  store_rows(dk + base, k0, k1, N, t, ak);
  store_rows(dv + base, k0, k1, N, t, av);
}

// ---- float32 path: one thread per row, scalar FMA ----

__global__ void __launch_bounds__(BR32)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ out,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq, int N, int n_real) {
  __shared__ __align__(16) float Ks[BKV32 * DH];
  __shared__ __align__(16) float Vs[BKV32 * DH];
  __shared__ float acc[DH * BR32];  // dQ accumulators, [d][row]: no bank conflicts

  const size_t base = (size_t)blockIdx.y * N * DH;
  const int tid = threadIdx.x;
  const int r = blockIdx.x * BR32 + tid;

  float4 qr[DH / 4], dr[DH / 4];
  float D = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = r < N ? reinterpret_cast<const float4*>(q + base + (size_t)r * DH)[d] : z;
    dr[d] = r < N ? reinterpret_cast<const float4*>(dout + base + (size_t)r * DH)[d] : z;
    const float4 o = r < N ? reinterpret_cast<const float4*>(out + base + (size_t)r * DH)[d] : z;
    D += dr[d].x * o.x + dr[d].y * o.y + dr[d].z * o.z + dr[d].w * o.w;
  }
  const float l = r < N ? lse[(size_t)blockIdx.y * N + r] : 0.f;
  if (r < N) delta[(size_t)blockIdx.y * N + r] = D;
  for (int d = 0; d < DH; ++d) acc[d * BR32 + tid] = 0.f;

  const int n_tiles = (n_real + BKV32 - 1) / BKV32;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV32;
    __syncthreads();
    for (int c = tid; c < BKV32 * DH / 4; c += BR32) {
      const int row = c / (DH / 4);
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kv0 + row < N) {
        kk = reinterpret_cast<const float4*>(k + base + (size_t)kv0 * DH)[c];
        vv = reinterpret_cast<const float4*>(v + base + (size_t)kv0 * DH)[c];
      }
      reinterpret_cast<float4*>(Ks)[c] = kk;
      reinterpret_cast<float4*>(Vs)[c] = vv;
    }
    __syncthreads();
    const int n_keys = min(BKV32, n_real - kv0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + jj * DH);
      const float4* vr = reinterpret_cast<const float4*>(Vs + jj * DH);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        s = fmaf(qr[d].x, kr[d].x, fmaf(qr[d].y, kr[d].y, fmaf(qr[d].z, kr[d].z,
                 fmaf(qr[d].w, kr[d].w, s))));
        dp = fmaf(dr[d].x, vr[d].x, fmaf(dr[d].y, vr[d].y, fmaf(dr[d].z, vr[d].z,
                  fmaf(dr[d].w, vr[d].w, dp))));
      }
      const float ds = expf(s - l) * (dp - D);
      for (int d = 0; d < DH; ++d) acc[d * BR32 + tid] = fmaf(ds, Ks[jj * DH + d], acc[d * BR32 + tid]);
    }
  }
  if (r < N)
    for (int d = 0; d < DH; ++d) dq[base + (size_t)r * DH + d] = acc[d * BR32 + tid];
}

__global__ void __launch_bounds__(BR32)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int N, int n_real) {
  __shared__ __align__(16) float Qs[BQ32 * DH];
  __shared__ __align__(16) float dOs[BQ32 * DH];
  __shared__ float Ls[BQ32], Ds[BQ32];
  __shared__ float ak[DH * BR32], av[DH * BR32];  // [d][key]: no bank conflicts

  const size_t base = (size_t)blockIdx.y * N * DH;
  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * BR32;
  const int kr = kv0 + tid;
  for (int d = 0; d < DH; ++d) ak[d * BR32 + tid] = av[d * BR32 + tid] = 0.f;

  if (kv0 < n_real) {  // else the whole tile is masked: store zeros, load nothing
    const bool active = kr < n_real;
    float4 kk[DH / 4], vv[DH / 4];
#pragma unroll
    for (int d = 0; d < DH / 4; ++d) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      kk[d] = active ? reinterpret_cast<const float4*>(k + base + (size_t)kr * DH)[d] : z;
      vv[d] = active ? reinterpret_cast<const float4*>(v + base + (size_t)kr * DH)[d] : z;
    }
    for (int q0 = 0; q0 < N; q0 += BQ32) {
      __syncthreads();
      for (int c = tid; c < BQ32 * DH / 4; c += BR32) {
        const int row = c / (DH / 4);
        float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), dd = qq;
        if (q0 + row < N) {
          qq = reinterpret_cast<const float4*>(q + base + (size_t)q0 * DH)[c];
          dd = reinterpret_cast<const float4*>(dout + base + (size_t)q0 * DH)[c];
        }
        reinterpret_cast<float4*>(Qs)[c] = qq;
        reinterpret_cast<float4*>(dOs)[c] = dd;
      }
      if (tid < BQ32) {
        Ls[tid] = q0 + tid < N ? lse[(size_t)blockIdx.y * N + q0 + tid] : INFINITY;
        Ds[tid] = q0 + tid < N ? delta[(size_t)blockIdx.y * N + q0 + tid] : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      for (int ii = 0; ii < BQ32; ++ii) {
        const float4* qr = reinterpret_cast<const float4*>(Qs + ii * DH);
        const float4* dr = reinterpret_cast<const float4*>(dOs + ii * DH);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 4; ++d) {
          s = fmaf(kk[d].x, qr[d].x, fmaf(kk[d].y, qr[d].y, fmaf(kk[d].z, qr[d].z,
                   fmaf(kk[d].w, qr[d].w, s))));
          dp = fmaf(vv[d].x, dr[d].x, fmaf(vv[d].y, dr[d].y, fmaf(vv[d].z, dr[d].z,
                    fmaf(vv[d].w, dr[d].w, dp))));
        }
        const float p = expf(s - Ls[ii]);
        const float ds = p * (dp - Ds[ii]);
        for (int d = 0; d < DH; ++d) {
          av[d * BR32 + tid] = fmaf(p, dOs[ii * DH + d], av[d * BR32 + tid]);
          ak[d * BR32 + tid] = fmaf(ds, Qs[ii * DH + d], ak[d * BR32 + tid]);
        }
      }
    }
  }
  if (kr < N) {
    const bool real = kr < n_real;
    for (int d = 0; d < DH; ++d) {
      dk[base + (size_t)kr * DH + d] = real ? ak[d * BR32 + tid] : 0.f;
      dv[base + (size_t)kr * DH + d] = real ? av[d * BR32 + tid] : 0.f;
    }
  }
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bfloat16, 1 = float32. q, k, v, out, dout, dq, dk, dv: (BH, N, 64);
// lse and delta (scratch for D, written here): (BH, N) f32. The dQ kernel
// computes D; the dK/dV kernel, launched after it on the same stream, reads it.
extern "C" int dlsc_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int BH, int N, int head_dim, int n_real,
                             int dtype, void* stream) {
  if (head_dim != DH || BH <= 0 || BH > 65535 || n_real < 1 || n_real > N)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using bf = __nv_bfloat16;
    const dim3 grid((N + BT - 1) / BT, BH);
    attn_bwd_dq_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(out), static_cast<const bf*>(dout), lse, delta,
        static_cast<bf*>(dq), N, n_real);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
        N, n_real);
  } else if (dtype == 1) {
    const dim3 grid((N + BR32 - 1) / BR32, BH);
    attn_bwd_dq_f32_kernel<<<grid, BR32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), N, n_real);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_f32_kernel<<<grid, BR32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), N, n_real);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
