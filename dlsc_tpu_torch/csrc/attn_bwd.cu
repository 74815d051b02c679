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
// tensor cores (and the exponentials beside them) bound it. The TPU kernel
// carries the dK/dV sums in VMEM across a sequential grid over query blocks;
// H100 blocks run in parallel and in no order, so the work is split into two
// kernels that own their outputs, with no atomics: two calls on the same
// inputs give the same bits. The split recomputes S and dP in both
// (14 N^2 dh operations instead of 10); that is the price of determinism.
//
// bf16 design (hopper.cuh): each CTA is 2 consumer warpgroups of 64 rows and
// one producer warp. The producer's one thread loads the CTA's fixed tiles,
// then streams 64-row tiles through a ring of STAGES slots by TMA
// (128-byte-swizzled, 3-D tensor maps (B*H, N, 64) so that rows past N read
// as zeros, never as the next head's), each slot a "full" mbarrier (bytes
// arrived) and an "empty" one (both warpgroups done with it). Consumers run
// bf16 wgmma m64n64k16 with f32 accumulators:
//  - dQ: a CTA owns (batch x head, 128 queries). Its prologue computes D for
//    its rows and stores it for the next kernel. Per 64-key tile:
//    S = Q K^T and dP = dO V^T (A and B from shared memory, both K-major),
//    dS in registers, then dQ += dS K with dS as the register A operand and
//    K read MN-major through the transpose bit (no transposed copy). Key
//    tiles past n_real are never loaded; only the straddling one is masked.
//  - dK/dV: a CTA owns (batch x head, 128 keys), K and V loaded once; Q and
//    dO stream in 64-query tiles by TMA, and with each tile the producer
//    warp's 32 lanes copy its 64 lse and D values into the slot with plain
//    loads (row b*N of the (B*H, N) f32 arrays need not start 16-byte
//    aligned, as a tensor map's rows must) and arrive on its "full"
//    barrier. S^T = K Q^T and dP^T = V dO^T from shared memory; P^T and
//    dS^T in registers; dV += P^T dO and dK += dS^T Q with the register A
//    operand and dO / Q read MN-major. Query columns >= N take lse = +inf
//    (P = 0). Stored once, rows >= n_real forced to 0; a CTA whose keys are
//    all >= n_real writes zeros and loads nothing.
// A CTA's fixed 64-row box that lies wholly past N is not loaded: its rows
// compute on whatever the slot holds, row by row, and are never stored.
// P and dS are rounded to bf16 before their products, where the TPU kernel
// rounds them. The tile sizes, grids and shared-memory bytes are those of
// `_bwd_plan` in ops/attn_fast.py, which the wrapper checks before launch.
// A float32 path (scalar FMA, one thread per row) serves the tight-tolerance
// parity checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;
// bf16 path: the numbers of `_bwd_plan` (ops/attn_fast.py)
constexpr int TILE = 64;       // rows of one TMA box, of one warpgroup's slice, of a streamed tile
constexpr int BLOCK = 128;     // rows (queries or keys) a CTA owns: 2 consumer warpgroups
constexpr int STAGES = 3;      // slots in the ring of streamed tiles
constexpr int CONSUMERS = 256; // threads of the 2 consumer warpgroups; then 1 producer warp
constexpr int THREADS = CONSUMERS + 32;
constexpr int TILE_BYTES = TILE * DH * 2;
constexpr int BARRIER_BYTES = (1 + 2 * STAGES) * 8;
constexpr int DQ_SMEM = 1024 + 2 * BLOCK * DH * 2 + STAGES * 2 * TILE_BYTES + BLOCK * 4 +
                        BARRIER_BYTES;
constexpr int DKV_SMEM = 1024 + 2 * BLOCK * DH * 2 + STAGES * (2 * TILE_BYTES + 2 * TILE * 4) +
                         BARRIER_BYTES;
constexpr float LOG2E = 1.4426950408889634f;
// f32 path
constexpr int BR32 = 64;        // rows per block, f32 path (one thread each)
constexpr int BKV32 = 32;       // keys per tile, f32 dQ kernel
constexpr int BQ32 = 16;        // queries per tile, f32 dK/dV kernel

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, fmaf(u.y, v.y, s));
  }
  return s;
}

// Rows ra, rb (tile-local rows of this thread, see hopper.cuh) of a 64 x 64
// f32 accumulator into X (N x 64) at row r0 + ra / r0 + rb, rows >= N skipped.
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ X, int ra, int rb, int N,
                                          int t, const float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (ra < N)
      *reinterpret_cast<uint32_t*>(X + (size_t)ra * DH + c) =
          hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(X + (size_t)rb * DH + c) =
          hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int N,
                        int n_real) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(hopper::align1024(smem_raw));  // BLOCK x 64
  __nv_bfloat16* dOs = Qs + BLOCK * DH;                                       // BLOCK x 64
  __nv_bfloat16* Ks = dOs + BLOCK * DH;                         // STAGES x (TILE x 64)
  __nv_bfloat16* Vs = Ks + STAGES * TILE * DH;                  // STAGES x (TILE x 64)
  float* Ds = reinterpret_cast<float*>(Vs + STAGES * TILE * DH);  // BLOCK
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(Ds + BLOCK);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * BLOCK;
  const int n_tiles = (n_real + TILE - 1) / TILE;  // key tiles past n_real are never loaded
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS) {
      const int boxes = min(BLOCK / TILE, (N - q0 + TILE - 1) / TILE);  // boxes not wholly past N
      hopper::mbar_arrive_expect_tx(bar_q, boxes * 2 * TILE_BYTES);
      for (int h = 0; h < boxes; ++h) {
        hopper::tma_load_3d(Qs + h * TILE * DH, &tm_q, bar_q, 0, q0 + h * TILE, bh);
        hopper::tma_load_3d(dOs + h * TILE * DH, &tm_do, bar_q, 0, q0 + h * TILE, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        hopper::tma_load_3d(Ks + s * TILE * DH, &tm_k, &full[s], 0, j * TILE, bh);
        hopper::tma_load_3d(Vs + s * TILE * DH, &tm_v, &full[s], 0, j * TILE, bh);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)bh * N * DH;

  // D = rowsum(dO * O) in f32 for this warpgroup's 64 rows, two threads a row
  {
    const int r = wg * TILE + tid / 2, row = q0 + r, c0 = (tid % 2) * 32;
    float d = 0.f;
    if (row < N) {
      const uint4* po = reinterpret_cast<const uint4*>(out + base + (size_t)row * DH + c0);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + base + (size_t)row * DH + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) d += dot8(pd[i], po[i]);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (tid % 2 == 0) {
      Ds[r] = d;
      if (row < N) delta[(size_t)bh * N + row] = d;
    }
  }
  hopper::named_barrier(1 + wg, 128);
  const int ra = wg * TILE + warp * 16 + g, rb = ra + 8;  // this thread's rows in the CTA
  const float DA = Ds[ra], DB = Ds[rb];
  const float* L = lse + (size_t)bh * N;
  const float LA = q0 + ra < N ? L[q0 + ra] * LOG2E : 0.f;
  const float LB = q0 + rb < N ? L[q0 + rb] * LOG2E : 0.f;

  const uint64_t q_desc = hopper::desc_kmajor(Qs + wg * TILE * DH);
  const uint64_t do_desc = hopper::desc_kmajor(dOs + wg * TILE * DH);
  float acc[32], S[32], dP[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = S[i] = dP[i] = 0.f;

  hopper::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const __nv_bfloat16* Kt = Ks + s * TILE * DH;
    const __nv_bfloat16* Vt = Vs + s * TILE * DH;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);

    // S = Q K^T, dP = dO V^T (64 queries x 64 keys each)
    const uint64_t k_desc = hopper::desc_kmajor(Kt), v_desc = hopper::desc_kmajor(Vt);
    hopper::fence_regs(S);
    hopper::fence_regs(dP);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_m64n64k16_ss<0, 0>(S, q_desc + 2 * k, k_desc + 2 * k, k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_m64n64k16_ss<0, 0>(dP, do_desc + 2 * k, v_desc + 2 * k, k);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(S);
    hopper::fence_regs(dP);

    // dS = P * (dP - D), P = exp(S - lse), keys >= n_real masked
    const int kv0 = j * TILE;
    const bool edge = kv0 + TILE > n_real;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      float p = exp2f(fmaf(S[i], LOG2E, -(hi ? LB : LA)));
      if (edge && kv0 + (i / 4) * 8 + 2 * t + (i & 1) >= n_real) p = 0.f;
      S[i] = p * (dP[i] - (hi ? DB : DA));
    }
    uint32_t a[4][4];
    hopper::acc_to_a(S, a);

    // dQ += dS K, K read MN-major from the same tile
    const uint64_t kt_desc = hopper::desc_mnmajor(Kt);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_rs<1>(acc, a[k], kt_desc + 128 * k);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
  }
  store_acc(dq + base + (size_t)q0 * DH, ra, rb, N - q0, t, acc);
}

__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                         int n_real) {
  const int bh = blockIdx.y, kv0 = blockIdx.x * BLOCK;
  const size_t base = (size_t)bh * N * DH + (size_t)kv0 * DH;
  if (kv0 >= n_real) {  // every key of the block is masked: zeros, nothing loaded
    const int chunks = min(BLOCK, N - kv0) * DH / 8;
    for (int c = threadIdx.x; c < chunks; c += THREADS) {
      reinterpret_cast<uint4*>(dk + base)[c] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dv + base)[c] = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(hopper::align1024(smem_raw));  // BLOCK x 64
  __nv_bfloat16* Vs = Ks + BLOCK * DH;                                        // BLOCK x 64
  __nv_bfloat16* Qs = Vs + BLOCK * DH;                 // STAGES x (TILE x 64)
  __nv_bfloat16* dOs = Qs + STAGES * TILE * DH;        // STAGES x (TILE x 64)
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * TILE * DH);  // STAGES x TILE: lse log2(e)
  float* Dl = Ls + STAGES * TILE;                                  // STAGES x TILE: D
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(Dl + STAGES * TILE);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int n_q = (N + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx, then each producer lane
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    const int lane = threadIdx.x - CONSUMERS;
    if (lane == 0) {
      const int boxes = min(BLOCK / TILE, (N - kv0 + TILE - 1) / TILE);  // not wholly past N
      hopper::mbar_arrive_expect_tx(bar_kv, boxes * 2 * TILE_BYTES);
      for (int h = 0; h < boxes; ++h) {
        hopper::tma_load_3d(Ks + h * TILE * DH, &tm_k, bar_kv, 0, kv0 + h * TILE, bh);
        hopper::tma_load_3d(Vs + h * TILE * DH, &tm_v, bar_kv, 0, kv0 + h * TILE, bh);
      }
    }
    const float* L = lse + (size_t)bh * N;
    const float* D = delta + (size_t)bh * N;
    for (int j = 0; j < n_q; ++j) {
      const int s = j % STAGES;
      hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        hopper::tma_load_3d(Qs + s * TILE * DH, &tm_q, &full[s], 0, j * TILE, bh);
        hopper::tma_load_3d(dOs + s * TILE * DH, &tm_do, &full[s], 0, j * TILE, bh);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a query past N: lse = +inf (P = 0), D = 0
        const int c = 2 * lane + i, r = j * TILE + c;
        Ls[s * TILE + c] = r < N ? L[r] * LOG2E : INFINITY;
        Dl[s * TILE + c] = r < N ? D[r] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);  // releases this lane's stores to the consumers
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const uint64_t k_desc = hopper::desc_kmajor(Ks + wg * TILE * DH);
  const uint64_t v_desc = hopper::desc_kmajor(Vs + wg * TILE * DH);
  float ak[32], av[32], S[32], dP[32];  // dK, dV of this warpgroup's 64 keys; S^T, dP^T
#pragma unroll
  for (int i = 0; i < 32; ++i) ak[i] = av[i] = S[i] = dP[i] = 0.f;

  hopper::mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_q; ++j) {
    const int s = j % STAGES;
    const __nv_bfloat16* Qt = Qs + s * TILE * DH;
    const __nv_bfloat16* dOt = dOs + s * TILE * DH;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);

    // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 queries each)
    const uint64_t q_desc = hopper::desc_kmajor(Qt), do_desc = hopper::desc_kmajor(dOt);
    hopper::fence_regs(S);
    hopper::fence_regs(dP);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_m64n64k16_ss<0, 0>(S, k_desc + 2 * k, q_desc + 2 * k, k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_m64n64k16_ss<0, 0>(dP, v_desc + 2 * k, do_desc + 2 * k, k);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(S);
    hopper::fence_regs(dP);

    // P^T = exp(S^T - lse), dS^T = P^T * (dP^T - D), by query column (a
    // query past N has lse = +inf in the slot, so P = dS = 0 there)
    const float* Lt = Ls + s * TILE;
    const float* Dt = Dl + s * TILE;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int c = c8 * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(Lt + c);
      const float2 d = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c8 + e;
        const float p = exp2f(fmaf(S[i], LOG2E, -(e & 1 ? l.y : l.x)));
        S[i] = p;
        dP[i] = p * (dP[i] - (e & 1 ? d.y : d.x));
      }
    }
    uint32_t pa[4][4], sa[4][4];
    hopper::acc_to_a(S, pa);
    hopper::acc_to_a(dP, sa);

    // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major from the same tiles
    const uint64_t dot_desc = hopper::desc_mnmajor(dOt), qt_desc = hopper::desc_mnmajor(Qt);
    hopper::fence_regs(av);
    hopper::fence_regs(ak);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_rs<1>(av, pa[k], dot_desc + 128 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_rs<1>(ak, sa[k], qt_desc + 128 * k);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(av);
    hopper::fence_regs(ak);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
  }

  // rows >= n_real are exact zeros (a masked key's sums are not computed as 0)
  const int ra = wg * TILE + warp * 16 + g, rb = ra + 8;
  if (kv0 + ra >= n_real)
#pragma unroll
    for (int j = 0; j < 8; ++j) ak[4 * j] = ak[4 * j + 1] = av[4 * j] = av[4 * j + 1] = 0.f;
  if (kv0 + rb >= n_real)
#pragma unroll
    for (int j = 0; j < 8; ++j) ak[4 * j + 2] = ak[4 * j + 3] = av[4 * j + 2] = av[4 * j + 3] = 0.f;
  store_acc(dk + base, ra, rb, N - kv0, t, ak);
  store_acc(dv + base, ra, rb, N - kv0, t, av);
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
// bf16: the tensor maps are built here, per call (16-byte aligned, contiguous
// operands: the wrapper checks).
extern "C" int dlsc_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int BH, int N, int head_dim, int n_real,
                             int dtype, void* stream) {
  if (head_dim != DH || BH <= 0 || BH > 65535 || n_real < 1 || n_real > N)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using bf = __nv_bfloat16;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    const uint64_t dims[3] = {DH, static_cast<uint64_t>(N), static_cast<uint64_t>(BH)};
    const uint64_t strides[2] = {DH * 2, static_cast<uint64_t>(N) * DH * 2};
    const uint32_t box[3] = {DH, TILE, 1};
    const void* tiles[4] = {q, k, v, dout};
    CUtensorMap* maps[4] = {&tm_q, &tm_k, &tm_v, &tm_do};
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < 4 && err == cudaSuccess; ++i)
      err = hopper::make_tensor_map(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, tiles[i], dims,
                                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkv_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BLOCK - 1) / BLOCK, BH);
    attn_bwd_dq_bf16_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
        tm_q, tm_k, tm_v, tm_do, static_cast<const bf*>(out), static_cast<const bf*>(dout), lse,
        delta, static_cast<bf*>(dq), N, n_real);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_bf16_kernel<<<grid, THREADS, DKV_SMEM, st>>>(
        tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), N,
        n_real);
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
