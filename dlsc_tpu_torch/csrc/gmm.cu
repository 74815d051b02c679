// K4: grouped matrix products over expert-sorted rows, for Hopper (sm_90a).
//
// Replaces the TPU kernels that dlsc_tpu/models/moe.py `_grouped_matmul`
// (:537-558) reaches through megablox: `gmm` (gmm.py:314, also with
// transpose_rhs in its VJP, ops.py:80-89) and `tgmm` (gmm.py:573, the
// weight gradient, ops.py:90-99). The rows of lhs are sorted by group;
// group g owns the rows [off_g, off_g + size_g) with off_g the exclusive
// prefix sum of group_sizes, which stays on the card: every block reads the
// E sizes itself, so the host never waits for them.
//
//   K4a gmm:  out[rows of g] = lhs[rows of g] @ rhs[g]     rhs (E, K, N)
//             (transpose_rhs: rhs[g]^T with rhs (E, N, K))  out (M, N)
//   K4b tgmm: out[g] = lhs[rows of g]^T @ grad[rows of g]  lhs (M, K),
//             grad (M, N), out (E, K, N); an empty group writes zeros.
//
// What bounds it here: at the AST-MoE train batch (M 88 192 rows, K/N
// 384/1536) each product is 104 GFLOP against ~350 MB of operands, right at
// the card's ridge (0.105 ms of tensor-core time, 0.104 ms of memory time),
// so the design has to keep the tensor cores fed and read each operand
// about once. Megablox's TPU tiling (1024 x 384 x 512 VMEM tiles, rows
// padded to the tile grain) does not carry over:
//  - bf16: blocks of 256 threads own a 128 x 128 output tile; 8 warps of
//    64 x 32 each run mma.sync.m16n8k16 (bf16 in, f32 accumulate) on
//    fragments loaded by ldmatrix (.trans where the operand's reduction
//    index is the slow one), from 32-deep tiles staged in shared memory by
//    cp.async, double buffered;
//  - gmm: a row tile belongs to one group. Tile t of the grid's y axis
//    finds its group by walking the group sizes (at most ceil(M/128) + E
//    tiles; the surplus blocks exit); rows past the group's end are
//    zero-filled on load and never stored. The grid's x axis runs over the
//    column tiles, so the blocks resident together share their lhs rows in
//    L2 and read each once from HBM;
//  - tgmm: one block per (column tile, k tile, group) loops over the
//    group's rows in 32-row chunks and keeps its sums in registers: no
//    atomics, deterministic. Under skewed routing the largest group sets
//    the pace;
//  - a scalar f32 path (64 x 64 tiles, 4 x 4 outputs a thread) serves the
//    tight-tolerance parity checks.
// Operands are contiguous; in bf16, K and N are multiples of 8 (16-byte
// cp.async chunks). wgmma, TMA and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;  // bf16 block tile
constexpr int THREADS = 256;                // 8 warps: 2 (rows) x 4 (columns)
constexpr int PAD = 8;                      // bf16 row padding: ldmatrix without bank conflicts
constexpr int TILE = BM * (BK + PAD);       // elements of one staged operand tile (either layout)
constexpr int FB = 64, FK = 16;             // f32 block tile and depth

static_assert(BK * (BM + PAD) <= TILE && BK * (BN + PAD) <= TILE && BN * (BK + PAD) <= TILE,
              "staged tiles fit their buffers");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

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

// Row tile t of a grid whose row tiles of TM rows never straddle two
// groups: its group g and its rows [row0, row1). False past the last tile.
template <int TM>
__device__ __forceinline__ bool find_row_tile(const int* __restrict__ sizes, int E, int t,
                                              int& g, int& row0, int& row1) {
  int off = 0, tiles = 0;
  for (int e = 0; e < E; ++e) {
    const int s = sizes[e];
    const int nt = (s + TM - 1) / TM;
    if (t < tiles + nt) {
      g = e;
      row0 = off + (t - tiles) * TM;
      row1 = min(off + s, row0 + TM);
      return true;
    }
    tiles += nt;
    off += s;
  }
  return false;
}

// One 32-deep stage: the warp's 64 x 32 sub-tile accumulates A (64 x 32) B
// (32 x 32). A_T: A is staged [BK][BM] (reduction index slow), else
// [BM][BK]. B_KN: B is staged [BK][BN], else [BN][BK].
template <bool A_T, bool B_KN>
__device__ __forceinline__ void mma_stage(float acc[4][4][4], const bf16* sA, const bf16* sB,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m0 = wm * 64 + i * 16;
      if (A_T)  // matrix j = lane / 8: rows kk + (j / 2) * 8 .., columns m0 + (j % 2) * 8
        ldsm_x4_t(a[i], sA + (kk + (lane & 7) + (lane >> 4) * 8) * (BM + PAD) + m0 +
                            ((lane >> 3) & 1) * 8);
      else  // matrix j: rows m0 + (j % 2) * 8 .., columns kk + (j / 2) * 8
        ldsm_x4(a[i], sA + (m0 + (lane & 15)) * (BK + PAD) + kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // two n8 tiles per ldmatrix.x4
      const int n0 = wn * 32 + j * 16;
      uint32_t r[4];
      if (B_KN)  // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        ldsm_x4_t(r, sB + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * (BN + PAD) + n0 +
                         (lane >> 4) * 8);
      else
        ldsm_x4(r, sB + (n0 + (lane & 7) + (lane >> 4) * 8) * (BK + PAD) + kk +
                       ((lane >> 3) & 1) * 8);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_bf16_16816(acc[i][n], a[i], b[n]);
  }
}

// Stage the gmm operands of reduction step k0: A = lhs rows [row0, row1) x
// [k0, k0 + BK), staged [BM][BK]; B = rhs_g's [k0, k0 + BK) x [n0, n0 + BN),
// staged [BK][BN] from (K, N), or [BN][BK] from (N, K) when TRANS_B.
template <bool TRANS_B>
__device__ __forceinline__ void load_gmm_stage(bf16* sA, bf16* sB, const bf16* lhs,
                                               const bf16* rhs_g, int row0, int row1, int n0,
                                               int k0, int K, int N, int tid) {
#pragma unroll
  for (int c = tid; c < BM * BK / 8; c += THREADS) {
    const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
    const bool ok = row0 + r < row1 && k0 + col < K;
    cp_async16(sA + r * (BK + PAD) + col, ok ? lhs + (size_t)(row0 + r) * K + k0 + col : lhs, ok);
  }
#pragma unroll
  for (int c = tid; c < BK * BN / 8; c += THREADS) {
    if (TRANS_B) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = n0 + r < N && k0 + col < K;
      cp_async16(sB + r * (BK + PAD) + col,
                 ok ? rhs_g + (size_t)(n0 + r) * K + k0 + col : rhs_g, ok);
    } else {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      cp_async16(sB + r * (BN + PAD) + col,
                 ok ? rhs_g + (size_t)(k0 + r) * N + n0 + col : rhs_g, ok);
    }
  }
}

// Stage the tgmm operands of the rows [r, r + BK) ∩ [r, r1): A = lhs's
// columns [i0, i0 + BM), staged [BK][BM]; B = grad's [n0, n0 + BN), [BK][BN].
__device__ __forceinline__ void load_tgmm_stage(bf16* sA, bf16* sB, const bf16* lhs,
                                                const bf16* grad, int r, int r1, int i0, int n0,
                                                int K, int N, int tid) {
#pragma unroll
  for (int c = tid; c < BK * BM / 8; c += THREADS) {
    const int rr = c / (BM / 8), col = (c % (BM / 8)) * 8;
    const bool ok = r + rr < r1 && i0 + col < K;
    cp_async16(sA + rr * (BM + PAD) + col, ok ? lhs + (size_t)(r + rr) * K + i0 + col : lhs, ok);
  }
#pragma unroll
  for (int c = tid; c < BK * BN / 8; c += THREADS) {
    const int rr = c / (BN / 8), col = (c % (BN / 8)) * 8;
    const bool ok = r + rr < r1 && n0 + col < N;
    cp_async16(sB + rr * (BN + PAD) + col, ok ? grad + (size_t)(r + rr) * N + n0 + col : grad,
               ok);
  }
}

// The warp's accumulators to out rows [.., row_end) and columns < N, bf16.
__device__ __forceinline__ void store_tile(float acc[4][4][4], bf16* out, int row_base,
                                           int row_end, int col_base, int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r0 = row_base + i * 16 + g, col = col_base + n * 8 + 2 * t;
      if (col >= N) continue;
      if (r0 < row_end)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * N + col) =
            pack_bf16(acc[i][n][0], acc[i][n][1]);
      if (r0 + 8 < row_end)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * N + col) =
            pack_bf16(acc[i][n][2], acc[i][n][3]);
    }
}

template <bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
                const int* __restrict__ sizes, bf16* __restrict__ out, int K, int N, int E) {
  __shared__ __align__(16) bf16 sA[2][TILE];
  __shared__ __align__(16) bf16 sB[2][TILE];
  int g, row0, row1;
  if (!find_row_tile<BM>(sizes, E, blockIdx.y, g, row0, row1)) return;
  const int n0 = blockIdx.x * BN;
  const bf16* rhs_g = rhs + (size_t)g * K * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 2, wn = warp & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_gmm_stage<TRANS_B>(sA[0], sB[0], lhs, rhs_g, row0, row1, n0, 0, K, N, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_gmm_stage<TRANS_B>(sA[(kt + 1) & 1], sB[(kt + 1) & 1], lhs, rhs_g, row0, row1, n0,
                              (kt + 1) * BK, K, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<false, !TRANS_B>(acc, sA[kt & 1], sB[kt & 1], wm, wn, lane);
    __syncthreads();
  }
  store_tile(acc, out, row0 + wm * 64, row1, n0 + wn * 32, N, lane);
}

__global__ void __launch_bounds__(THREADS)
tgmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ grad,
                 const int* __restrict__ sizes, bf16* __restrict__ out, int K, int N) {
  __shared__ __align__(16) bf16 sA[2][TILE];
  __shared__ __align__(16) bf16 sB[2][TILE];
  const int g = blockIdx.z, n0 = blockIdx.x * BN, i0 = blockIdx.y * BM;
  int r0 = 0;
  for (int e = 0; e < g; ++e) r0 += sizes[e];
  const int r1 = r0 + sizes[g];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 2, wn = warp & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  const int nk = (r1 - r0 + BK - 1) / BK;  // 0 for an empty group: zeros are stored
  if (nk > 0) {
    load_tgmm_stage(sA[0], sB[0], lhs, grad, r0, r1, i0, n0, K, N, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tgmm_stage(sA[(kt + 1) & 1], sB[(kt + 1) & 1], lhs, grad, r0 + (kt + 1) * BK, r1, i0,
                      n0, K, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<true, true>(acc, sA[kt & 1], sB[kt & 1], wm, wn, lane);
    __syncthreads();
  }
  store_tile(acc, out + (size_t)g * K * N, i0 + wm * 64, K, n0 + wn * 32, N, lane);
}

// f32, scalar FMA: 64 x 64 output tile, 16 x 16 threads of 4 x 4 outputs.
template <bool TRANS_B>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ sizes, float* __restrict__ out, int K, int N, int E) {
  __shared__ float As[FK][FB + 1], Bs[FK][FB + 1];
  int g, row0, row1;
  if (!find_row_tile<FB>(sizes, E, blockIdx.y, g, row0, row1)) return;
  const int n0 = blockIdx.x * FB, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* rhs_g = rhs + (size_t)g * K * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = threadIdx.x; c < FB * FK; c += 256) {
      const int m = c / FK, km = c % FK;
      As[km][m] = row0 + m < row1 && k0 + km < K ? lhs[(size_t)(row0 + m) * K + k0 + km] : 0.f;
      if (TRANS_B) {
        const int n = c / FK, kn = c % FK;
        Bs[kn][n] = n0 + n < N && k0 + kn < K ? rhs_g[(size_t)(n0 + n) * K + k0 + kn] : 0.f;
      } else {
        const int kn = c / FB, n = c % FB;
        Bs[kn][n] = k0 + kn < K && n0 + n < N ? rhs_g[(size_t)(k0 + kn) * N + n0 + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < row1 && n < N) out[(size_t)r * N + n] = acc[i][j];
    }
}

__global__ void __launch_bounds__(256)
tgmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ grad,
                const int* __restrict__ sizes, float* __restrict__ out, int K, int N) {
  __shared__ float As[FK][FB + 1], Bs[FK][FB + 1];
  const int g = blockIdx.z, n0 = blockIdx.x * FB, i0 = blockIdx.y * FB;
  int r0 = 0;
  for (int e = 0; e < g; ++e) r0 += sizes[e];
  const int r1 = r0 + sizes[g];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r = r0; r < r1; r += FK) {
    for (int c = threadIdx.x; c < FB * FK; c += 256) {
      const int rr = c / FB, col = c % FB;
      As[rr][col] = r + rr < r1 && i0 + col < K ? lhs[(size_t)(r + rr) * K + i0 + col] : 0.f;
      Bs[rr][col] = r + rr < r1 && n0 + col < N ? grad[(size_t)(r + rr) * N + n0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out_g = out + (size_t)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = i0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < K && n < N) out_g[(size_t)r * N + n] = acc[i][j];
    }
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4a. dtype: 0 = bfloat16, 1 = float32. lhs (M, K); rhs (E, K, N), or
// (E, N, K) when transpose_rhs; group_sizes (E,) int32 on the card, summing
// to M; out (M, N).
extern "C" int dlsc_gmm(const void* lhs, const void* rhs, const int* group_sizes, void* out,
                        int M, int K, int N, int E, int transpose_rhs, int dtype, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || (dtype == 0 && (K % 8 || N % 8)))
    return cudaErrorInvalidValue;
  const int tm = dtype == 0 ? BM : FB, tn = dtype == 0 ? BN : FB;
  const long long row_tiles = ((long long)M + tm - 1) / tm + E;  // at least every group's tiles
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + tn - 1) / tn, (unsigned)row_tiles);
  if (dtype == 0) {
    const bf16* a = static_cast<const bf16*>(lhs);
    const bf16* b = static_cast<const bf16*>(rhs);
    bf16* o = static_cast<bf16*>(out);
    if (transpose_rhs)
      gmm_bf16_kernel<true><<<grid, THREADS, 0, st>>>(a, b, group_sizes, o, K, N, E);
    else
      gmm_bf16_kernel<false><<<grid, THREADS, 0, st>>>(a, b, group_sizes, o, K, N, E);
  } else if (dtype == 1) {
    const float* a = static_cast<const float*>(lhs);
    const float* b = static_cast<const float*>(rhs);
    float* o = static_cast<float*>(out);
    if (transpose_rhs)
      gmm_f32_kernel<true><<<grid, 256, 0, st>>>(a, b, group_sizes, o, K, N, E);
    else
      gmm_f32_kernel<false><<<grid, 256, 0, st>>>(a, b, group_sizes, o, K, N, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K4b. lhs (M, K), grad (M, N), group_sizes (E,) int32 on the card; out
// (E, K, N).
extern "C" int dlsc_tgmm(const void* lhs, const void* grad, const int* group_sizes, void* out,
                         int M, int K, int N, int E, int dtype, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || (dtype == 0 && (K % 8 || N % 8)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
    tgmm_bf16_kernel<<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(lhs),
                                               static_cast<const bf16*>(grad), group_sizes,
                                               static_cast<bf16*>(out), K, N);
  } else if (dtype == 1) {
    const dim3 grid((N + FB - 1) / FB, (K + FB - 1) / FB, E);
    tgmm_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(lhs),
                                          static_cast<const float*>(grad), group_sizes,
                                          static_cast<float*>(out), K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
