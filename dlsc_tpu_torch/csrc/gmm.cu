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
// padded to the tile grain) does not carry over.
//
// K4a bf16 (hopper.cuh; the numbers of `_gmm_plan` in ops/gmm.py):
//  - a CTA owns 128 x 128 output tiles, one at a time: 2 consumer
//    warpgroups of 64 rows each run bf16 wgmma m64n128k16 with f32
//    accumulators in registers (64 a thread, under ptxas's 168-register cap
//    for 288 threads); one producer warp's thread keeps TMA loads in flight
//    into a ring of GSTAGES slots on "full"/"empty" mbarriers: per slot the
//    128-row lhs tile and the matching rhs[g] tile, 64 deep (one 128-byte
//    swizzle row of bf16), so the tensor cores are kept fed while the ring
//    runs ahead, across tile boundaries;
//  - operands: lhs is the K-major A (SS). With transpose_rhs, rhs[g] (N, K)
//    is a K-major B: one 128-row box. Without it, rhs[g] (K, N) is an
//    MN-major B read through the transpose bit: two 64-column boxes, panels
//    8 KB apart, which the descriptor's LBO names (`desc_mnmajor_panels`).
//    One m64n128k16 product per 16-deep step rather than two n64 ones: each
//    A fragment is read from shared memory once per step. rhs goes through
//    a 3-D tensor map (E, ., .), so a box past N or K reads zeros, never the
//    next expert's weights; a box wholly past N is not loaded;
//  - groups: a row tile never straddles two groups, so it multiplies by one
//    rhs[g]; there are at most ceil(M/128) + E row tiles. TMA loads the
//    full 128 rows; rows at or past the group's end (or past M, which read
//    as zeros) are computed and never stored;
//  - epilogue: each warpgroup stages its 64 x 128 slice in bf16 in shared
//    memory (two 128-byte-swizzled panels: conflict-free from the
//    accumulator layout) and writes it by TMA store when every row of the
//    slice below M is the group's: one thread issues it and the warpgroup
//    goes on to the next tile's products while it drains. A TMA store
//    cannot mask the rows of the next group, so a slice that ends inside it
//    is written by 16-byte stores under a row mask;
//  - schedule: persistent, one CTA per SM, each walking the (row tile,
//    column tile) pairs t = blockIdx.x, + gridDim.x, ..., columns fastest,
//    so that the CTAs resident together share their lhs rows in L2 and lhs
//    is read about once from HBM. Every CTA builds the group table (first
//    tile, first row of each group) from group_sizes on the card; the host
//    never reads the sizes, and no grid dimension caps the row tiles.
// K4b bf16 (hopper.cuh; the numbers of `_tgmm_plan` in ops/gmm.py), out[g]
// = lhs[rows of g]^T @ grad[rows of g]: the contraction runs over rows, the
// outer dimension of both operands, so both are MN-major wgmma operands
// read through the transpose bit, and the rows of one group are many
// (~11 000 at the router draw) against a 128 x 128 output tile:
//  - work split: each group's rows are cut into about equal slices of at
//    most S rows (S a multiple of 64, chosen on the host from M, K, N, E and
//    the SM count alone, so that the (group, slice, output tile) units
//    number about TGMM_UNITS_PER_SM times the SMs; equal slices keep the
//    units of a group alike, so the CTAs' shares of rows stay near the
//    mean); a slice never straddles two groups, so there are at most
//    ceil(M/S) + E slices, and under skewed routing the largest group's
//    slices spread over every SM instead of setting the pace;
//  - a unit's product: K4a's ring (5 slots on full/empty mbarriers, 2
//    consumer warpgroups and a producer warp). Per 64-row stage each
//    warpgroup reads its 64 lhs columns (one 64 x 64 box: an MN-major A) and
//    the 128 grad columns (two 64-column panels: an MN-major B, LBO the
//    panel stride) and runs m64n128k16 with both transpose bits set, f32
//    accumulators in registers;
//  - rows that are not the slice's: a TMA box starts at any row but cannot
//    stop at the slice's end, so in a slice's last stage the consumers zero
//    the staged rows at or past it in all four boxes (a 128-byte swizzle
//    keeps each row whole), then fence.proxy.async before the wgmma reads
//    them; rows past M read as zeros from TMA;
//  - schedule: persistent, one CTA per SM, each walking the units u =
//    blockIdx.x, + gridDim.x, ..., ordered by group, slice, then tile, so the
//    CTAs resident together read the same rows and lhs and grad come from
//    HBM about once. Every CTA builds the group/slice table from
//    group_sizes on the card; the host never reads the sizes;
//  - epilogue: a group with one slice owns its tiles and writes them in bf16
//    by TMA store into a 3-D (N, K, E) map, so a tile past K never touches
//    the next expert; a group with several slices writes f32 partial tiles
//    into the workspace slot of each slice, and a second small kernel sums
//    each tile's partials in slice order and writes bf16: no atomics, and
//    reruns are bit-identical. That kernel also writes an empty group's
//    zeros.
// A scalar f32 path (64 x 64 tiles, 4 x 4 outputs a thread) serves the
// tight-tolerance parity checks of both.
// Operands are contiguous; in bf16, K and N are multiples of 8 (16-byte
// rows for TMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// K4a bf16: the numbers of `_gmm_plan` (ops/gmm.py)
constexpr int GM = 128;                  // rows of an output tile: 2 consumer warpgroups of 64
constexpr int GN = 128;                  // columns of an output tile: one m64n128k16 product
constexpr int GK = 64;                   // depth of a stage: one 128-byte swizzle row of bf16
constexpr int GSTAGES = 5;               // slots of the ring
constexpr int G_CONSUMERS = 256;         // then 1 producer warp
constexpr int G_THREADS = G_CONSUMERS + 32;
constexpr int A_BYTES = GM * GK * 2;     // one lhs tile
constexpr int PANEL_BYTES = GK * 64 * 2; // one 64-column panel of an MN-major rhs tile
constexpr int B_BYTES = GK * GN * 2;     // one rhs tile
constexpr int C_BYTES = 64 * GN * 2;     // one consumer warpgroup's output slice, staged
constexpr int MAX_GROUPS = 256;          // the group table's capacity
constexpr int GMM_SMEM = 1024 + GSTAGES * (A_BYTES + B_BYTES) + 2 * C_BYTES +
                         2 * GSTAGES * 8 + 2 * (MAX_GROUPS + 1) * 4;
// K4b bf16: the numbers of `_tgmm_plan` (ops/gmm.py); the output tile is
// K4a's (GM x GN, the rows being lhs columns), a stage 64 rows of the
// reduction: per warpgroup one 64 x 64 lhs box, and the two grad panels
constexpr int TR = 64;                         // reduction rows of a stage
constexpr int TSTAGE_BYTES = 4 * PANEL_BYTES;       // 2 lhs boxes, 2 grad panels
constexpr int TGMM_SMEM = 1024 + GSTAGES * TSTAGE_BYTES + 2 * C_BYTES + 2 * GSTAGES * 8 +
                          2 * (MAX_GROUPS + 1) * 4;
constexpr int TGMM_UNITS_PER_SM = 4;           // the slice length's target (see the top)
constexpr int PARTIAL = GM * GN;               // floats of one f32 partial tile
constexpr int FB = 64, FK = 16;                // f32 block tile and depth

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

// ---- K4a bf16: wgmma on a TMA ring, persistent ----

// The row tile `rt` of the walk: its group g (carried forward, since a CTA
// visits row tiles in increasing order) and its first row. tstart[e]: the
// first row tile of group e (tstart[E] = all row tiles); rstart[e]: its first
// row. An empty group has tstart[e] == tstart[e + 1] and is stepped over.
__device__ __forceinline__ int tile_group(const int* tstart, int rt, int g) {
  while (tstart[g + 1] <= rt) ++g;
  return g;
}

// A consumer warpgroup's 64 x 128 accumulator (m64n128k16 layout) as bf16 in
// C: two 128-byte-swizzled 64-column panels, conflict-free from that layout.
// The writes are then fenced for the async proxy (a TMA store reads C next).
__device__ __forceinline__ void stage_bf16(const float (&acc)[64], uint8_t* C, int warp,
                                           int lane) {
  const int ra = warp * 16 + lane / 4, t = lane % 4;  // this thread's rows ra and ra + 8
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint8_t* panel = C + (j / 8) * PANEL_BYTES + 4 * t;
    *reinterpret_cast<uint32_t*>(panel + hopper::sw128(ra, j % 8)) =
        hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(panel + hopper::sw128(ra + 8, j % 8)) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::fence_async_smem();
}

// TRANS_B: rhs (E, N, K), a K-major B; else rhs (E, K, N), an MN-major B.
template <bool TRANS_B>
__global__ void __launch_bounds__(G_THREADS, 1)
gmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                      const __grid_constant__ CUtensorMap tm_rhs,
                      const __grid_constant__ CUtensorMap tm_out,
                      const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K, int N,
                      int E) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* As = hopper::align1024(smem_raw);                     // GSTAGES x (GM x GK)
  uint8_t* Bs = As + GSTAGES * A_BYTES;                  // GSTAGES x (GK x GN)
  uint8_t* Cs = Bs + GSTAGES * B_BYTES;                  // 2 x (64 x GN), two panels each
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + 2 * C_BYTES);
  uint64_t* empty = full + GSTAGES;
  int* tstart = reinterpret_cast<int*>(empty + GSTAGES);  // E + 1
  int* rstart = tstart + MAX_GROUPS + 1;                  // E + 1

  if (threadIdx.x == 0) {
    int tiles = 0, rows = 0;
    for (int e = 0; e < E; ++e) {
      const int s = max(sizes[e], 0);
      tstart[e] = tiles;
      rstart[e] = rows;
      tiles += (s + GM - 1) / GM;
      rows += s;
    }
    tstart[E] = tiles;
    rstart[E] = rows;
    for (int s = 0; s < GSTAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int col_tiles = (N + GN - 1) / GN, k_steps = (K + GK - 1) / GK;
  const int total = tstart[E] * col_tiles;

  if (threadIdx.x >= G_CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == G_CONSUMERS) {
      int it = 0, g = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int rt = tile / col_tiles, n0 = (tile % col_tiles) * GN;
        g = tile_group(tstart, rt, g);
        const int row0 = rstart[g] + (rt - tstart[g]) * GM;
        const int panels = n0 + 64 < N ? 2 : 1;  // MN-major: boxes not wholly past N
        const uint32_t bytes = A_BYTES + (TRANS_B ? B_BYTES : panels * PANEL_BYTES);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % GSTAGES;
          hopper::mbar_wait(&empty[s], ((it / GSTAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], bytes);
          hopper::tma_load_2d(As + s * A_BYTES, &tm_lhs, &full[s], ks * GK, row0);
          uint8_t* b = Bs + s * B_BYTES;
          if (TRANS_B) {
            hopper::tma_load_3d(b, &tm_rhs, &full[s], ks * GK, n0, g);
          } else {
            for (int p = 0; p < panels; ++p)
              hopper::tma_load_3d(b + p * PANEL_BYTES, &tm_rhs, &full[s], n0 + 64 * p, ks * GK,
                                  g);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0, g = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int rt = tile / col_tiles, n0 = (tile % col_tiles) * GN;
    g = tile_group(tstart, rt, g);
    const int row0 = rstart[g] + (rt - tstart[g]) * GM;
    const int row_end = min(min(rstart[g + 1], row0 + GM), M);

    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int s = it % GSTAGES;
      hopper::mbar_wait(&full[s], (it / GSTAGES) & 1);
      const uint64_t a_desc = hopper::desc_kmajor(As + s * A_BYTES + wg * (A_BYTES / 2));
      const uint64_t b_desc = TRANS_B ? hopper::desc_kmajor(Bs + s * B_BYTES)
                                      : hopper::desc_mnmajor_panels(Bs + s * B_BYTES, PANEL_BYTES);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // K-major steps 32 bytes along the row; MN-major 16 rows down
        hopper::wgmma_m64n128k16_ss<0, TRANS_B ? 0 : 1>(
            acc, a_desc + 2 * k, b_desc + (TRANS_B ? 2 : 128) * k, ks > 0 || k > 0);
      hopper::wgmma_commit();
      // keep this step's products in flight; the previous step's are done,
      // so its slot goes back to the producer
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (ks > 0 && tid == 0) hopper::mbar_arrive(&empty[(it - 1) % GSTAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[(it - 1) % GSTAGES]);

    // epilogue: this warpgroup's 64 rows from lo, rows < row_end (this
    // group's, < M) and columns < N, staged in bf16 as two 128-byte-swizzled
    // 64-column panels
    const int lo = row0 + wg * 64;
    if (lo >= row_end) continue;  // no row of the slice is this group's
    uint8_t* C = Cs + wg * C_BYTES;
    if (tid == 0) hopper::bulk_wait_read<0>();  // the last TMA store has read the stage
    hopper::named_barrier(1 + wg, 128);
    stage_bf16(acc, C, warp, lane);
    hopper::named_barrier(1 + wg, 128);
    if (min(lo + 64, M) <= row_end) {
      // every row of the slice below M is this group's: TMA stores, which
      // clip at M and N and run on while the next tile's products do
      if (tid == 0) {
        for (int p = 0; p < (n0 + 64 < N ? 2 : 1); ++p)
          hopper::tma_store_2d(&tm_out, C + p * PANEL_BYTES, n0 + 64 * p, lo);
        hopper::bulk_commit();
      }
    } else {
      // the slice ends inside the next group: 16-byte stores under a row mask
      for (int c = tid; c < 64 * GN / 8; c += 128) {
        const int r = c / (GN / 8), cc = c % (GN / 8), col = n0 + 8 * cc;
        if (lo + r < row_end && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)(lo + r) * N + col) =
              *reinterpret_cast<const uint4*>(C + (cc / 8) * PANEL_BYTES +
                                              hopper::sw128(r, cc % 8));
      }
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // the stage stays until the last store is done
}

// ---- K4b bf16: wgmma on a TMA ring over row slices, persistent ----

// The slice `sl` of the walk: its group g (carried forward, since a CTA
// visits slices in increasing order) and its rows [r0, r1). sstart[e]: the
// first slice of group e (sstart[E] = all slices); rstart[e]: its first row.
// An empty group has sstart[e] == sstart[e + 1] and is stepped over. A
// group of s rows has n = ceil(s / S) slices of L = ceil(s / n) rounded up
// to the 64-row stage (so the slices of a group are about equal, and there
// are still n of them: (n - 1) L <= (n - 1) S < s), the last one shorter.
__device__ __forceinline__ int slice_rows(const int* sstart, const int* rstart, int sl, int S,
                                          int& g, int& r1) {
  while (sstart[g + 1] <= sl) ++g;
  const int s = rstart[g + 1] - rstart[g], n = sstart[g + 1] - sstart[g];
  const int L = ((s + n - 1) / n + TR - 1) / TR * TR;
  const int r0 = rstart[g] + (sl - sstart[g]) * L;
  r1 = min(r0 + L, rstart[g + 1]);
  return r0;
}

// Group table of slices of at most S rows, built by one thread from the
// sizes on the card: negative sizes read as 0, and rows past M are cut, so
// there are never more than ceil(M/S) + E slices (the workspace's slots).
__device__ __forceinline__ void slice_table(const int* __restrict__ sizes, int M, int E, int S,
                                            int* sstart, int* rstart) {
  int slices = 0, rows = 0;
  for (int e = 0; e < E; ++e) {
    const int s = min(max(sizes[e], 0), M - rows);
    sstart[e] = slices;
    rstart[e] = rows;
    slices += (s + S - 1) / S;
    rows += s;
  }
  sstart[E] = slices;
  rstart[E] = rows;
}

// lhs (M, K) and grad (M, N) through 2-D maps of 64 x 64 boxes; out (E, K, N)
// through a 3-D map (N, K, E) of 64 x 64 x 1 boxes; ws: the f32 partial
// tiles, slot sl * T + tile for slice sl (T tiles a group).
__global__ void __launch_bounds__(G_THREADS, 1)
tgmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                       const __grid_constant__ CUtensorMap tm_grad,
                       const __grid_constant__ CUtensorMap tm_out,
                       const int* __restrict__ sizes, float* __restrict__ ws, int M, int K,
                       int N, int E, int S) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);  // GSTAGES x (2 lhs boxes, 2 grad panels)
  uint8_t* Cs = ring + GSTAGES * TSTAGE_BYTES;   // 2 x (64 x GN), two panels each
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + 2 * C_BYTES);
  uint64_t* empty = full + GSTAGES;
  int* sstart = reinterpret_cast<int*>(empty + GSTAGES);  // E + 1
  int* rstart = sstart + MAX_GROUPS + 1;                  // E + 1

  if (threadIdx.x == 0) {
    slice_table(sizes, M, E, S, sstart, rstart);
    for (int s = 0; s < GSTAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = (N + GN - 1) / GN, T = ((K + GM - 1) / GM) * n_tiles;
  const int total = sstart[E] * T;

  if (threadIdx.x >= G_CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == G_CONSUMERS) {
      int it = 0, g = 0, r1;
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        const int r0 = slice_rows(sstart, rstart, u / T, S, g, r1);
        const int k0 = (u % T) / n_tiles * GM, n0 = (u % T) % n_tiles * GN;
        const int a_boxes = k0 + 64 < K ? 2 : 1, b_boxes = n0 + 64 < N ? 2 : 1;  // not past K, N
        const uint32_t bytes = (a_boxes + b_boxes) * PANEL_BYTES;
        for (int row = r0; row < r1; row += TR, ++it) {
          const int s = it % GSTAGES;
          uint8_t* st = ring + s * TSTAGE_BYTES;
          hopper::mbar_wait(&empty[s], ((it / GSTAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], bytes);
          for (int a = 0; a < a_boxes; ++a)
            hopper::tma_load_2d(st + a * PANEL_BYTES, &tm_lhs, &full[s], k0 + 64 * a, row);
          for (int b = 0; b < b_boxes; ++b)
            hopper::tma_load_2d(st + (2 + b) * PANEL_BYTES, &tm_grad, &full[s], n0 + 64 * b,
                                row);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0, g = 0, r1;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const int sl = u / T, tile = u % T;
    const int r0 = slice_rows(sstart, rstart, sl, S, g, r1);
    const int k0 = tile / n_tiles * GM, n0 = tile % n_tiles * GN;

    for (int row = r0; row < r1; row += TR, ++it) {
      const int s = it % GSTAGES;
      uint8_t* st = ring + s * TSTAGE_BYTES;
      hopper::mbar_wait(&full[s], (it / GSTAGES) & 1);
      const int valid = r1 - row;
      if (valid < TR) {
        // the slice's last stage: zero the rows at or past its end in the
        // four boxes (16-byte chunks over both warpgroups; a row is one whole
        // 128-byte swizzle row), then hand them to the async proxy
        const int chunks = (TR - valid) * 8;
        for (int i = threadIdx.x; i < 4 * chunks; i += G_CONSUMERS)
          *reinterpret_cast<uint4*>(st + (i / chunks) * PANEL_BYTES + valid * 128 +
                                    (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
        hopper::fence_async_smem();
        hopper::named_barrier(3, G_CONSUMERS);
      }
      const uint64_t a_desc = hopper::desc_mnmajor(st + wg * PANEL_BYTES);
      const uint64_t b_desc = hopper::desc_mnmajor_panels(st + 2 * PANEL_BYTES, PANEL_BYTES);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // MN-major both: a step of 16 rows is 128 x 16 bytes on
        hopper::wgmma_m64n128k16_ss<1, 1>(acc, a_desc + 128 * k, b_desc + 128 * k,
                                          row > r0 || k > 0);
      hopper::wgmma_commit();
      // keep this stage's products in flight; the previous stage's are done,
      // so its slot goes back to the producer
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (row > r0 && tid == 0) hopper::mbar_arrive(&empty[(it - 1) % GSTAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[(it - 1) % GSTAGES]);

    const int lo = k0 + wg * 64;  // this warpgroup's first output row
    if (lo >= K) continue;        // its rows are all past K
    if (sstart[g + 1] - sstart[g] > 1) {
      // one of several slices: the f32 partial tile into the slice's slot,
      // 8-byte stores that fill whole 32-byte sectors (4 threads a row)
      float* part = ws + ((size_t)sl * T + tile) * PARTIAL;
      const int ra = wg * 64 + warp * 16 + lane / 4, t = lane % 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(part + ra * GN + 8 * j + 2 * t) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (ra + 8) * GN + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      continue;
    }
    // the group's only slice: bf16 by TMA store, clipped at K and N
    uint8_t* C = Cs + wg * C_BYTES;
    if (tid == 0) hopper::bulk_wait_read<0>();  // the last TMA store has read the stage
    hopper::named_barrier(1 + wg, 128);
    stage_bf16(acc, C, warp, lane);
    hopper::named_barrier(1 + wg, 128);
    if (tid == 0) {
      for (int p = 0; p < (n0 + 64 < N ? 2 : 1); ++p)
        hopper::tma_store_3d(&tm_out, C + p * PANEL_BYTES, n0 + 64 * p, lo, g);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // the stage stays until the last store is done
}

// K4b's second pass: one CTA per 8 rows of an output tile of a group, a
// thread per 4 columns. A group of several slices: its partial tiles summed
// in slice order, written in bf16; an empty group: zeros; a group of one
// slice was written by the first pass.
constexpr int REDUCE_ROWS = 256 * 4 / GN;  // rows of a tile per CTA

__global__ void __launch_bounds__(256)
tgmm_reduce_kernel(const float* __restrict__ ws, const int* __restrict__ sizes,
                   bf16* __restrict__ out, int M, int K, int N, int E, int S) {
  __shared__ int sstart[MAX_GROUPS + 1], rstart[MAX_GROUPS + 1];
  if (threadIdx.x == 0) slice_table(sizes, M, E, S, sstart, rstart);
  __syncthreads();
  const int n_tiles = (N + GN - 1) / GN, T = ((K + GM - 1) / GM) * n_tiles;
  const int tile = blockIdx.x / (GM / REDUCE_ROWS), g = blockIdx.y;
  const int first = sstart[g], count = sstart[g + 1] - first;
  const int r = blockIdx.x % (GM / REDUCE_ROWS) * REDUCE_ROWS + threadIdx.x / (GN / 4);
  const int c = threadIdx.x % (GN / 4) * 4;
  const int k0 = tile / n_tiles * GM, n0 = tile % n_tiles * GN;
  if (count == 1 || k0 + r >= K || n0 + c >= N) return;
  const float* part = ws + ((size_t)first * T + tile) * PARTIAL + r * GN + c;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = 0; i < count; ++i) {
    const float4 p = *reinterpret_cast<const float4*>(part + (size_t)i * T * PARTIAL);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  uint2 packed;
  packed.x = hopper::pack_bf16(sum.x, sum.y);
  packed.y = hopper::pack_bf16(sum.z, sum.w);
  *reinterpret_cast<uint2*>(out + (size_t)g * K * N + (size_t)(k0 + r) * N + n0 + c) = packed;
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
// to M; out (M, N). bf16: `grid`, `threads`, `smem` and `stages` are the
// wrapper's `_gmm_plan`; the launch is refused unless they are this
// kernel's own (grid: one CTA per SM, at most one per tile).
extern "C" int dlsc_gmm(const void* lhs, const void* rhs, const int* group_sizes, void* out,
                        int M, int K, int N, int E, int transpose_rhs, int dtype, int grid,
                        int threads, int smem, int stages, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || (dtype == 0 && (K % 8 || N % 8)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (E > MAX_GROUPS) return cudaErrorInvalidValue;
    if (M == 0) return cudaSuccess;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long max_tiles = ((long long)(M + GM - 1) / GM + E) * ((N + GN - 1) / GN);
    const int ctas = (int)(max_tiles < sms ? max_tiles : sms);
    if (grid != ctas || threads != G_THREADS || smem != GMM_SMEM || stages != GSTAGES)
      return cudaErrorInvalidConfiguration;
    CUtensorMap tm_lhs, tm_rhs, tm_out;
    const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
    const uint64_t a_strides[1] = {static_cast<uint64_t>(K) * 2};
    const uint32_t a_box[2] = {GK, GM};
    err = hopper::make_tensor_map(&tm_lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, a_dims,
                                  a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    const uint64_t c_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
    const uint64_t c_strides[1] = {static_cast<uint64_t>(N) * 2};
    const uint32_t c_box[2] = {64, 64};
    err = hopper::make_tensor_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, c_dims,
                                  c_strides, c_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    const uint64_t inner = transpose_rhs ? K : N, outer = transpose_rhs ? N : K;
    const uint64_t b_dims[3] = {inner, outer, static_cast<uint64_t>(E)};
    const uint64_t b_strides[2] = {inner * 2, inner * outer * 2};
    const uint32_t b_box[3] = {GK, static_cast<uint32_t>(transpose_rhs ? GN : GK), 1};
    err = hopper::make_tensor_map(&tm_rhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, b_dims,
                                  b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    auto kernel = transpose_rhs ? gmm_bf16_wgmma_kernel<true> : gmm_bf16_wgmma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GMM_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<ctas, G_THREADS, GMM_SMEM, st>>>(tm_lhs, tm_rhs, tm_out, group_sizes,
                                              static_cast<bf16*>(out), M, K, N, E);
  } else if (dtype == 1) {
    const long long row_tiles = ((long long)M + FB - 1) / FB + E;  // at least every group's tiles
    if (row_tiles > 65535) return cudaErrorInvalidValue;
    const dim3 grid32((N + FB - 1) / FB, (unsigned)row_tiles);
    const float* a = static_cast<const float*>(lhs);
    const float* b = static_cast<const float*>(rhs);
    float* o = static_cast<float*>(out);
    if (transpose_rhs)
      gmm_f32_kernel<true><<<grid32, 256, 0, st>>>(a, b, group_sizes, o, K, N, E);
    else
      gmm_f32_kernel<false><<<grid32, 256, 0, st>>>(a, b, group_sizes, o, K, N, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The slice length of K4b bf16 (`_tgmm_plan`): the units ((group, slice,
// output tile); at most ceil(M/S) + E slices of T tiles) number about
// TGMM_UNITS_PER_SM times the SMs; a multiple of the 64-row stage.
static int tgmm_slice_rows(int M, int K, int N, int sms) {
  const long long T = (long long)((K + GM - 1) / GM) * ((N + GN - 1) / GN);
  const long long want = (M * T + (long long)TGMM_UNITS_PER_SM * sms - 1) /
                         ((long long)TGMM_UNITS_PER_SM * sms);
  const long long S = (want + TR - 1) / TR * TR;
  return (int)(S < TR ? TR : S);
}

// K4b. lhs (M, K), grad (M, N), group_sizes (E,) int32 on the card; out
// (E, K, N). bf16: `grid`, `threads`, `smem`, `stages`, `slice_rows` and
// `slots` are the wrapper's `_tgmm_plan`, and the launch is refused unless
// they are this kernel's own (grid: one CTA per SM, at most one per unit);
// `workspace` holds `slots` x T f32 partial tiles of GM x GN (T the output
// tiles of a group). Two kernels run: the sliced products, then the sum of
// the partials of every group of several slices.
extern "C" int dlsc_tgmm(const void* lhs, const void* grad, const int* group_sizes, void* out,
                         void* workspace, int M, int K, int N, int E, int dtype, int grid,
                         int threads, int smem, int stages, int slice_rows, int slots,
                         void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || (dtype == 0 && (K % 8 || N % 8)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (E > MAX_GROUPS) return cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int S = tgmm_slice_rows(M, K, N, sms);
    const int T = ((K + GM - 1) / GM) * ((N + GN - 1) / GN);
    const int own_slots = (M + S - 1) / S + E;
    const long long max_units = (long long)own_slots * T;
    const int ctas = (int)(max_units < sms ? max_units : sms);
    if (grid != ctas || threads != G_THREADS || smem != TGMM_SMEM || stages != GSTAGES ||
        slice_rows != S || slots != own_slots)
      return cudaErrorInvalidConfiguration;
    float* ws = static_cast<float*>(workspace);
    if (M > 0) {
      CUtensorMap tm_lhs, tm_grad, tm_out;
      const uint32_t box[3] = {64, 64, 1};
      const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
      const uint64_t a_strides[1] = {static_cast<uint64_t>(K) * 2};
      err = hopper::make_tensor_map(&tm_lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, a_dims,
                                    a_strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
      const uint64_t b_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
      const uint64_t b_strides[1] = {static_cast<uint64_t>(N) * 2};
      err = hopper::make_tensor_map(&tm_grad, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, grad, b_dims,
                                    b_strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
      const uint64_t c_dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                                  static_cast<uint64_t>(E)};
      const uint64_t c_strides[2] = {static_cast<uint64_t>(N) * 2,
                                     static_cast<uint64_t>(N) * K * 2};
      err = hopper::make_tensor_map(&tm_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, c_dims,
                                    c_strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(tgmm_bf16_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, TGMM_SMEM);
      if (err != cudaSuccess) return err;
      tgmm_bf16_wgmma_kernel<<<ctas, G_THREADS, TGMM_SMEM, st>>>(tm_lhs, tm_grad, tm_out,
                                                                 group_sizes, ws, M, K, N, E, S);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    tgmm_reduce_kernel<<<dim3(T * (GM / REDUCE_ROWS), E), 256, 0, st>>>(
        ws, group_sizes, static_cast<bf16*>(out), M, K, N, E, S);
  } else if (dtype == 1) {
    const dim3 grid32((N + FB - 1) / FB, (K + FB - 1) / FB, E);
    tgmm_f32_kernel<<<grid32, 256, 0, st>>>(static_cast<const float*>(lhs),
                                            static_cast<const float*>(grad), group_sizes,
                                            static_cast<float*>(out), K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
