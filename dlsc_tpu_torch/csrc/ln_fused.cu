// K3: fused residual add + LayerNorm, forward (K3f) and backward (K3b), for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of dlsc_tpu/ops/ln_fused.py `_make_fused_add_ln`:
// `fwd_kernel` and `bwd_kernel`, with their custom VJP.
//
// Forward, per row of d: r = x + delta summed in f32; mu and the variance of
// that unrounded f32 sum (two passes over registers), rsig = 1/sqrt(var +
// eps); y = (r - mu) * rsig * gamma + beta. r and y are stored in the input
// type, mu and rsig in f32 for the backward.
//
// Backward, per row: xhat = (r - mu) * rsig rebuilt from the STORED r (as the
// TPU kernel does); dyg = dy * gamma; dx = dr + rsig * (dyg - mean(dyg) -
// xhat * mean(dyg * xhat)), the gradient of both x and delta; and dgamma =
// sum(dy * xhat), dbeta = sum(dy) over every row, in f32. No value is summed
// with an atomic: a step's gradients do not vary between runs.
//
// What bounds both here: bytes. Each row is read and written once in each
// direction (forward: x, delta in, r, y out; backward: r, dr, dy in, dx out),
// a handful of operations per element, far below the card's ~300 operations
// per byte. The TPU kernel's 1024-row blocks, its (8, rows) stats layout and
// its sequential-grid dgamma/dbeta accumulator are TPU shapes. Here:
//
// K3f: one warp per row, the row held in registers: each lane owns 16-byte
// chunks (8 elements) at lane, lane + 32, ..., so a warp's load is 512
// contiguous bytes, both loads issued before the row's sums; the row's sums
// are warp shuffles.
//
// K3b keeps bytes in flight, which the row-per-warp design did not (three
// dependent latency phases a row, 0.39-0.56 of the byte bound):
//  - a persistent grid (`BWD_CTAS_PER_SM` CTAs an SM, never more than the
//    tiles) walks tiles of `tile_rows` contiguous rows, CTA b the tiles b,
//    b + grid, b + 2 grid, ...;
//  - R contiguous rows of a contiguous tensor are one contiguous span: one
//    elected producer lane copies the tile's r, dy and dr, and its mu and
//    rsig, with 1-D bulk copies (`cp.async.bulk`, `hopper::bulk_load_1d`)
//    into a ring of `stages` shared-memory stages that complete on
//    mbarriers. Every span starts and ends on 16 bytes: the row spans since
//    d is a multiple of 8, the mu / rsig spans since a tile's rows are a
//    multiple of 4; a short last tile's mu / rsig past its last 4 rows are
//    plain loads of the producer lane, stored before it arrives;
//  - 4 consumer warps compute from the staged tile in two passes over shared
//    memory (the row's sums; then dx and the dgamma / dbeta terms), with
//    gamma and the partial sums in registers. A row takes `lanes` lanes
//    (16 at d = 384, 8 at 192, 32 at 768) with `CH` <= 4 chunks each, so a
//    warp holds 32 / lanes rows and no lane idles at the models' widths; the
//    row's sums are shuffles within its lane group; dx goes out in 16-byte
//    stores;
//  - dgamma / dbeta: each thread sums its columns over its rows in walk
//    order; at the end each (warp, row slot) writes its sums into the ring,
//    free by then, and each column is summed over them in (warp, slot)
//    order, all columns at once (a fold of the warps in turn, each adding
//    into shared memory, serialised its loads and stores and cost more than
//    the rest of a short call's tail); the CTA writes one (2, d) partial,
//    and `add_ln_bwd_reduce_kernel` sums the CTAs' partials in a fixed order
//    (warp w of a summing CTA the CTAs w, w + 32, ... in turn, then the 32
//    warps in order). ops/ln_fused.py `_bwd_plan` mirrors the launch, and
//    the C entry point refuses any other.
//
// The LayerNorm alone (`dlsc_ln_fwd`, `dlsc_ln_bwd`: the ViT blocks' norms on
// the bf16 stream) is the same two kernels with the add compiled out (the
// template's ADD false): the forward reads x once and writes y once, with mu
// and rsig in f32 from the registers; the backward's stage carries x and dy
// only (no dr) and writes dx = rsig * (dy*gamma - mean(dy*gamma) - xhat *
// mean(dy*gamma*xhat)). Bytes bound it too, and more tightly: a row is 2 d
// elements in the forward (x in, y out; 654 MB, 0.196 ms at AST-Base's
// 212 992 x 768 bf16) and 3 d in the backward (x, dy in, dx out; 983 MB,
// 0.293 ms), against 4 d and 4 d with the add. So a stage's row tensors are
// 2 for 3: at the same 25 KB aim a stage holds twice the rows of a bf16 add
// stage at the models' widths (8 rows at d = 768), 4 stages a CTA: up to
// ~197 KB in flight an SM, far above the ~25-50 KB that 3.35 TB/s needs at a
// microsecond or two of latency.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;       // K3f: rows in flight per block, one per warp
constexpr int VEC = 8;         // elements per 16-byte bf16 chunk
constexpr int MAX_D = 1024;    // 32 lanes x 4 chunks x 8

// K3b's launch (ops/ln_fused.py `_bwd_plan` uses the same numbers)
constexpr int BWD_WARPS = 4;                          // consumer warps; a producer warp more
constexpr int BWD_THREADS = (BWD_WARPS + 1) * 32;
constexpr int BWD_CTAS_PER_SM = 2;
constexpr int BWD_MAX_STAGES = 4;
constexpr int BWD_STAGE_TARGET = 25 * 1024;          // bytes of a stage aimed at
constexpr int SMEM_LIMIT = 232448;                    // a block's shared memory (H100)
constexpr int BWD_SMEM_BUDGET = SMEM_LIMIT / BWD_CTAS_PER_SM - 1024;  // less the system's 1 KB
constexpr int BWD_BAR_BYTES = 16 * BWD_MAX_STAGES;   // full[], empty[] mbarriers
constexpr int REDUCE_SPLIT = 32;                      // warps of a summing CTA

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// CH: 16-byte chunks per lane, (d / 8 + 31) / 32. ADD false: the LayerNorm
// of x alone (delta and r_out unused).
template <typename T, int CH, bool ADD>
__global__ void __launch_bounds__(WARPS * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ r_out, T* __restrict__ y_out, float* __restrict__ mu_out,
                  float* __restrict__ rsig_out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp leaves together
  const size_t base = (size_t)row * d;
  const float inv_d = 1.f / (float)d;

  float v[CH][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * VEC;
    if (col < d) {
      load8(x + base + col, v[c]);
      if constexpr (ADD) {
        float b[VEC];
        load8(delta + base + col, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] += b[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[c][i];
    }
  }
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if ((lane + 32 * c) * VEC < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float t = v[c][i] - mu;
        sq += t * t;
      }
    }
  }
  const float rsig = 1.f / sqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * VEC;
    if (col < d) {
      float g[VEC], b[VEC], y[VEC];
      load8(gamma + col, g);
      load8(beta + col, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = (v[c][i] - mu) * rsig * g[i] + b[i];
      if constexpr (ADD) store8(r_out + base + col, v[c]);
      store8(y_out + base + col, y);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rsig_out[row] = rsig;
  }
}

// K3b. Shared memory: the mbarriers, then `stages` stages of [r | dy | dr]
// (tile_rows x d each) [mu | rsig] (tile_rows each), which end as the
// (warps x slots, 2 d) dgamma / dbeta sums. CH: 16-byte chunks per lane,
// ceil(d / 8 / lanes). ADD false: the LayerNorm's backward alone, no dr
// stream (dr unused, a stage [r | dy] [mu | rsig]).
template <typename T, int CH, bool ADD>
__global__ void __launch_bounds__(BWD_THREADS, BWD_CTAS_PER_SM)
add_ln_bwd_kernel(const T* __restrict__ r, const float* __restrict__ mu,
                  const float* __restrict__ rsig, const float* __restrict__ gamma,
                  const T* __restrict__ dr, const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int rows, int d, int lanes, int tile_rows,
                  int stages, int tiles) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + BWD_MAX_STAGES;
  uint8_t* ring = smem + BWD_BAR_BYTES;
  const size_t span = (size_t)tile_rows * d;   // elements of one tensor in a stage
  constexpr int STREAMS = ADD ? 3 : 2;          // row tensors in a stage
  const size_t stage_bytes = STREAMS * span * sizeof(T) + 8 * (size_t)tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], BWD_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == BWD_WARPS) {   // the producer: one lane issues every copy
    if (lane == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int s = i % stages;
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        const int row0 = t * tile_rows;
        const int n = min(tile_rows, rows - row0), n4 = n & ~3;
        uint8_t* st = ring + s * stage_bytes;
        float* smu = reinterpret_cast<float*>(st + STREAMS * span * sizeof(T));
        float* srs = smu + tile_rows;
        for (int j = n4; j < n; ++j) {   // past the tile's last whole 16 bytes of stats
          smu[j] = mu[row0 + j];
          srs[j] = rsig[row0 + j];
        }
        const uint32_t bytes = (uint32_t)((size_t)n * d * sizeof(T));
        hopper::mbar_arrive_expect_tx(&full[s], STREAMS * bytes + 8 * n4);
        const size_t off = (size_t)row0 * d;
        hopper::bulk_load_1d(st, r + off, bytes, &full[s]);
        hopper::bulk_load_1d(st + span * sizeof(T), dy + off, bytes, &full[s]);
        if constexpr (ADD)
          hopper::bulk_load_1d(st + 2 * span * sizeof(T), dr + off, bytes, &full[s]);
        if (n4 > 0) {
          hopper::bulk_load_1d(smu, mu + row0, 4 * n4, &full[s]);
          hopper::bulk_load_1d(srs, rsig + row0, 4 * n4, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: lane = slot * lanes + sub; the slot picks the row, sub the columns
  const int shift = __ffs(lanes) - 1;
  const int slot = lane >> shift, sub = lane & (lanes - 1);
  const int groups = tile_rows >> (5 - shift);   // row groups of 32 / lanes rows in a tile
  const float inv_d = 1.f / (float)d;
  float g[CH][VEC], pg[CH][VEC], pb[CH][VEC];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (sub + lanes * c) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pg[c][e] = pb[c][e] = g[c][e] = 0.f;
    if (col < d) load8(gamma + col, g[c]);
  }

  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % stages;
    hopper::mbar_wait(&full[s], (i / stages) & 1);
    const int row0 = t * tile_rows;
    const int n = min(tile_rows, rows - row0);
    const T* sr = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const T* sdy = sr + span;
    const T* sdr = sdy + span;   // ADD only
    const float* smu = reinterpret_cast<const float*>(sdy + (STREAMS - 1) * span);
    const float* srs = smu + tile_rows;
    for (int grp = warp; grp < groups; grp += BWD_WARPS) {
      const int lr = (grp << (5 - shift)) + slot;
      const bool valid = lr < n;
      const float m = valid ? smu[lr] : 0.f, rs = valid ? srs[lr] : 0.f;
      const size_t so = (size_t)lr * d;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (sub + lanes * c) * VEC;
        if (valid && col < d) {
          float rv[VEC], dyv[VEC];
          load8(sr + so + col, rv);
          load8(sdy + so + col, dyv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float dyg = dyv[e] * g[c][e];
            s1 += dyg;
            s2 += dyg * ((rv[e] - m) * rs);
          }
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1) {   // within the row's lane group
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 * inv_d, m2 = s2 * inv_d;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (sub + lanes * c) * VEC;
        if (valid && col < d) {
          float rv[VEC], dyv[VEC], drv[VEC], out[VEC];
          load8(sr + so + col, rv);
          load8(sdy + so + col, dyv);
          if constexpr (ADD) load8(sdr + so + col, drv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xh = (rv[e] - m) * rs;
            const float t = dyv[e] * g[c][e] - m1 - xh * m2;
            if constexpr (ADD)
              out[e] = drv[e] + rs * t;
            else
              out[e] = rs * t;
            pg[c][e] += dyv[e] * xh;
            pb[c][e] += dyv[e];
          }
          store8(dx + (size_t)(row0 + lr) * d + col, out);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // the CTA's partial: the ring is free once every consumer has read its last
  // stage. Each (warp, slot) writes its sums as a row of (slots, 2 d) floats,
  // then each column is summed over the rows in (warp, slot) order.
  hopper::named_barrier(1, BWD_WARPS * 32);
  float* sums = reinterpret_cast<float*>(ring);
  const int row = warp * (32 >> shift) + slot;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (sub + lanes * c) * VEC;
    if (col < d) {
      store8(sums + (size_t)row * 2 * d + col, pg[c]);
      store8(sums + (size_t)row * 2 * d + d + col, pb[c]);
    }
  }
  hopper::named_barrier(1, BWD_WARPS * 32);
  const int n_rows = BWD_WARPS * (32 >> shift);
  for (int j = threadIdx.x; j < 2 * d; j += BWD_WARPS * 32) {   // part: (2, grid, d)
    float t = sums[j];
    for (int k = 1; k < n_rows; ++k) t += sums[(size_t)k * 2 * d + j];
    part[((size_t)(j >= d) * gridDim.x + blockIdx.x) * d + (j >= d ? j - d : j)] = t;
  }
}

// dgamma (blockIdx.y 0) and dbeta (1) from the CTAs' partials, 32 columns a
// CTA: warp w sums the partials of CTAs w, w + 32, ... in turn, then warp 0
// adds the 32 warps' sums in order. Deterministic; no atomics.
__global__ void __launch_bounds__(REDUCE_SPLIT * 32)
add_ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dgamma,
                         float* __restrict__ dbeta, int d, int ctas) {
  __shared__ float acc[REDUCE_SPLIT][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const float* p = part + (size_t)blockIdx.y * ctas * d;
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int b = warp; b < ctas; b += REDUCE_SPLIT) s += p[(size_t)b * d + j];
  }
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < d) {
    float t = acc[0][lane];
#pragma unroll
    for (int w = 1; w < REDUCE_SPLIT; ++w) t += acc[w][lane];
    (blockIdx.y == 0 ? dgamma : dbeta)[j] = t;
  }
}

// K3b's launch, from the shape and the SM count alone (ops/ln_fused.py
// `_bwd_plan` is the same). streams: the row tensors a stage carries, 3 with
// the add (r, dy, dr) and 2 without (x, dy).
struct BwdPlan {
  int lanes, chunks, tile_rows, stages, smem, tiles, grid;
};

BwdPlan bwd_plan(int rows, int d, int elem, int sms, int streams) {
  BwdPlan p;
  const int row_chunks = d / VEC;
  p.lanes = 1;
  while (p.lanes * 4 < row_chunks) p.lanes *= 2;   // the fewest lanes with <= 4 chunks each
  p.chunks = (row_chunks + p.lanes - 1) / p.lanes;
  const int base = BWD_WARPS * (32 / p.lanes);     // a row for every slot of every warp
  const int base_bytes = streams * base * d * elem + 8 * base;
  const int k = BWD_STAGE_TARGET / base_bytes > 1 ? BWD_STAGE_TARGET / base_bytes : 1;
  p.tile_rows = base * k;
  const int stage_bytes = base_bytes * k;
  const int fit = (BWD_SMEM_BUDGET - BWD_BAR_BYTES) / stage_bytes;
  p.stages = fit < BWD_MAX_STAGES ? fit : BWD_MAX_STAGES;
  p.smem = BWD_BAR_BYTES + p.stages * stage_bytes;
  p.tiles = (rows + p.tile_rows - 1) / p.tile_rows;
  p.grid = sms * BWD_CTAS_PER_SM < p.tiles ? sms * BWD_CTAS_PER_SM : p.tiles;
  return p;
}

template <typename T, bool ADD>
cudaError_t launch_fwd(const void* x, const void* delta, const float* gamma,
                       const float* beta, void* r, void* y, float* mu, float* rsig, int rows,
                       int d, float eps, cudaStream_t st) {
  const dim3 grid((rows + WARPS - 1) / WARPS);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  T* rt = static_cast<T*>(r);
  T* yt = static_cast<T*>(y);
  switch ((d / VEC + 31) / 32) {
    case 1: add_ln_fwd_kernel<T, 1, ADD><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 2: add_ln_fwd_kernel<T, 2, ADD><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 3: add_ln_fwd_kernel<T, 3, ADD><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 4: add_ln_fwd_kernel<T, 4, ADD><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int CH, bool ADD>
cudaError_t launch_bwd_ch(const BwdPlan& p, const void* r, const float* mu, const float* rsig,
                          const float* gamma, const void* dr, const void* dy, void* dx,
                          float* part, int rows, int d, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      add_ln_bwd_kernel<T, CH, ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  add_ln_bwd_kernel<T, CH, ADD><<<p.grid, BWD_THREADS, p.smem, st>>>(
      static_cast<const T*>(r), mu, rsig, gamma, static_cast<const T*>(dr),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d, p.lanes, p.tile_rows,
      p.stages, p.tiles);
  return cudaGetLastError();
}

template <typename T, bool ADD>
cudaError_t launch_bwd(const BwdPlan& p, const void* r, const float* mu, const float* rsig,
                       const float* gamma, const void* dr, const void* dy, void* dx,
                       float* part, int rows, int d, cudaStream_t st) {
  switch (p.chunks) {
    case 1: return launch_bwd_ch<T, 1, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, part, rows, d, st);
    case 2: return launch_bwd_ch<T, 2, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, part, rows, d, st);
    case 3: return launch_bwd_ch<T, 3, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, part, rows, d, st);
    case 4: return launch_bwd_ch<T, 4, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, part, rows, d, st);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int rows, int d) {
  return rows < 1 || d < VEC || d > MAX_D || d % VEC != 0;
}

template <bool ADD>
int fwd(const void* x, const void* delta, const float* gamma, const float* beta, void* r,
        void* y, float* mu, float* rsig, int rows, int d, float eps, int dtype, void* stream) {
  if (bad_shape(rows, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<__nv_bfloat16, ADD>(x, delta, gamma, beta, r, y, mu, rsig, rows, d, eps, st);
  if (dtype == 1)
    return launch_fwd<float, ADD>(x, delta, gamma, beta, r, y, mu, rsig, rows, d, eps, st);
  return cudaErrorInvalidValue;
}

template <bool ADD>
int bwd(const void* r, const float* mu, const float* rsig, const float* gamma, const void* dr,
        const void* dy, void* dx, float* dgamma, float* dbeta, float* workspace, int rows,
        int d, int dtype, int grid, int threads, int smem, int stages, int tile_rows,
        void* stream) {
  if (bad_shape(rows, d) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const BwdPlan p = bwd_plan(rows, d, dtype == 0 ? 2 : 4, sms, ADD ? 3 : 2);
  if (grid != p.grid || threads != BWD_THREADS || smem != p.smem || stages != p.stages ||
      tile_rows != p.tile_rows)
    return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
      ? launch_bwd<__nv_bfloat16, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, workspace, rows, d, st)
      : launch_bwd<float, ADD>(p, r, mu, rsig, gamma, dr, dy, dx, workspace, rows, d, st);
  if (err != cudaSuccess) return err;
  add_ln_bwd_reduce_kernel<<<dim3((d + 31) / 32, 2), REDUCE_SPLIT * 32, 0, st>>>(
      workspace, dgamma, dbeta, d, p.grid);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bfloat16, 1 = float32. x, delta, r, y: (rows, d); gamma, beta:
// (d,) f32; mu, rsig: (rows,) f32.
extern "C" int dlsc_add_ln_fwd(const void* x, const void* delta, const float* gamma,
                               const float* beta, void* r, void* y, float* mu, float* rsig,
                               int rows, int d, float eps, int dtype, void* stream) {
  return fwd<true>(x, delta, gamma, beta, r, y, mu, rsig, rows, d, eps, dtype, stream);
}

// The LayerNorm of x alone: y, mu, rsig as `dlsc_add_ln_fwd` with no delta and no r.
extern "C" int dlsc_ln_fwd(const void* x, const float* gamma, const float* beta, void* y,
                           float* mu, float* rsig, int rows, int d, float eps, int dtype,
                           void* stream) {
  return fwd<false>(x, nullptr, gamma, beta, nullptr, y, mu, rsig, rows, d, eps, dtype, stream);
}

// r, dr, dy, dx: (rows, d); mu, rsig: (rows,) f32; gamma, dgamma, dbeta: (d,)
// f32; workspace: (2, grid, d) f32, the CTAs' partials. `grid`, `threads`,
// `smem`, `stages` and `tile_rows` are the wrapper's `_bwd_plan`, and the
// launch is refused unless they are this kernel's own. Two kernels run: the
// rows, then the sum of the partials.
extern "C" int dlsc_add_ln_bwd(const void* r, const float* mu, const float* rsig,
                               const float* gamma, const void* dr, const void* dy, void* dx,
                               float* dgamma, float* dbeta, float* workspace, int rows, int d,
                               int dtype, int grid, int threads, int smem, int stages,
                               int tile_rows, void* stream) {
  return bwd<true>(r, mu, rsig, gamma, dr, dy, dx, dgamma, dbeta, workspace, rows, d, dtype,
                   grid, threads, smem, stages, tile_rows, stream);
}

// The LayerNorm's backward alone: `dlsc_add_ln_bwd` from the input x with no
// dr, dx = rsig (dy gamma - mean(dy gamma) - xhat mean(dy gamma xhat)); the
// plan is `_bwd_plan(..., add=False)`.
extern "C" int dlsc_ln_bwd(const void* x, const float* mu, const float* rsig,
                           const float* gamma, const void* dy, void* dx, float* dgamma,
                           float* dbeta, float* workspace, int rows, int d, int dtype, int grid,
                           int threads, int smem, int stages, int tile_rows, void* stream) {
  return bwd<false>(x, mu, rsig, gamma, nullptr, dy, dx, dgamma, dbeta, workspace, rows, d,
                    dtype, grid, threads, smem, stages, tile_rows, stream);
}
