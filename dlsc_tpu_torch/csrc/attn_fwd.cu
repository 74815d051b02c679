// K2 (forward): masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlsc_tpu/ops/attn_fast.py `make_fast_mha` ->
// `fwd_kernel`. For each (batch, head): S = q k^T with q pre-scaled by the
// caller, keys at positions >= n_real masked, P = softmax(S), O = P v, and
// lse = log(sum(exp(S))) (natural log) for the backward to come.
// Layout (B, H, N, 64) contiguous; lse (B, H, N) f32.
//
// What bounds it here: at AST-Base (N 1664, dh 64) the products are
// 4 N^2 dh = 0.7 GFLOP per head against 0.6 MB of q/k/v/o, so the tensor
// cores (and the softmax's exponentials beside them) bound it, not memory.
// The TPU kernel keeps a whole K and V row on chip and does one flat
// softmax; K and V of one head (213 KB each in bf16) do not fit a block's
// 227 KB of shared memory beside a ring, so they stream, with an online
// softmax.
//
// bf16 design (hopper.cuh, as K2b's dQ kernel in attn_bwd.cu): a CTA owns
// (batch x head, 128 queries) and runs 2 consumer warpgroups of 64 query
// rows and one producer warp. The producer's one thread loads the CTA's Q
// tile once, then streams K and V in 64-key tiles through a ring of STAGES
// slots by TMA (128-byte-swizzled, 3-D tensor maps (B*H, N, 64) so that keys
// past N read as zeros, never as the next head's), each slot a "full"
// mbarrier (bytes arrived) and an "empty" one (both warpgroups done with it).
// Per key tile j each consumer warpgroup
//  - computes S_j = Q K_j^T by SS wgmma m64n64k16 (both operands K-major);
//  - runs the online softmax in f32 registers: the row max over the lane
//    quad, p = exp(S - max) in the TPU kernel's order (the difference
//    first, then one multiply by log2(e) and one ex2), the running sum, and
//    O rescaled when the max moves;
//  - packs P_j to bf16 into register A fragments (`acc_to_a`), where the
//    TPU kernel rounds it, and accumulates O += P_j V_j by RS wgmma, V read
//    MN-major through the transpose bit from the same tile (no transposed
//    copy).
// The products overlap the softmax, as FlashAttention-3 does: inside a
// warpgroup, S_j and O += P_{j-1} V_{j-1} are issued together, and the
// softmax of S_j runs while the second one does (one S accumulator
// suffices: P_{j-1} already lives in the A fragments); between the two
// warpgroups, named barriers make them issue their products in turns
// ("ping-pong"). A slot goes back to the producer when the product that
// reads its V is done.
// n_real is the static boundary: key tiles whose first key is >= n_real are
// never loaded, and only the one tile that straddles it is masked. A 64-row
// Q box that lies wholly past N is not loaded; its rows compute on whatever
// the slot holds and are never stored. The epilogue stores O / l in bf16 and
// lse = m + ln l from registers, rows >= N skipped. The tile sizes,
// grid and shared-memory bytes are those of `_fwd_plan` in ops/attn_fast.py,
// which the wrapper checks before launch. A float32 path (scalar FMA, one
// thread per query row, 32-key tiles) serves the tight-tolerance parity
// checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;
// bf16 path: the numbers of `_fwd_plan` (ops/attn_fast.py)
constexpr int TILE = 64;       // rows of one TMA box, of one warpgroup's slice, of a key tile
constexpr int BLOCK = 128;     // query rows a CTA owns: 2 consumer warpgroups
constexpr int STAGES = 4;      // slots in the ring of K/V tiles
constexpr int CONSUMERS = 256; // threads of the 2 consumer warpgroups; then 1 producer warp
constexpr int THREADS = CONSUMERS + 32;
constexpr int TILE_BYTES = TILE * DH * 2;
constexpr int FWD_SMEM = 1024 + BLOCK * DH * 2 + STAGES * 2 * TILE_BYTES + (1 + 2 * STAGES) * 8;
constexpr float LOG2E = 1.4426950408889634f;
// f32 path
constexpr int BQ = 64;          // query rows per block (one thread each)
constexpr int BKV32 = 32;       // keys per tile

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int N, int n_real) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(hopper::align1024(smem_raw));  // BLOCK x 64
  __nv_bfloat16* Ks = Qs + BLOCK * DH;                          // STAGES x (TILE x 64)
  __nv_bfloat16* Vs = Ks + STAGES * TILE * DH;                  // STAGES x (TILE x 64)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE * DH);
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
      hopper::mbar_arrive_expect_tx(bar_q, boxes * TILE_BYTES);
      for (int h = 0; h < boxes; ++h)
        hopper::tma_load_3d(Qs + h * TILE * DH, &tm_q, bar_q, 0, q0 + h * TILE, bh);
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
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const uint64_t q_desc = hopper::desc_kmajor(Qs + wg * TILE * DH);
  // accumulator entries i with (i & 2) == 0 lie on this thread's row r (the
  // suffix a below), the others on r + 8 (b); see the epilogue
  float o[32], S[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = S[i] = 0.f;
  uint32_t P[4][4];  // the last tile's probabilities, bf16 A fragments of O += P V
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;  // running max, partial sums
  float alpha_a, alpha_b;

  // S = Q K^T (64 queries x 64 keys) of the tile in slot s, issued and committed
  auto issue_s = [&](int s) {
    const uint64_t k_desc = hopper::desc_kmajor(Ks + s * TILE * DH);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_m64n64k16_ss<0, 0>(S, q_desc + 2 * k, k_desc + 2 * k, k);
    hopper::wgmma_commit();
  };
  // O += P V with the tile in slot s, V read MN-major, issued and committed
  auto issue_pv = [&](int s) {
    const uint64_t v_desc = hopper::desc_mnmajor(Vs + s * TILE * DH);
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_rs<1>(o, P[k], v_desc + 128 * k);
    hopper::wgmma_commit();
  };
  // the online softmax of tile j's S, in place; keys >= n_real masked.
  // p = 2^((S - max) log2(e)): the difference is rounded as the TPU kernel's
  // exp(s - m) rounds it, before the scale (a scale folded into one FFMA
  // with the max would round |max| log2(e) instead, an error that grows
  // with the max). Every tile holds at least one key < n_real, so the
  // running max is finite from the first tile on. Sets alpha, the factor by
  // which O (and l) at the old max are rescaled to the new one.
  auto softmax = [&](int j) {
    const int kv0 = j * TILE;
    if (kv0 + TILE > n_real) {  // the tile that straddles n_real
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + (i / 4) * 8 + 2 * t + (i & 1) >= n_real) S[i] = -INFINITY;
    }
    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) xb = fmaxf(xb, S[i]);
      else xa = fmaxf(xa, S[i]);
    }
    xa = fmaxf(ma, quad_max(xa));
    xb = fmaxf(mb, quad_max(xb));
    alpha_a = hopper::exp2_ftz((ma - xa) * LOG2E);
    alpha_b = hopper::exp2_ftz((mb - xb) * LOG2E);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = hopper::exp2_ftz((S[i] - (i & 2 ? xb : xa)) * LOG2E);
      S[i] = p;
      if (i & 2) sb += p;
      else sa += p;
    }
    // l stays a per-thread partial sum until the end: the four threads of a
    // row rescale by the same factor
    la = la * alpha_a + sa;
    lb = lb * alpha_b + sb;
    ma = xa;
    mb = xb;
  };

  // Ping-pong: the two warpgroups issue their products in turns (named
  // barriers 1 and 2, 256 threads: one side waits, the other arrives), so
  // that one's products run while the other's softmax does. Each issues
  // n_tiles + 1 times; warpgroup 0 waits for warpgroup 1 from its second
  // turn on, warpgroup 1 for warpgroup 0 at every turn.
  int turn = 0;
  auto my_turn = [&]() {
    if (wg == 1 || turn > 0) hopper::named_barrier(1 + wg, 256);
  };
  auto your_turn = [&]() {
    if (wg == 0 || turn < n_tiles) hopper::named_barrier_arrive(2 - wg, 256);
    ++turn;
  };

  hopper::mbar_wait(bar_q, 0);
  hopper::mbar_wait(&full[0], 0);
  hopper::fence_regs(S);
  my_turn();
  hopper::wgmma_fence();
  issue_s(0);
  your_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(S);
  softmax(0);
  hopper::acc_to_a(S, P);
  // Tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} go out together; the
  // softmax of S_j runs while the second product does.
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    hopper::fence_regs(S);
    hopper::fence_regs(o);
    my_turn();
    hopper::wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    your_turn();
    hopper::wgmma_wait<1>();  // S_j is done (groups complete in order)
    hopper::fence_regs(S);
    softmax(j);
    hopper::wgmma_wait<0>();  // O += P_{j-1} V_{j-1} is done: P, O and slot sp are free
    hopper::fence_regs(o);
    hopper::fence_regs(P);
    if (tid == 0) hopper::mbar_arrive(&empty[sp]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= i & 2 ? alpha_b : alpha_a;
    hopper::acc_to_a(S, P);
  }
  hopper::fence_regs(o);
  my_turn();
  hopper::wgmma_fence();
  issue_pv((n_tiles - 1) % STAGES);
  your_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);

  la = quad_sum(la);
  lb = quad_sum(lb);
  const float inv_a = 1.f / la, inv_b = 1.f / lb;
  const int r = q0 + wg * TILE + warp * 16 + lane / 4;  // rows r and r + 8
  __nv_bfloat16* O = out + ((size_t)bh * N + r) * DH;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = jj * 8 + 2 * t;
    if (r < N)
      *reinterpret_cast<uint32_t*>(O + c) =
          hopper::pack_bf16(o[4 * jj] * inv_a, o[4 * jj + 1] * inv_a);
    if (r + 8 < N)
      *reinterpret_cast<uint32_t*>(O + 8 * DH + c) =
          hopper::pack_bf16(o[4 * jj + 2] * inv_b, o[4 * jj + 3] * inv_b);
  }
  if (t == 0) {
    float* L = lse + (size_t)bh * N;
    if (r < N) L[r] = ma + logf(la);
    if (r + 8 < N) L[r + 8] = mb + logf(lb);
  }
}

__global__ void __launch_bounds__(BQ)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int N, int n_real) {
  __shared__ __align__(16) float Ks[BKV32 * DH];
  __shared__ __align__(16) float Vs[BKV32 * DH];
  __shared__ float Ss[BKV32 * BQ];  // this tile's scores, [key][row]

  const size_t base = (size_t)blockIdx.y * N * DH;
  const float* K = k + base;
  const float* V = v + base;
  const int tid = threadIdx.x;
  const int r = blockIdx.x * BQ + tid;

  float4 qr[DH / 4], o[DH / 4];
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    qr[d] = r < N ? reinterpret_cast<const float4*>(q + base + (size_t)r * DH)[d]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    o[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (n_real + BKV32 - 1) / BKV32;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV32;
    __syncthreads();
    for (int c = tid; c < BKV32 * DH / 4; c += BQ) {
      const int row = c / (DH / 4);
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kv0 + row < N) {
        kk = reinterpret_cast<const float4*>(K + (size_t)kv0 * DH)[c];
        vv = reinterpret_cast<const float4*>(V + (size_t)kv0 * DH)[c];
      }
      reinterpret_cast<float4*>(Ks)[c] = kk;
      reinterpret_cast<float4*>(Vs)[c] = vv;
    }
    __syncthreads();
    float mx = m;
    for (int jj = 0; jj < BKV32; ++jj) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + jj * DH);
      float sj = 0.f;
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        const float4 kv = kr[d];
        sj = fmaf(qr[d].x, kv.x, sj);
        sj = fmaf(qr[d].y, kv.y, sj);
        sj = fmaf(qr[d].z, kv.z, sj);
        sj = fmaf(qr[d].w, kv.w, sj);
      }
      if (kv0 + jj >= n_real) sj = -INFINITY;
      Ss[jj * BQ + tid] = sj;
      mx = fmaxf(mx, sj);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH / 4; ++d) {
      o[d].x *= alpha;
      o[d].y *= alpha;
      o[d].z *= alpha;
      o[d].w *= alpha;
    }
    for (int jj = 0; jj < BKV32; ++jj) {
      const float p = expf(Ss[jj * BQ + tid] - mx);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + jj * DH);
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        const float4 vv = vr[d];
        o[d].x = fmaf(p, vv.x, o[d].x);
        o[d].y = fmaf(p, vv.y, o[d].y);
        o[d].z = fmaf(p, vv.z, o[d].z);
        o[d].w = fmaf(p, vv.w, o[d].w);
      }
    }
    m = mx;
  }

  if (r < N) {
    const float inv = 1.f / l;
    float4* orow = reinterpret_cast<float4*>(out + base + (size_t)r * DH);
#pragma unroll
    for (int d = 0; d < DH / 4; ++d)
      orow[d] = make_float4(o[d].x * inv, o[d].y * inv, o[d].z * inv, o[d].w * inv);
    lse[(size_t)blockIdx.y * N + r] = m + logf(l);
  }
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bfloat16, 1 = float32. q, k, v, out: (BH, N, 64); lse: (BH, N).
// bf16: the tensor maps are built here, per call (16-byte aligned,
// contiguous operands: the wrapper checks).
extern "C" int dlsc_attn_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int BH, int N, int head_dim, int n_real,
                             int dtype, void* stream) {
  if (head_dim != DH || BH <= 0 || BH > 65535 || n_real < 1 || n_real > N)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    CUtensorMap tm_q, tm_k, tm_v;
    const uint64_t dims[3] = {DH, static_cast<uint64_t>(N), static_cast<uint64_t>(BH)};
    const uint64_t strides[2] = {DH * 2, static_cast<uint64_t>(N) * DH * 2};
    const uint32_t box[3] = {DH, TILE, 1};
    const void* tiles[3] = {q, k, v};
    CUtensorMap* maps[3] = {&tm_q, &tm_k, &tm_v};
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = hopper::make_tensor_map(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, tiles[i], dims,
                                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_fwd_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BLOCK - 1) / BLOCK, BH);
    attn_fwd_bf16_kernel<<<grid, THREADS, FWD_SMEM, st>>>(
        tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, N, n_real);
  } else if (dtype == 1) {
    const dim3 grid((N + BQ - 1) / BQ, BH);
    attn_fwd_f32_kernel<<<grid, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, N, n_real);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
