// K2 (forward): masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlsc_tpu/ops/attn_fast.py `make_fast_mha` ->
// `fwd_kernel`. For each (batch, head): S = q k^T with q pre-scaled by the
// caller, keys at positions >= n_real masked, P = softmax(S), O = P v, and
// lse = log(sum(exp(S))) (natural log) for the backward to come.
// Layout (B, H, N, 64) contiguous; lse (B, H, N) f32.
//
// What bounds it here: at AST-Base (N 1664, dh 64) the products are
// 4 N^2 dh = 0.7 GFLOP per head against 0.6 MB of q/k/v/o, so the kernel is
// bound by the tensor cores and by the softmax's exponentials, not by
// memory. The TPU kernel keeps a whole K and V row on chip and does one flat
// softmax; here K and V of one head (213 KB each in bf16) do not fit a
// block's 227 KB of shared memory, so:
//  - one block (4 warps) per (batch x head, 64 query rows); each warp keeps
//    its 16 query rows as mma.sync A fragments in registers;
//  - K and V stream through shared memory in 64-key tiles (V stored
//    transposed so that its B fragments are single 32-bit loads), with an
//    online softmax in f32 (running max, running sum, rescaled accumulator);
//  - S and O accumulate in f32 from bf16 mma.sync.m16n8k16 products, and P
//    is packed to bf16 straight from the S accumulators into A fragments;
//  - n_real is the static boundary: tiles entirely at or past it are never
//    loaded, and only the one tile that straddles it is masked.
// A float32 path (scalar FMA, one thread per query row, 32-key tiles) serves
// the tight-tolerance parity checks. wgmma, TMA and warp specialisation are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int BQ = 64;          // query rows per block, both paths
constexpr int BKV = 64;         // keys per tile, bf16 path
constexpr int KSTR = DH + 8;    // row stride (bf16) of the K tile in shared memory
constexpr int VSTR = BKV + 8;   // row stride (bf16) of the transposed V tile
constexpr int BKV32 = 32;       // keys per tile, f32 path

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

__global__ void __launch_bounds__(128)
attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int N, int n_real) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[DH * VSTR];

  const size_t base = (size_t)blockIdx.y * N * DH;
  const __nv_bfloat16* Q = q + base;
  const __nv_bfloat16* K = k + base;
  const __nv_bfloat16* V = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;

  // A fragments of this warp's 16 query rows, 4 steps of 16 along dh.
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = r0 < N ? ld32(Q + (size_t)r0 * DH + c) : 0u;
    qa[ks][1] = r1 < N ? ld32(Q + (size_t)r1 * DH + c) : 0u;
    qa[ks][2] = r0 < N ? ld32(Q + (size_t)r0 * DH + c + 8) : 0u;
    qa[ks][3] = r1 < N ? ld32(Q + (size_t)r1 * DH + c + 8) : 0u;
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (n_real + BKV - 1) / BKV;  // tiles past n_real are skipped
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();
    for (int c = threadIdx.x; c < BKV * DH / 8; c += blockDim.x) {
      const int row = c / (DH / 8), col = (c % (DH / 8)) * 8;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kv0 + row < N) {
        kk = *reinterpret_cast<const uint4*>(K + (size_t)(kv0 + row) * DH + col);
        vv = *reinterpret_cast<const uint4*>(V + (size_t)(kv0 + row) * DH + col);
      }
      *reinterpret_cast<uint4*>(Ks + row * KSTR + col) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(col + e) * VSTR + row] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 key groups of 8.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * KSTR + ks * 16 + 2 * t;
        const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16_16816(s[nt], qa[ks], b);
      }
    }
    if (kv0 + BKV > n_real) {  // the boundary tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + nt * 8 + 2 * t + (e & 1) >= n_real) s[nt][e] = -INFINITY;
    }

    // Online softmax. Each tile holds at least one unmasked key per row,
    // so the running max is finite from the first tile on.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    // l stays a per-thread partial sum until the end: all four threads of a
    // row group rescale by the same factor.
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }

    // O += P V: P's A fragments come straight from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vr = Vt + (nt * 8 + g) * VSTR + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16_16816(o[nt], a, b);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* O = out + base;
  float* Lse = lse + (size_t)blockIdx.y * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(O + (size_t)r0 * DH + c) =
          pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(O + (size_t)r1 * DH + c) =
          pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
  }
  if (t == 0) {
    if (r0 < N) Lse[r0] = m0 + logf(l0);
    if (r1 < N) Lse[r1] = m1 + logf(l1);
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
extern "C" int dlsc_attn_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int BH, int N, int head_dim, int n_real,
                             int dtype, void* stream) {
  if (head_dim != DH || BH <= 0 || BH > 65535 || n_real < 1 || n_real > N)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BQ - 1) / BQ, BH);
  if (dtype == 0) {
    attn_fwd_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, N,
        n_real);
  } else if (dtype == 1) {
    attn_fwd_f32_kernel<<<grid, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, N, n_real);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
