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
// xhat * mean(dyg * xhat)), the gradient of both x and delta; and per-block
// f32 partial sums of dgamma = sum(dy * xhat) and dbeta = sum(dy) over the
// block's rows, which the wrapper reduces with one torch.sum. No atomics: a
// step's gradients do not vary between runs.
//
// What bounds it here: bytes. Each row is read and written once in each
// direction (forward: x, delta in, r, y out; backward: r, dr, dy in, dx out),
// a handful of operations per element, far below the card's ~300 operations
// per byte. The TPU kernel's 1024-row blocks, its (8, rows) stats layout and
// its sequential-grid dgamma/dbeta accumulator are TPU shapes; here:
//  - one warp per row, the row held in registers: each lane owns 16-byte
//    chunks (8 elements) at lane, lane + 32, ..., so a warp's load is 512
//    contiguous bytes; the chunk count per lane (1 to 4, d <= 1024) is a
//    template parameter, so the row's registers are sized to d;
//  - the row's sums are warp shuffles, no shared memory in the forward;
//  - the backward's blocks walk a fixed, shape-derived set of rows (8 warps,
//    rows strided by the grid), keep dgamma/dbeta partials in registers, and
//    fold the 8 warps in a fixed order through shared memory at the end.
// Vectorised TMA loads and a persistent grid are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;       // rows in flight per block, one per warp
constexpr int VEC = 8;         // elements per 16-byte bf16 chunk
constexpr int MAX_D = 1024;    // 32 lanes x 4 chunks x 8

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

// CH: 16-byte chunks per lane, (d / 8 + 31) / 32.
template <typename T, int CH>
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
      float a[VEC], b[VEC];
      load8(x + base + col, a);
      load8(delta + base + col, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] = a[i] + b[i];
        sum += v[c][i];
      }
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
      store8(r_out + base + col, v[c]);
      store8(y_out + base + col, y);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rsig_out[row] = rsig;
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(WARPS * 32)
add_ln_bwd_kernel(const T* __restrict__ r, const float* __restrict__ mu,
                  const float* __restrict__ rsig, const float* __restrict__ gamma,
                  const T* __restrict__ dr, const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                  int rows, int d) {
  __shared__ float s_dg[MAX_D];
  __shared__ float s_db[MAX_D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.f / (float)d;

  float g[CH][VEC], pg[CH][VEC], pb[CH][VEC];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pg[c][i] = pb[c][i] = g[c][i] = 0.f;
    if (col < d) load8(gamma + col, g[c]);
  }

  for (int row = blockIdx.x * WARPS + warp; row < rows; row += gridDim.x * WARPS) {
    const size_t base = (size_t)row * d;
    const float m = mu[row], rs = rsig[row];
    float xh[CH][VEC], dyg[CH][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (lane + 32 * c) * VEC;
      if (col < d) {
        float rv[VEC], dyv[VEC];
        load8(r + base + col, rv);
        load8(dy + base + col, dyv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xh[c][i] = (rv[i] - m) * rs;
          dyg[c][i] = dyv[i] * g[c][i];
          s1 += dyg[c][i];
          s2 += dyg[c][i] * xh[c][i];
          pg[c][i] += dyv[i] * xh[c][i];
          pb[c][i] += dyv[i];
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (lane + 32 * c) * VEC;
      if (col < d) {
        float drv[VEC], out[VEC];
        load8(dr + base + col, drv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out[i] = drv[i] + rs * (dyg[c][i] - m1 - xh[c][i] * m2);
        store8(dx + base + col, out);
      }
    }
  }

  // fold the warps' partials in a fixed order: warp 0 stores, 1..7 add
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (lane + 32 * c) * VEC;
        if (col < d) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            s_dg[col + i] = (w == 0 ? 0.f : s_dg[col + i]) + pg[c][i];
            s_db[col + i] = (w == 0 ? 0.f : s_db[col + i]) + pb[c][i];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < d; j += WARPS * 32) {
    dgamma_part[(size_t)blockIdx.x * d + j] = s_dg[j];
    dbeta_part[(size_t)blockIdx.x * d + j] = s_db[j];
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* delta, const float* gamma,
                       const float* beta, void* r, void* y, float* mu, float* rsig, int rows,
                       int d, float eps, cudaStream_t st) {
  const dim3 grid((rows + WARPS - 1) / WARPS);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  T* rt = static_cast<T*>(r);
  T* yt = static_cast<T*>(y);
  switch ((d / VEC + 31) / 32) {
    case 1: add_ln_fwd_kernel<T, 1><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 2: add_ln_fwd_kernel<T, 2><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 3: add_ln_fwd_kernel<T, 3><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    case 4: add_ln_fwd_kernel<T, 4><<<grid, WARPS * 32, 0, st>>>(xt, dt, gamma, beta, rt, yt, mu, rsig, rows, d, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* r, const float* mu, const float* rsig, const float* gamma,
                       const void* dr, const void* dy, void* dx, float* dgp, float* dbp,
                       int rows, int d, int n_blocks, cudaStream_t st) {
  const T* rt = static_cast<const T*>(r);
  const T* drt = static_cast<const T*>(dr);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  switch ((d / VEC + 31) / 32) {
    case 1: add_ln_bwd_kernel<T, 1><<<n_blocks, WARPS * 32, 0, st>>>(rt, mu, rsig, gamma, drt, dyt, dxt, dgp, dbp, rows, d); break;
    case 2: add_ln_bwd_kernel<T, 2><<<n_blocks, WARPS * 32, 0, st>>>(rt, mu, rsig, gamma, drt, dyt, dxt, dgp, dbp, rows, d); break;
    case 3: add_ln_bwd_kernel<T, 3><<<n_blocks, WARPS * 32, 0, st>>>(rt, mu, rsig, gamma, drt, dyt, dxt, dgp, dbp, rows, d); break;
    case 4: add_ln_bwd_kernel<T, 4><<<n_blocks, WARPS * 32, 0, st>>>(rt, mu, rsig, gamma, drt, dyt, dxt, dgp, dbp, rows, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool bad_shape(int rows, int d) {
  return rows < 1 || d < VEC || d > MAX_D || d % VEC != 0;
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
  if (bad_shape(rows, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<__nv_bfloat16>(x, delta, gamma, beta, r, y, mu, rsig, rows, d, eps, st);
  if (dtype == 1)
    return launch_fwd<float>(x, delta, gamma, beta, r, y, mu, rsig, rows, d, eps, st);
  return cudaErrorInvalidValue;
}

// r, dr, dy, dx: (rows, d); mu, rsig: (rows,) f32; gamma (d,) f32;
// dgamma_part, dbeta_part: (n_blocks, d) f32, one row per block.
extern "C" int dlsc_add_ln_bwd(const void* r, const float* mu, const float* rsig,
                               const float* gamma, const void* dr, const void* dy, void* dx,
                               float* dgamma_part, float* dbeta_part, int rows, int d,
                               int n_blocks, int dtype, void* stream) {
  if (bad_shape(rows, d) || n_blocks < 1 || n_blocks > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(r, mu, rsig, gamma, dr, dy, dx, dgamma_part, dbeta_part,
                                     rows, d, n_blocks, st);
  if (dtype == 1)
    return launch_bwd<float>(r, mu, rsig, gamma, dr, dy, dx, dgamma_part, dbeta_part, rows, d,
                             n_blocks, st);
  return cudaErrorInvalidValue;
}
