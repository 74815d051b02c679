// Dropout's keep bits from a counter-based generator (Philox4x32-10), for
// Hopper (sm_90a): one pass that computes each element's Philox word and
// either writes the keep mask or applies it (x / keep where kept, else 0).
//
// Replaces no TPU kernel. The JAX package draws its dropout masks with
// jax.random (threefry, counter-based), which XLA fuses into the dropout's
// elementwise op. The port's plain version (ops/dropout_draw.py) computes the
// same words in int64 tensor arithmetic, exact on every device but about a
// hundred elementwise passes an element; this kernel computes them in
// registers. Its output is bit-equal to the plain version's.
//
// The stream. An element's bits are a function of (seed, block, site, g):
//  - the key is the 64-bit seed (a step's, or a trial's under the vmapped
//    HPO step): k0 = its low word, k1 = its high word;
//  - the counter is (q_lo, q_hi, block, site), q = g >> 2, where g is the
//    element's flat index in the UNSPLIT tensor (the global batch, all heads,
//    all hidden units, all experts); the element takes word g & 3 of that
//    Philox block.
// A rank, a microbatch, a head group, a unit slice or an expert slice thus
// computes only its own elements, and gets the bits the one-process step
// gets. keep iff word < floor(keep * 2^32), keep the f32 keep probability.
//
// Geometry of a call: x is (trials, rows, cols), contiguous, the last dim the
// unsplit tensor's last dim (stride 1 there). Row r of a trial starts at
// counter base + sum_d idx_d(r) * stride_d over its leading dims (the local
// sizes `size`, the unsplit strides `stride`), or base + row_ids[r] *
// stride_0 when a row index is given (the ragged MoE's sorted rows). A
// thread takes one Philox block of one row: the up-to-4 elements of the row
// whose g shares q, so each word is computed once.
//
// What bounds it: operations. Ten Philox rounds (two 32-bit multiply-highs
// and a handful of xors and adds each) serve four elements, against 4-8
// bytes read and written an element; the card's integer rate, not its
// memory, sets the time at the models' widths.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAD = 6;      // leading dims of one trial
constexpr int MAX_TRIALS = 64;   // seeds passed by value a launch
constexpr int THREADS = 256;

struct Geometry {
  int nlead;
  long long size[MAX_LEAD];    // local sizes of the leading dims
  long long stride[MAX_LEAD];  // their strides in the unsplit tensor
  long long base;              // counter of the trial's first element
  long long rows;              // rows of one trial: prod(size)
  long long cols;              // elements a row
  long long slots;             // Philox blocks a row can touch: cols / 4 + 2
};

struct Keys {
  unsigned long long seed[MAX_TRIALS];
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c[0], hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2], hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }

// APPLY: out = x / keep where kept, else 0, in x's type; else mask = kept.
template <typename T, bool APPLY>
__global__ void __launch_bounds__(THREADS) dropout_draw_kernel(
    const T* __restrict__ x, T* __restrict__ out, unsigned char* __restrict__ mask,
    const Geometry g, const Keys keys, const float* __restrict__ keep_ptr, float keep_val,
    int keep_stride, const long long* __restrict__ row_ids, uint32_t block, uint32_t site,
    long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const long long r = i / g.slots;            // row over the launch's trials
    const long long slot = i - r * g.slots;
    const int trial = (int)(r / g.rows);
    long long rowbase = g.base;
    if (row_ids != nullptr) {
      rowbase += row_ids[r] * g.stride[0];
    } else {
      long long rem = r - (long long)trial * g.rows;
      for (int d = g.nlead - 1; d >= 0; --d) {
        const long long idx = rem % g.size[d];
        rem /= g.size[d];
        rowbase += idx * g.stride[d];
      }
    }
    const long long q = (rowbase >> 2) + slot;
    const long long first = q * 4 - rowbase;    // the row column of word 0
    if (first >= g.cols) continue;
    const unsigned long long seed = keys.seed[trial];
    uint32_t c[4] = {(uint32_t)(unsigned long long)q, (uint32_t)((unsigned long long)q >> 32),
                     block, site};
    philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
    const float keep = keep_ptr != nullptr ? keep_ptr[trial * keep_stride] : keep_val;
    const unsigned long long thr = (unsigned long long)floor((double)keep * 4294967296.0);
    const long long row_off = r * g.cols;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = first + j;
      if (col < 0 || col >= g.cols) continue;
      const bool kept = (unsigned long long)c[j] < thr;
      if constexpr (APPLY) {
        const long long off = row_off + col;
        from_f32(out + off, kept ? __fdiv_rn(to_f32(x[off]), keep) : 0.0f);
      } else {
        mask[row_off + col] = kept ? 1 : 0;
      }
    }
  }
}

template <typename T>
int launch(int mode, const void* x, void* out, const Geometry& g, const Keys& keys,
           const float* keep_ptr, float keep_val, int keep_stride, const long long* row_ids,
           uint32_t block, uint32_t site, int trials, int grid, cudaStream_t st) {
  const long long total = (long long)trials * g.rows * g.slots;
  if (mode == 1)
    dropout_draw_kernel<T, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), nullptr, g, keys, keep_ptr, keep_val,
        keep_stride, row_ids, block, site, total);
  else
    dropout_draw_kernel<T, false><<<grid, THREADS, 0, st>>>(
        nullptr, nullptr, static_cast<unsigned char*>(out), g, keys, keep_ptr, keep_val,
        keep_stride, row_ids, block, site, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// mode 1: apply (x, out: (trials, rows, cols) of dtype 0 = bfloat16, 1 =
// float32); mode 0: the keep mask (out: uint8, x unused). seeds: `trials`
// host int64 words; keep: `trials` device f32 values (keep_stride 1), one
// (keep_stride 0), or null for keep_val. size, stride: the `nlead` leading
// dims' local sizes and unsplit strides; row_ids: null, or (trials * rows,)
// device int64 with nlead 1. grid: the blocks of the grid-stride loop.
extern "C" int dlsc_dropout_draw(int mode, const void* x, void* out, int dtype, int trials,
                                 int nlead, const long long* size, const long long* stride,
                                 long long base, long long cols, const long long* row_ids,
                                 const long long* seeds, const float* keep_ptr, float keep_val,
                                 int keep_stride, unsigned block, unsigned site, int grid,
                                 void* stream) {
  if (trials < 1 || trials > MAX_TRIALS || nlead < 1 || nlead > MAX_LEAD || cols < 1 ||
      grid < 1 || (mode != 0 && mode != 1) || (row_ids != nullptr && nlead != 1))
    return cudaErrorInvalidValue;
  Geometry g{};
  g.nlead = nlead;
  g.rows = 1;
  for (int d = 0; d < nlead; ++d) {
    if (size[d] < 1) return cudaErrorInvalidValue;
    g.size[d] = size[d];
    g.stride[d] = stride[d];
    g.rows *= size[d];
  }
  g.base = base;
  g.cols = cols;
  g.slots = cols / 4 + 2;
  Keys keys{};
  for (int t = 0; t < trials; ++t) keys.seed[t] = (unsigned long long)seeds[t];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(mode, x, out, g, keys, keep_ptr, keep_val, keep_stride,
                                 row_ids, block, site, trials, grid, st);
  if (dtype == 1)
    return launch<float>(mode, x, out, g, keys, keep_ptr, keep_val, keep_stride, row_ids,
                         block, site, trials, grid, st);
  return cudaErrorInvalidValue;
}
