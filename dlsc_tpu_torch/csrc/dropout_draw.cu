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
// stride_0 when a row index is given (the ragged MoE's sorted rows).
//
// What bounds it: bytes, at the models' sites. A Philox block is 19 32-bit
// multiply-highs (IMAD.WIDE.U32 / IMAD.HI.U32, the FMA pipe; round 0's product
// of the block word is the host's) and 20 three-input XORs (LOP3, the ALU
// pipe) for four elements; chip_smoke.py phase 10b counts the vector loop's
// instructions an element from the SASS (`draw_loop_count`), and at the two
// integer pipes' issue rates they take less time than the bytes (2 in and 2
// out an element in bf16). The design:
//  1. No division in the loop. A group of G lanes (a power of two, the
//     host's choice: about six chunks a lane a row) takes one row at a time,
//     and computes the row's trial, counter base and pointers once, with
//     32-bit multiply-shift division by the host's magic numbers (`_plan` in
//     ops/dropout_draw.py, held to // in tests/test_torch_dropout_draw.py).
//     The host also merges leading dims that are contiguous in the unsplit
//     tensor, so the models' unsplit sites take no division at all.
//  2. Per-launch and per-row constants hoisted. Thresholds and keeps are
//     computed once a trial into shared memory; the seeds come by value in a
//     __grid_constant__ parameter; round 0's product of the block word comes
//     from the host. keep >= 1 (threshold 2^32) skips Philox: every element
//     kept, no 33-bit compare.
//  3. Vector access. A lane takes a chunk of 8 consecutive elements (2
//     Philox blocks; 16 in the mask mode, 4 blocks) with 16-byte loads and
//     stores, where every row's counter base is a multiple of 4 and every
//     row starts on 16 bytes (the models' sites: cols 384, 768, 1536, 3072),
//     and loads its next chunk before it draws the current one, so that a
//     load is in flight while Philox runs.
//  4. No wasted slots. The vector part has no idle lane but the row's last
//     chunks; the edge part (rows whose base is not a multiple of 4, odd
//     widths, a view 2 bytes past a 16-byte boundary, and the < 8-element
//     tail of a vector row) walks exactly the Philox blocks the row touches,
//     one a lane, with scalar access, in the same kernel.
//  5. No division an element. In bf16 at keep in [0.5, 1) a kept element is
//     x * RN(1 / keep) corrected by one exact residual (`div_keep`), equal to
//     the IEEE x / keep that the plain version computes over every bf16 x of
//     its domain and every such keep (checked exhaustively, `div_check_kernel`);
//     elsewhere __fdiv_rn. Indices are 32-bit where the launch has fewer than
//     2^31 elements (a 64-bit instantiation takes the rest); only q is 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_LEAD = 6;      // leading dims of one trial
constexpr int MAX_TRIALS = 64;   // seeds passed by value a launch
constexpr int THREADS = 256;
constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;   // Philox4x32 multipliers
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;   // the key's Weyl increments

struct Params {
  const void* x;
  void* out;
  const long long* row_ids;     // null, or (total_rows,): a row's row of the unsplit tensor
  const float* keep_ptr;        // null: keep_val for every trial
  unsigned long long seed[MAX_TRIALS];
  long long stride[MAX_LEAD];   // unsplit strides of the (merged) leading dims
  long long base;               // counter of the trial's first element
  unsigned long long rows;      // rows of one trial
  unsigned long long total_rows;
  unsigned long long cols;
  unsigned long long nvec;      // vector chunks a row (0: every row by Philox blocks)
  unsigned long long size[MAX_LEAD];   // local sizes of the leading dims
  uint32_t size_mul[MAX_LEAD], size_shr[MAX_LEAD];   // their magic numbers
  uint32_t rows_mul, rows_shr;
  int nlead, trials, keep_stride, log2_group;
  float keep_val;
  uint32_t site;
  uint32_t lo1, hi1;            // M1 * block: round 0's product of counter word 2
};

// n / d for n < 2^31: ((2n * mul) >> 32) >> shr (the host's magic numbers).
__device__ __forceinline__ void divmod(uint32_t n, uint64_t d, uint32_t mul, uint32_t shr,
                                       uint32_t& q, uint32_t& r) {
  q = __umulhi(n << 1, mul) >> shr;
  r = n - q * (uint32_t)d;
}
__device__ __forceinline__ void divmod(uint64_t n, uint64_t d, uint32_t, uint32_t, uint64_t& q,
                                       uint64_t& r) {
  q = n / d;
  r = n - q * d;
}

// A row's key schedule: round i XORs in k0 + i*W0 and k1 + i*W1; round 0's
// constants folded (x0 = hi(M1 * block) ^ k0, x2 = site ^ k1).
struct Keys {
  uint32_t k0[10], k1[10];
  uint32_t x0, x2, lo1;
};

__device__ __forceinline__ Keys row_keys(unsigned long long seed, const Params& p) {
  Keys k;
  const uint32_t s0 = (uint32_t)seed, s1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = s0 + (uint32_t)i * W0;
    k.k1[i] = s1 + (uint32_t)i * W1;
  }
  k.x0 = p.hi1 ^ s0;
  k.x2 = p.site ^ s1;
  k.lo1 = p.lo1;
  return k;
}

// Philox4x32-10 of counter (q_lo, q_hi, block, site).
__device__ __forceinline__ void philox(uint32_t w[4], uint64_t q, const Keys& k) {
  const uint32_t q_lo = (uint32_t)q, q_hi = (uint32_t)(q >> 32);
  uint32_t c0 = q_hi ^ k.x0, c1 = k.lo1, c2 = __umulhi(M0, q_lo) ^ k.x2, c3 = M0 * q_lo;
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    const uint32_t a_lo = M0 * c0, a_hi = __umulhi(M0, c0);
    const uint32_t b_lo = M1 * c2, b_hi = __umulhi(M1, c2);
    c0 = b_hi ^ c1 ^ k.k0[i];
    c1 = b_lo;
    c2 = a_hi ^ c3 ^ k.k1[i];
    c3 = a_lo;
  }
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }

// x / keep without a division, for bf16 x (8 significant bits) and 0.5 <=
// keep < 1: q = RN(x * y) with y = RN(1 / keep), corrected by an exact
// residual (x - keep * q). It equals __fdiv_rn(x, keep) for every bf16 x of
// 2^-100 <= |x| < 2^127 (`in_domain`: there the residual is exact and
// nothing overflows) and every f32 keep in [0.5, 1): `div_check_kernel`
// compares the two over all of them (2^16 x 2^23 pairs), and chip_smoke.py
// phase 10b requires no difference. Other x (zeros, subnormals, inf, NaN),
// other keeps and f32 x take __fdiv_rn.
constexpr uint32_t EXP_MIN = 27, EXP_MAX = 253;   // the domain's exponent fields

__device__ __forceinline__ float div_keep(float x, float keep, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-keep, q, x), y, q);
}

__device__ __forceinline__ bool in_domain(float x) {
  return ((__float_as_uint(x) >> 23) & 0xFF) - EXP_MIN <= EXP_MAX - EXP_MIN;
}

__device__ __forceinline__ float scale(float v, bool kept, float keep) {
  return kept ? __fdiv_rn(v, keep) : 0.0f;
}

// A vector chunk of x as loaded: 8 bf16 (one uint4) or 8 f32 (two float4).
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { uint4 v; };
template <> struct Chunk<float> { float4 a, b; };

__device__ __forceinline__ Chunk<__nv_bfloat16> load_chunk(const __nv_bfloat16* x) {
  return {*reinterpret_cast<const uint4*>(x)};
}
__device__ __forceinline__ Chunk<float> load_chunk(const float* x) {
  return {reinterpret_cast<const float4*>(x)[0], reinterpret_cast<const float4*>(x)[1]};
}

// out = x / keep where bit j of `kept` is set, else 0, element j of the
// chunk. FAST: div_keep where every element is in its domain (y = RN(1/keep)).
template <bool FAST>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* out, const Chunk<__nv_bfloat16>& c,
                                            uint32_t kept, float keep, float y) {
  const uint32_t in[4] = {c.v.x, c.v.y, c.v.z, c.v.w};
  bool fast = FAST;
  if constexpr (FAST) {   // every exponent field in [EXP_MIN, EXP_MAX]: 16-bit halves at once
    uint32_t e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __vsub2(in[j] & 0x7F807F80u, (EXP_MIN << 7) * 0x10001u);
    fast = __vcmpleu2(__vmaxu2(__vmaxu2(e[0], e[1]), __vmaxu2(e[2], e[3])),
                      ((EXP_MAX - EXP_MIN) << 7) * 0x10001u) == 0xFFFFFFFFu;
  }
  float v[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(in[j] << 16);
    v[2 * j + 1] = __uint_as_float(in[j] & 0xFFFF0000u);
  }
  if (fast) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (kept >> j) & 1 ? div_keep(v[j], keep, y) : 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = scale(v[j], (kept >> j) & 1, keep);
  }
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    o[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
}
template <bool FAST>
__device__ __forceinline__ void store_chunk(float* out, const Chunk<float>& c, uint32_t kept,
                                            float keep, float) {
  const float4 v[2] = {c.a, c.b};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t b = kept >> (4 * h);
    reinterpret_cast<float4*>(out)[h] =
        make_float4(scale(v[h].x, b & 1, keep), scale(v[h].y, (b >> 1) & 1, keep),
                    scale(v[h].z, (b >> 2) & 1, keep), scale(v[h].w, (b >> 3) & 1, keep));
  }
}
// 16 mask bytes, one uint4
__device__ __forceinline__ void mask_chunk(unsigned char* out, uint32_t kept) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = ((kept >> (4 * j)) & 1) | ((kept >> (4 * j + 1)) & 1) << 8 |
           ((kept >> (4 * j + 2)) & 1) << 16 | ((kept >> (4 * j + 3)) & 1) << 24;
  *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
}

// The keep bits of BLOCKS consecutive Philox blocks from block q: bit 4b + j
// for word j of block q + b.
template <int BLOCKS>
__device__ __forceinline__ uint32_t draw_bits(uint64_t q, const Keys& k, uint32_t thr) {
  uint32_t kept = 0;
#pragma unroll
  for (int b = 0; b < BLOCKS; ++b) {
    uint32_t w[4];
    philox(w, q + b, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) kept |= (uint32_t)(w[j] < thr) << (4 * b + j);
  }
  return kept;
}

// The vector part of a row in apply mode: chunks glane, glane + group, ...
// below nvec, each loaded one iteration ahead of its use. DRAW: Philox bits
// (else every element kept); FAST: div_keep.
template <typename T, bool DRAW, bool FAST, typename I>
__device__ __forceinline__ void apply_row(const T* x, T* out, I glane, I group, I nvec,
                                          uint64_t q0, const Keys& k, uint32_t thr,
                                          float keep, float y) {
  if (glane >= nvec) return;
  Chunk<T> next = load_chunk(x + glane * 8);
#pragma unroll 1
  for (I c = glane; c < nvec; c += group) {
    const Chunk<T> cur = next;
    if (c + group < nvec) next = load_chunk(x + (c + group) * 8);
    const uint32_t kept = DRAW ? draw_bits<2>(q0 + (uint64_t)c * 2, k, thr) : 0xFFu;
    store_chunk<FAST>(out + c * 8, cur, kept, keep, y);
  }
}

// The vector part of a row in mask mode: 16 elements a chunk.
template <bool DRAW, typename I>
__device__ __forceinline__ void mask_row(unsigned char* mask, I glane, I group, I nvec,
                                         uint64_t q0, const Keys& k, uint32_t thr) {
#pragma unroll 1
  for (I c = glane; c < nvec; c += group)
    mask_chunk(mask + c * 16, DRAW ? draw_bits<4>(q0 + (uint64_t)c * 4, k, thr) : 0xFFFFu);
}

// APPLY: out = x / keep where kept, else 0, in x's type T; else the keep
// mask (uint8). WIDE: 64-bit indices (a launch of 2^31 elements or more).
template <typename T, bool APPLY, bool WIDE>
__global__ void __launch_bounds__(THREADS) dropout_draw_kernel(const __grid_constant__ Params p) {
  using I = typename std::conditional<WIDE, uint64_t, uint32_t>::type;
  constexpr int VEC = APPLY ? 8 : 16;      // elements a vector chunk
  __shared__ uint32_t s_thr[MAX_TRIALS];   // floor(keep * 2^32) where below 2^32
  __shared__ float s_keep[MAX_TRIALS];
  __shared__ bool s_all[MAX_TRIALS];       // keep >= 1: every element kept
  if ((int)threadIdx.x < p.trials) {
    const float keep = p.keep_ptr != nullptr ? p.keep_ptr[threadIdx.x * p.keep_stride]
                                             : p.keep_val;
    const double t = floor((double)keep * 4294967296.0);
    s_all[threadIdx.x] = t >= 4294967296.0;
    s_thr[threadIdx.x] = t >= 4294967296.0 ? 0u : t > 0.0 ? (uint32_t)t : 0u;
    s_keep[threadIdx.x] = keep;
  }
  __syncthreads();

  const I group = (I)1 << p.log2_group;
  const I glane = (I)(threadIdx.x & (group - 1));
  const I ngroups = ((I)gridDim.x * THREADS) >> p.log2_group;
  const I cols = (I)p.cols, nvec = (I)p.nvec;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  unsigned char* mask = static_cast<unsigned char*>(p.out);

  for (I row = ((I)blockIdx.x * THREADS + threadIdx.x) >> p.log2_group; row < (I)p.total_rows;
       row += ngroups) {
    // the row's trial, counter base and keep, once
    I trial = 0, r = row;
    if (p.trials > 1) divmod(row, p.rows, p.rows_mul, p.rows_shr, trial, r);
    long long rowbase = p.base;
    if (p.row_ids != nullptr) {
      rowbase += p.row_ids[row] * p.stride[0];
    } else {
      I rem = r;
      for (int d = p.nlead - 1; d > 0; --d) {
        I q, idx;
        divmod(rem, p.size[d], p.size_mul[d], p.size_shr[d], q, idx);
        rowbase += (long long)idx * p.stride[d];
        rem = q;
      }
      rowbase += (long long)rem * p.stride[0];
    }
    const uint64_t q0 = (uint64_t)rowbase >> 2;
    const I a = (I)(rowbase & 3);              // the word of the row's first element
    const uint32_t thr = s_thr[trial];
    const float keep = s_keep[trial];
    const bool all = s_all[trial];
    const Keys k = row_keys(p.seed[trial], p);
    const I off = row * cols;

    // the vector part: chunks of VEC elements, whole Philox blocks each
    if constexpr (APPLY) {
      if (all) {
        apply_row<T, false, false>(x + off, out + off, glane, group, nvec, q0, k, thr, keep,
                                   1.0f);
      } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (keep >= 0.5f && keep < 1.0f)
          apply_row<T, true, true>(x + off, out + off, glane, group, nvec, q0, k, thr, keep,
                                   __frcp_rn(keep));
        else
          apply_row<T, true, false>(x + off, out + off, glane, group, nvec, q0, k, thr, keep,
                                    1.0f);
      } else {
        apply_row<T, true, false>(x + off, out + off, glane, group, nvec, q0, k, thr, keep,
                                  1.0f);
      }
    } else {
      if (all) mask_row<false>(mask + off, glane, group, nvec, q0, k, thr);
      else mask_row<true>(mask + off, glane, group, nvec, q0, k, thr);
    }

    // the edge part, columns [nvec * VEC, cols): the Philox blocks it touches,
    // one a lane; block s holds columns 4s - a .. 4s - a + 3
    const I t0 = nvec * VEC;
    const I s_first = (a + t0) >> 2, s_last = (a + cols - 1) >> 2;
#pragma unroll 1
    for (I s = s_first + glane; s <= s_last; s += group) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (!all) philox(w, q0 + s, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const I col = 4 * s + j - a;   // wraps past cols where negative
        if (col < t0 || col >= cols) continue;
        const bool kept = all || w[j] < thr;
        if constexpr (APPLY) from_f32(out + off + col, scale(to_f32(x[off + col]), kept, keep));
        else mask[off + col] = kept ? 1 : 0;
      }
    }
  }
}

// Every (bf16 x, f32 keep in [0.5, 1)) pair: the draw's x / keep (div_keep
// where in_domain, else __fdiv_rn) against __fdiv_rn. A thread takes one
// keep (0.5 + i * 2^-24) and every x; bad[0] counts f32 results that differ,
// bad[1] those that differ after rounding to bf16 (NaN equals NaN).
__global__ void __launch_bounds__(THREADS) div_check_kernel(unsigned long long* bad) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= (1u << 23)) return;
  const float keep = __uint_as_float(0x3F000000u + i), y = __frcp_rn(keep);
  uint32_t f32_bad = 0, bf16_bad = 0;
#pragma unroll 4
  for (uint32_t b = 0; b < 65536; ++b) {
    const float x = __uint_as_float(b << 16);
    const float got = in_domain(x) ? div_keep(x, keep, y) : __fdiv_rn(x, keep);
    const float want = __fdiv_rn(x, keep);
    const bool nan = isnan(got) && isnan(want);
    f32_bad += !nan && __float_as_uint(got) != __float_as_uint(want);
    bf16_bad += !nan && __bfloat16_as_ushort(__float2bfloat16_rn(got)) !=
                            __bfloat16_as_ushort(__float2bfloat16_rn(want));
  }
  if (f32_bad) atomicAdd(&bad[0], (unsigned long long)f32_bad);
  if (bf16_bad) atomicAdd(&bad[1], (unsigned long long)bf16_bad);
}

// blocks of THREADS that the card holds at once, for this instantiation
template <typename T, bool APPLY, bool WIDE>
int resident_blocks() {
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dropout_draw_kernel<T, APPLY, WIDE>, THREADS, 0) != cudaSuccess)
    return -1;
  static int sms[64] = {};   // by device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return per_sm * sms[dev];
}

template <typename T, bool APPLY, bool WIDE>
int launch(const Params& p, cudaStream_t st) {
  const int resident = resident_blocks<T, APPLY, WIDE>();
  if (resident < 1) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  const unsigned long long threads = p.total_rows << p.log2_group;
  const unsigned long long need = (threads + THREADS - 1) / THREADS;
  const int grid = (int)(need < (unsigned long long)resident ? need : resident);
  dropout_draw_kernel<T, APPLY, WIDE><<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool APPLY>
int launch_width(const Params& p, bool wide, cudaStream_t st) {
  return wide ? launch<T, APPLY, true>(p, st) : launch<T, APPLY, false>(p, st);
}

}  // namespace

// div_check_kernel over every pair; bad: 2 device words, zeroed by the caller.
extern "C" int dlsc_dropout_div_check(unsigned long long* bad, void* stream) {
  div_check_kernel<<<(1 << 23) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(bad);
  return (int)cudaGetLastError();
}

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// mode 1: apply (x, out: (trials, rows, cols) of dtype 0 = bfloat16, 1 =
// float32); mode 0: the keep mask (out: uint8, x unused). seeds: `trials`
// host int64 words; keep: `trials` device f32 values (keep_stride 1), one
// (keep_stride 0), or null for keep_val. size, stride, mul, shr: the `nlead`
// (merged) leading dims' local sizes, unsplit strides and magic numbers;
// row_ids: null, or (trials * rows,) device int64 with nlead 1. nvec: vector
// chunks a row (8 elements, 16 in mode 0), 0 for none; log2_group: lanes a
// row; wide: 64-bit indices. The plan (`_plan` in ops/dropout_draw.py)
// decides nvec, log2_group, wide and the magic numbers; a vector plan whose
// rows do not all start on a Philox block and on 16 bytes is refused.
extern "C" int dlsc_dropout_draw(int mode, const void* x, void* out, int dtype, int trials,
                                 int nlead, const long long* size, const long long* stride,
                                 const unsigned* mul, const unsigned* shr, long long base,
                                 long long cols, const long long* row_ids,
                                 const long long* seeds, const float* keep_ptr, float keep_val,
                                 int keep_stride, unsigned block, unsigned site,
                                 long long nvec, int log2_group, int wide, unsigned rows_mul,
                                 unsigned rows_shr, void* stream) {
  if (trials < 1 || trials > MAX_TRIALS || nlead < 1 || nlead > MAX_LEAD || cols < 1 ||
      base < 0 || nvec < 0 || log2_group < 0 || log2_group > 5 || (mode != 0 && mode != 1) ||
      (mode == 1 && dtype != 0 && dtype != 1) || (row_ids != nullptr && nlead != 1))
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.out = out;
  p.row_ids = row_ids;
  p.keep_ptr = keep_ptr;
  p.nlead = nlead;
  p.rows = 1;
  for (int d = 0; d < nlead; ++d) {
    if (size[d] < 1) return cudaErrorInvalidValue;
    p.size[d] = (unsigned long long)size[d];
    p.size_mul[d] = mul[d];
    p.size_shr[d] = shr[d];
    p.stride[d] = stride[d];
    p.rows *= (unsigned long long)size[d];
  }
  p.total_rows = p.rows * (unsigned long long)trials;
  p.rows_mul = rows_mul;
  p.rows_shr = rows_shr;
  p.base = base;
  p.cols = (unsigned long long)cols;
  p.nvec = (unsigned long long)nvec;
  p.log2_group = log2_group;
  p.trials = trials;
  p.keep_val = keep_val;
  p.keep_stride = keep_stride;
  p.site = site;
  const uint64_t b = (uint64_t)M1 * block;
  p.lo1 = (uint32_t)b;
  p.hi1 = (uint32_t)(b >> 32);
  for (int t = 0; t < trials; ++t) p.seed[t] = (unsigned long long)seeds[t];
  if (!wide && p.total_rows * p.cols >= (1ull << 31)) return cudaErrorInvalidValue;
  const int esize = mode == 0 ? 1 : dtype == 0 ? 2 : 4;
  const long long vec = mode == 0 ? 16 : 8;
  if (nvec > 0) {   // every row on a Philox block and on 16 bytes
    bool ok = nvec * vec <= cols && base % 4 == 0 && (cols * esize) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
              (mode == 0 || reinterpret_cast<uintptr_t>(x) % 16 == 0);
    for (int d = 0; d < nlead; ++d)
      ok = ok && (stride[d] % 4 == 0 || (size[d] == 1 && row_ids == nullptr));
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_width<float, false>(p, wide != 0, st);
  if (dtype == 0) return launch_width<__nv_bfloat16, true>(p, wide != 0, st);
  return launch_width<float, true>(p, wide != 0, st);
}
