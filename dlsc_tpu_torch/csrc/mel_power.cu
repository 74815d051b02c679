// K1: fused STFT -> power -> mel filterbank for Hopper (sm_90a), by an FFT in
// shared memory.
//
// Replaces the TPU kernel dlsc_tpu/ops/mel_pallas.py `_make_kernel`
// (launched by `mel_power_pallas`). Computes, for each clip and each frame
// t, mel[m, t] = sum_k fb[k, m] * |X_t[k]|^2 with X_t[k] = sum_n x~[t hop +
// n] w[n] e^(-2 pi i n k / n_fft) over bins k = 1..n_fft/2 (the DC bin has
// zero mel weight), x~ the clip reflect-padded by n_fft/2 on both sides. The
// power spectrum never reaches device memory.
//
// What bounds it here: neither the bytes (0.9 MB in and 0.7 MB out a 5-s
// clip) nor the arithmetic of an FFT (~0.04 GFLOP a clip) come near the
// card's rates; the TPU kernel's dense windowed DFT (a matmul, cheap on the
// MXU) is ~1.45 GFLOP a clip of f32 FMA here. The design:
//  - one CTA of 256 threads per (clip, tile of FT frames, FT <= 32): the
//    span of the clip that the tile's windows cover, (FT - 1) hop + the
//    window's support, is read once, coalesced, into shared memory; the
//    reflect padding is index arithmetic on the way in (j < 0 reads -j, j >=
//    T reads 2 (T - 1) - j), so no padded copy of the batch is written;
//  - per frame, a real FFT of n_fft points as an n_fft/2-point complex FFT
//    of the (even, odd) sample pairs, then the split post-pass. The complex
//    FFT is Stockham, natural order, in radix-8 passes and one radix-2 or -4
//    pass (n_fft/2 = 8^a x {1, 2, 4}): a thread holds 8 points in registers
//    (one radix-8 butterfly, or 2 radix-4 or 4 radix-2 ones), n_fft/16
//    threads a frame, so 4096 / n_fft frames are in flight in a CTA; passes
//    exchange through one shared-memory buffer a frame, in place (every
//    point read, a barrier, then written: 2 barriers a pass, and half the
//    shared memory of ping-pong buffers, so 3 CTAs fit an SM at the AST
//    front-end). The first pass reads the windowed samples straight from the
//    staged span, its window values held in registers, and skips the
//    window's zeros; the power overwrites the transform in place;
//  - twiddles from a table the host computes in float64 and stores in f32:
//    e^(-2 pi i k / n_fft) for the split post-pass's bins k < n_fft/2, then
//    each later pass's e^(-2 pi i k r / (Ns R)), laid out so that a warp's
//    lanes read consecutive entries; all arithmetic in f32;
//  - the power of bins 1..n_fft/2, then the HTK filterbank in its sparse
//    form: each band a run of consecutive bins with its weights, summed in
//    bin order; the (128, FT) mel tile is staged in shared memory and
//    written coalesced along frames into (B, 128, n_frames).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NM = 128;        // mel bands
constexpr int THREADS = 256;
constexpr int FT_MAX = 32;     // frames per CTA at most
constexpr int MEL_STRIDE = FT_MAX + 1;  // the staged mel tile's row: a band's writes miss banks
constexpr int SPAN_MAX = 16384;  // staged samples at most (64 KB)

struct cf {
  float x, y;
};
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ cf mul_mi(cf a) { return {a.y, -a.x}; }  // a * (-i)

// A frame's FFT buffer holds point i at pad(i): one spare slot after every 8
// points, so that a pass's writes at a stride of 8 points (the first pass's)
// fall in different banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// In-place R-point DFT, v[r'] = sum_r v[r] e^(-2 pi i r r' / R), natural order.
template <int R>
__device__ __forceinline__ void dft(cf (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(cf (&v)[2]) {
  const cf a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(cf (&v)[4]) {
  const cf s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
  const cf s13 = cadd(v[1], v[3]), d13 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[2] = csub(s02, s13);
  v[1] = cadd(d02, d13);
  v[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void dft<8>(cf (&v)[8]) {
  constexpr float H = 0.70710678118654752f;  // sqrt(1/2)
  cf e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  // o[k] *= e^(-2 pi i k / 8)
  o[1] = {H * (o[1].x + o[1].y), H * (o[1].y - o[1].x)};
  o[2] = mul_mi(o[2]);
  o[3] = {H * (o[3].y - o[3].x), -H * (o[3].x + o[3].y)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// One Stockham pass of radix R, in place, over the NC-point complex FFT of a
// frame: butterfly j (of NC / R) reads buf[j + r NC/R], r < R, twiddles them
// by e^(-2 pi i k r / (Ns R)), k = j mod Ns (the pass's own table at OFF,
// r - 1 slowest, so that lanes of consecutive k read consecutive entries),
// transforms them and writes buf[(j / Ns) Ns R + k + r Ns]. A thread does
// 8 / R butterflies; every thread reads its points before any writes (the
// barrier between), and the writes are waited for.
template <int NC, int R, int NS, int OFF>
__device__ __forceinline__ void stockham_pass(cf* buf, const cf* tw, int lane) {
  constexpr int TPF = NC / 8, NB = 8 / R;  // threads a frame, butterflies a thread
  cf v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = buf[pad(lane + b * TPF + r * (NC / R))];
  __syncthreads();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = lane + b * TPF, k = j % NS;
#pragma unroll
    for (int r = 1; r < R; ++r) v[b][r] = cmul(v[b][r], tw[OFF + (r - 1) * NS + k]);
    dft<R>(v[b]);
    const int base = (j / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(base + r * NS)] = v[b][r];
  }
  __syncthreads();
}

// The passes after the first (which has Ns 1): radix 8 while the sub-FFT
// grows by 8 within NC, then one radix-2 or -4 pass; their twiddle tables
// follow one another from OFF.
template <int NC, int NS, int OFF>
__device__ __forceinline__ void later_passes(cf* buf, const cf* tw, int lane) {
  if constexpr (NS < NC) {
    constexpr int R = NC / NS >= 8 ? 8 : NC / NS;
    stockham_pass<NC, R, NS, OFF>(buf, tw, lane);
    later_passes<NC, NS * R, OFF + (R - 1) * NS>(buf, tw, lane);
  }
}

// 3 CTAs an SM where their shared memory allows it (n_fft 512 and 1024: the
// AST front-end's), so at most 85 registers a thread there
template <int NC>
__global__ void __launch_bounds__(THREADS, NC == 256 || NC == 512 ? 3 : 1)
mel_power_kernel(const float* __restrict__ wave,     // (B, T)
                 const float2* __restrict__ twg,     // (2 NC,) twiddles (see the top)
                 const float* __restrict__ win,      // window on its support [ws, we)
                 const int* __restrict__ band_off,   // (NM + 1,) into band_w
                 const int* __restrict__ band_first, // (NM,) first bin of each band
                 const float* __restrict__ band_w,   // the bands' weights, bin order
                 float* __restrict__ out,            // (B, NM, n_frames)
                 int T, int hop, int ws, int we, int n_frames, int ft, int nnz) {
  constexpr int N = 2 * NC;          // n_fft
  constexpr int TPF = NC / 8;        // threads a frame
  constexpr int FC = THREADS / TPF;  // frames in flight
  constexpr int NCP = NC + NC / 8;   // a frame's padded FFT buffer (see pad)
  constexpr int BPT = NM / TPF;      // bands a thread
  extern __shared__ __align__(16) uint8_t smem_raw[];
  cf* tw = reinterpret_cast<cf*>(smem_raw);                 // N
  cf* bufs = tw + N;                                        // FC frames of NCP points
  float* mel = reinterpret_cast<float*>(bufs + FC * NCP);   // NM x MEL_STRIDE
  float* bw = mel + NM * MEL_STRIDE;                        // nnz band weights
  float* span = bw + nnz;                                   // (ft - 1) hop + we - ws

  const int b = blockIdx.y, t0 = blockIdx.x * ft;
  const int frames = min(ft, n_frames - t0);
  const int span_len = (frames - 1) * hop + we - ws;
  const float* x = wave + (size_t)b * T;
  const int p0 = t0 * hop + ws - NC;  // the span's first sample, unpadded (n_fft / 2 = NC)
  for (int i = threadIdx.x; i < span_len; i += THREADS) {
    int j = p0 + i;
    j = j < 0 ? -j : (j >= T ? 2 * (T - 1) - j : j);  // center=True reflect padding
    span[i] = x[j];
  }
  for (int q = threadIdx.x; q < N; q += THREADS) {
    const float2 w = twg[q];
    tw[q] = {w.x, w.y};
  }
  for (int o = threadIdx.x; o < nnz; o += THREADS) bw[o] = band_w[o];

  // what a thread reads in every round, kept in registers: its 16 samples'
  // window values (0 off the support) and its bands' bins and weights' offsets
  const int f_local = threadIdx.x / TPF, lane = threadIdx.x % TPF;
  float wv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = 2 * (lane + (i / 2) * (NC / 8)) + i % 2;
    wv[i] = m >= ws && m < we ? win[m - ws] : 0.f;
  }
  int b_first[BPT], b_o0[BPT], b_o1[BPT];
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    b_first[i] = band_first[lane + i * TPF];
    b_o0[i] = band_off[lane + i * TPF];
    b_o1[i] = band_off[lane + i * TPF + 1];
  }
  __syncthreads();

  cf* buf = bufs + f_local * NCP;
  for (int f0 = 0; f0 < frames; f0 += FC) {
    const int f = f0 + f_local;
    const bool active = f < frames;
    // first pass (radix 8, Ns 1): z[n] = xw[2n] + i xw[2n + 1], xw[m] = x~[t hop
    // + m] w[m], read from the span; the window's zeros are never read
    {
      const float* s = span + f * hop - ws;  // s[m]: frame sample m, for ws <= m < we
      cf v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = 2 * (lane + r * (NC / 8));
        v[r].x = active && wv[2 * r] != 0.f ? s[m] * wv[2 * r] : 0.f;
        v[r].y = active && wv[2 * r + 1] != 0.f ? s[m + 1] * wv[2 * r + 1] : 0.f;
      }
      dft<8>(v);
#pragma unroll
      for (int r = 0; r < 8; ++r) buf[pad(8 * lane + r)] = v[r];
    }
    __syncthreads();
    later_passes<NC, 8, NC>(buf, tw, lane);
    // split post-pass: X[k] = E[k] + W^k O[k] for bins k = 1..NC, then |X|^2
    // in place: P[k - 1] (floats) over the buffer, once every point is read
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = lane + 1 + i * TPF;
      if (k == NC) {
        const float r = buf[0].x - buf[0].y;  // pad(0) = 0
        p[i] = r * r;
      } else {
        const cf a = buf[pad(k)], c = buf[pad(NC - k)];
        const cf bconj = {c.x, -c.y};
        const cf E = {0.5f * (a.x + bconj.x), 0.5f * (a.y + bconj.y)};
        const cf O = mul_mi({0.5f * (a.x - bconj.x), 0.5f * (a.y - bconj.y)});
        const cf X = cadd(E, cmul(tw[k], O));
        p[i] = X.x * X.x + X.y * X.y;
      }
    }
    __syncthreads();
    float* P = reinterpret_cast<float*>(buf) - 1;  // P[k]: bin k, 1 <= k <= NC
#pragma unroll
    for (int i = 0; i < 8; ++i) P[lane + 1 + i * TPF] = p[i];
    __syncthreads();
    // the bands, each summed over its bins in bin order
    if (active) {
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const float* pk = P + b_first[i] - b_o0[i];
        float acc = 0.f;
#pragma unroll 4
        for (int o = b_o0[i]; o < b_o1[i]; ++o) acc = fmaf(bw[o], pk[o], acc);
        mel[(lane + i * TPF) * MEL_STRIDE + f] = acc;
      }
    }
    __syncthreads();
  }
  // the (NM, frames) tile, coalesced along frames
  for (int i = threadIdx.x; i < NM * FT_MAX; i += THREADS) {
    const int m = i / FT_MAX, f = i % FT_MAX;
    if (f < frames) out[((size_t)b * NM + m) * n_frames + t0 + f] = mel[m * MEL_STRIDE + f];
  }
}

template <int NC>
cudaError_t launch(const float* wave, const void* tw, const float* win, const int* band_off,
                   const int* band_first, const float* band_w, float* out, int B, int T,
                   int hop, int ws, int we, int n_frames, int ft, int nnz, cudaStream_t st) {
  constexpr int FC = THREADS / (NC / 8), NCP = NC + NC / 8;
  const int span = (ft - 1) * hop + (we - ws);
  const size_t smem =
      sizeof(float) * (2 * 2 * NC + 2 * FC * NCP + NM * MEL_STRIDE + nnz + span);
  cudaError_t err = cudaFuncSetAttribute(
      mel_power_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + ft - 1) / ft, B);
  mel_power_kernel<NC><<<grid, THREADS, smem, st>>>(
      wave, static_cast<const float2*>(tw), win, band_off, band_first, band_w, out, T, hop, ws,
      we, n_frames, ft, nnz);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// wave (B, T) f32; tw (n_fft,) complex f32; win the window on [ws, we);
// band_off (129,), band_first (128,), band_w (nnz,) the filterbank's bands;
// out (B, 128, n_frames). `ft` frames a CTA (the wrapper's `_mel_plan`).
extern "C" int dlsc_mel_power(const float* wave, const void* tw, const float* win,
                              const int* band_off, const int* band_first, const float* band_w,
                              float* out, int B, int T, int n_fft, int hop, int ws, int we,
                              int n_mels, int n_frames, int ft, int nnz, void* stream) {
  if (n_mels != NM || B <= 0 || n_frames <= 0 || hop <= 0 || T <= n_fft / 2 || ws < 0 ||
      we > n_fft || we <= ws || ft < 1 || ft > FT_MAX || (ft - 1) * hop + (we - ws) > SPAN_MAX ||
      nnz < 0 || nnz > n_fft)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256:
      return launch<128>(wave, tw, win, band_off, band_first, band_w, out, B, T, hop, ws, we,
                         n_frames, ft, nnz, st);
    case 512:
      return launch<256>(wave, tw, win, band_off, band_first, band_w, out, B, T, hop, ws, we,
                         n_frames, ft, nnz, st);
    case 1024:
      return launch<512>(wave, tw, win, band_off, band_first, band_w, out, B, T, hop, ws, we,
                         n_frames, ft, nnz, st);
    case 2048:
      return launch<1024>(wave, tw, win, band_off, band_first, band_w, out, B, T, hop, ws, we,
                          n_frames, ft, nnz, st);
    default:
      return cudaErrorInvalidValue;
  }
}
