// K1: fused STFT -> power -> mel filterbank for Hopper (sm_90a).
//
// Replaces the TPU kernel dlsc_tpu/ops/mel_pallas.py `_make_kernel`
// (launched by `mel_power_pallas`). Computes, for each clip and each frame
// t, mel[m, t] = sum_k fb[k, m] * (re[t, k]^2 + im[t, k]^2) with
// re/im[t, k] = sum_n frame_t[n] * win[n] * cos/sin(2 pi n k / n_fft) over
// bins k = 1..n_fft/2 (the DC bin has zero mel weight). The power spectrum
// never reaches device memory.
//
// What bounds it here: arithmetic. A 5-s clip at hop 160 has 1379 frames;
// the DFT is 2 x 1379 x 1024 x 512 multiply-adds per clip (before the trim
// below), the mel product 16x less, while the clip itself is 0.9 MB in and
// 0.7 MB out. The design:
//  - f32 FMA on the CUDA cores, so the result matches the f32 reference to
//    ~1e-6 (one TF32 pass would not meet the 1e-4 bar; the TPU kernel's
//    bf16x3 operand split is an MXU trick with no use here);
//  - the window is zero outside [lo, lo + L), so the wrapper passes only
//    those rows of the windowed DFT matrices: at win 400 in n_fft 1024 that
//    is 448 of 1024 rows, 2.3x fewer operations with identical sums;
//  - one block per (clip, 64 frames): the block's span of the padded
//    waveform is staged once in shared memory and framing is index
//    arithmetic (frame i, sample n = chunk[i * hop + n]);
//  - bins are walked 64 at a time: a 16x16 thread grid computes a 64x64
//    re/im tile from 32-row slabs of the DFT matrices (read from L2, where
//    the two L x 512 f32 matrices, 1.8 MB at win 400, stay resident),
//    squares it into a power
//    tile in shared memory, and multiplies that tile by the matching 64 rows
//    of the filterbank into per-thread mel accumulators;
//  - the output is written once, (B, n_mels, n_frames), coalesced on frames.
// wgmma / 3xTF32 tensor-core versions are later work.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 64;        // frames per block
constexpr int KC = 64;        // DFT bins per chunk
constexpr int NK = 32;        // frame samples per DFT slab
constexpr int NM = 128;       // mel bands
constexpr int THREADS = 256;  // 16 x 16
constexpr int PSTRIDE = FT + 1;

__global__ void __launch_bounds__(THREADS)
mel_power_kernel(const float* __restrict__ wave,  // (B, Lp) reflect-padded
                 const float* __restrict__ cosw,  // (L, K) window * cos, rows lo..lo+L
                 const float* __restrict__ sinw,  // (L, K) window * sin
                 const float* __restrict__ fb,    // (K, NM) filterbank, bins 1..K
                 float* __restrict__ out,         // (B, NM, n_frames)
                 int Lp, int lo, int hop, int L, int K, int n_frames, int chunk_len) {
  extern __shared__ float smem[];
  float* chunk = smem;                       // chunk_len
  float* wc = chunk + chunk_len;             // NK x KC
  float* ws = wc + NK * KC;                  // NK x KC
  float* P = ws + NK * KC;                   // KC x PSTRIDE, power as [bin][frame]
  float* fbs = P + KC * PSTRIDE;             // KC x NM

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const float* row = wave + (size_t)b * Lp;
  const int start = t0 * hop + lo;
  for (int j = tid; j < chunk_len; j += THREADS) {
    const int i = start + j;
    chunk[j] = i < Lp ? row[i] : 0.f;
  }

  float mel[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mel[i][j] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    // re/im for frames ty + 16 i and bins kc + tx + 16 j
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int n0 = 0; n0 < L; n0 += NK) {
      __syncthreads();
      for (int e = tid; e < NK * KC; e += THREADS) {
        const int nn = e / KC, kk = e % KC;
        const size_t g = (size_t)(n0 + nn) * K + kc + kk;
        wc[e] = cosw[g];
        ws[e] = sinw[g];
      }
      __syncthreads();
#pragma unroll 4
      for (int nn = 0; nn < NK; ++nn) {
        float f[4], c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = chunk[(ty + 16 * i) * hop + n0 + nn];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = wc[nn * KC + tx + 16 * j];
          s[j] = ws[nn * KC + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(f[i], c[j], re[i][j]);
            im[i][j] = fmaf(f[i], s[j], im[i][j]);
          }
      }
    }
    // Every thread has passed a barrier inside the slab loop since it last
    // read P / fbs, so the tiles can be overwritten here.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        P[(tx + 16 * j) * PSTRIDE + ty + 16 * i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    for (int e = tid; e < KC * NM; e += THREADS) fbs[e] = fb[(size_t)kc * NM + e];
    __syncthreads();
    // mel for frames tx + 16 i and bands ty + 16 j
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float p[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = P[kk * PSTRIDE + tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = fbs[kk * NM + ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mel[i][j] = fmaf(p[i], w[j], mel[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tx + 16 * i;
    if (t < n_frames) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[((size_t)b * NM + ty + 16 * j) * n_frames + t] = mel[i][j];
    }
  }
}

}  // namespace

extern "C" const char* dlsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int dlsc_mel_power(const float* wave, const float* cosw, const float* sinw,
                              const float* fb, float* out, int B, int Lp, int lo,
                              int hop, int L, int K, int n_mels, int n_frames,
                              void* stream) {
  if (n_mels != NM || L % NK != 0 || K % KC != 0 || B <= 0 || n_frames <= 0)
    return cudaErrorInvalidValue;
  const int chunk_len = (FT - 1) * hop + L;  // this block's span of the padded wave
  const size_t smem = sizeof(float) * (chunk_len + 2 * NK * KC + KC * PSTRIDE + KC * NM);
  cudaError_t err = cudaFuncSetAttribute(
      mel_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_frames + FT - 1) / FT, B);
  mel_power_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wave, cosw, sinw, fb, out, Lp, lo, hop, L, K, n_frames, chunk_len);
  return cudaGetLastError();
}
