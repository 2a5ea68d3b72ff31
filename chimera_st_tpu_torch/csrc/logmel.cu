// K4: kaldi log-mel filterbank frontend, raw wav -> [B, F, M] log-mel.
//
// Replaces the Pallas kernel chimera_st_tpu/ops/pallas_logmel.py `kernel`
// (via `logmel_pallas`). Same function as ops/fbank.py `logmel_plain`: 400-tap
// frames every 160 samples (snip edges), DC removal, pre-emphasis 0.97 (the
// first sample against itself), povey window, 512-point power spectrum,
// triangular mel weights, log(max(mel, 1.1920929e-07)). fp32 in and out.
//
// Precision: the arithmetic between the fp32 samples and the fp32 mel value
// is fp64. A single-precision spectrum is off by ~eps * log2(512) of the
// frame's norm in every bin, which is a large relative error in a bin of
// low power: on 4,784 frames of white noise an fp32 FFT and an fp32 DFT each
// land up to ~5e-4 from the exact log-mel, and two of them differ from each
// other by more (6.1e-4 measured against the plain cuFFT version on the
// card). In fp64 the kernel is exact to fp32 rounding, so its distance to
// the plain version is the plain version's own error. The pre-emphasis
// coefficient comes in as a double too: 0.97 rounded to fp32 moves the
// low-frequency mel bins by ~1e-5 in log.
//
// Not a copy of the TPU kernel. The TPU has no FFT, so it folds the linear
// steps into [400, 257] cos/sin bases and multiplies each frame by them on the
// MXU (~0.4 MFLOP a frame), fed as three 160-sample streams because Mosaic
// miscompiles lane-offset concats. Here the linear steps run in registers and
// the spectrum is a radix-2 FFT in shared memory: ~23 kFLOP a frame for the
// FFT, 18x fewer operations than the dense product, which is what makes fp64
// affordable on the CUDA cores.
//
// What bounds it on the H100: per frame it reads 160 new samples (640 B) and
// writes 80 log-mel values (320 B) for ~27 kFLOP in fp64, ~28 FLOP a byte,
// close to the fp64 CUDA-core ridge (34 TFLOP/s over 3.35 TB/s = 10); in
// practice shared-memory traffic and the 9 dependent FFT stages bound it.
//
// Design: one block per (utterance, tile of 16 frames), 4 warps; a warp owns
// one frame at a time. Lanes read the frame's 400 samples straight from
// device memory (coalesced; the 240 samples shared with the next frame come
// from L1/L2, so no frame tensor is built in HBM), take the mean with a warp
// reduction, apply pre-emphasis with a lane shuffle and the window, and
// store the result at bit-reversed positions of the warp's 512-point
// complex buffer. Nine decimation-in-time stages follow, separated by
// __syncwarp only. Power goes back into the buffer; lane m then sums mel
// bin m over the few FFT bins where its triangle is non-zero (ranges from
// the host) and writes the log, taken in fp32 as the plain version does.
#include "common.cuh"

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int NFFT = 512;
constexpr int LOG2_NFFT = 9;
constexpr int NBINS = NFFT / 2 + 1;
constexpr int WARPS = 4;
constexpr int FRAMES_PER_BLOCK = 16;
constexpr int TAPS_PER_LANE = (FRAME_LEN + 31) / 32;  // 13
constexpr float LOG_FLOOR = 1.1920929e-07f;

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
logmel_kernel(const float* __restrict__ wav, const float* __restrict__ window,
              const double* __restrict__ twiddle, const float* __restrict__ mel_w,
              const int* __restrict__ mel_range, float* __restrict__ out, int samples,
              int frames, int mel_bins, double preemph) {
  __shared__ double tw_re[NFFT / 2], tw_im[NFFT / 2];
  __shared__ double buf_re[WARPS][NFFT];
  __shared__ double buf_im[WARPS][NFFT];
  __shared__ float win[FRAME_LEN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < FRAME_LEN; i += blockDim.x) win[i] = window[i];
  for (int i = tid; i < NFFT / 2; i += blockDim.x) {
    tw_re[i] = twiddle[i];             // cos(2 pi i / 512)
    tw_im[i] = twiddle[NFFT / 2 + i];  // -sin(2 pi i / 512)
  }
  __syncthreads();

  const int b = blockIdx.y;
  const float* row = wav + (size_t)b * samples;
  double* re = buf_re[warp];
  double* im = buf_im[warp];
  const double a = preemph;
  const int f_end = min(frames, (int)(blockIdx.x + 1) * FRAMES_PER_BLOCK);

  for (int f = blockIdx.x * FRAMES_PER_BLOCK + warp; f < f_end; f += WARPS) {
    const float* x = row + (size_t)f * FRAME_SHIFT;  // 160 f + 399 < samples
    // sample j = lane + 32 r
    double v[TAPS_PER_LANE];
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < TAPS_PER_LANE; ++r) {
      const int j = lane + 32 * r;
      v[r] = j < FRAME_LEN ? (double)x[j] : 0.0;
      s += v[r];
    }
    const double mean = warp_sum_f64(s) / FRAME_LEN;
#pragma unroll
    for (int r = 0; r < TAPS_PER_LANE; ++r) v[r] -= mean;

    // pre-emphasis against sample j - 1 (lane - 1, or lane 31 of the row
    // before), the first sample against itself; window; bit-reversed store
#pragma unroll
    for (int r = 0; r < TAPS_PER_LANE; ++r) {
      const int j = lane + 32 * r;
      const double up = __shfl_up_sync(0xffffffffu, v[r], 1);
      const double wrap = __shfl_sync(0xffffffffu, v[r > 0 ? r - 1 : 0], 31);
      const double prev = lane > 0 ? up : (r > 0 ? wrap : v[0]);
      if (j < FRAME_LEN) re[__brev(j) >> (32 - LOG2_NFFT)] = (v[r] - a * prev) * (double)win[j];
    }
    for (int j = FRAME_LEN + lane; j < NFFT; j += 32) re[__brev(j) >> (32 - LOG2_NFFT)] = 0.0;
    for (int j = lane; j < NFFT; j += 32) im[j] = 0.0;
    __syncwarp();

    // radix-2 decimation in time: butterfly t of a stage joins i and
    // i + half, i = 2 * half * (t / half) + t % half, twiddle e^{-2 pi i p / span}
    for (int half = 1; half < NFFT; half <<= 1) {
      const int tw_step = (NFFT / 2) / half;
      for (int t = lane; t < NFFT / 2; t += 32) {
        const int p = t & (half - 1);
        const int i = ((t - p) << 1) + p;
        const int k = i + half;
        const double wr = tw_re[p * tw_step], wi = tw_im[p * tw_step];
        const double br = re[k], bi = im[k];
        const double tr = wr * br - wi * bi;
        const double ti = wr * bi + wi * br;
        const double ar = re[i], ai = im[i];
        re[i] = ar + tr;
        im[i] = ai + ti;
        re[k] = ar - tr;
        im[k] = ai - ti;
      }
      __syncwarp();
    }

    for (int k = lane; k < NBINS; k += 32) re[k] = re[k] * re[k] + im[k] * im[k];
    __syncwarp();

    float* dst = out + ((size_t)b * frames + f) * mel_bins;
    for (int m = lane; m < mel_bins; m += 32) {
      const float* w = mel_w + (size_t)m * NBINS;
      double acc = 0.0;
      for (int k = mel_range[2 * m]; k < mel_range[2 * m + 1]; ++k) acc += (double)w[k] * re[k];
      dst[m] = logf(fmaxf((float)acc, LOG_FLOOR));
    }
    __syncwarp();  // the buffer is refilled for the warp's next frame
  }
}

}  // namespace

// wav: [batch, samples] fp32; window: [400] fp32; twiddle: [512] fp64 (256
// cos, then 256 -sin, of 2 pi k / 512); mel_w: [mel_bins, 257] fp32;
// mel_range: [mel_bins, 2] int32, the [first, last + 1) non-zero FFT bins of
// each mel row; out: [batch, frames, mel_bins] fp32 with frames = 1 +
// (samples - 400) / 160 >= 1. Returns the launch's cudaError_t.
extern "C" int chimera_logmel(const void* wav, const void* window, const void* twiddle,
                              const void* mel_w, const void* mel_range, void* out, int batch,
                              int samples, int frames, int mel_bins, double preemph,
                              void* stream) {
  if (batch <= 0 || batch > 65535 || frames <= 0 || mel_bins <= 0 ||
      (long long)(frames - 1) * FRAME_SHIFT + FRAME_LEN > samples)
    return (int)cudaErrorInvalidValue;
  dim3 grid((frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK, batch);
  logmel_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const double*>(twiddle), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_range), static_cast<float*>(out), samples, frames, mel_bins,
      preemph);
  return (int)cudaGetLastError();
}
