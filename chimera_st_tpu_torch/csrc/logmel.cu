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
// land up to ~5e-4 from the exact log-mel. In fp64 the kernel is exact to
// fp32 rounding, so its distance to the plain version is the plain version's
// own error. The pre-emphasis coefficient comes in as a double too: 0.97
// rounded to fp32 moves the low-frequency mel bins by ~1e-5 in log.
//
// Not a copy of the TPU kernel. The TPU has no FFT, so it folds the linear
// steps into [400, 257] cos/sin bases and multiplies each frame by them on the
// MXU (~0.4 MFLOP a frame). Here the spectrum is an FFT of ~11 kFLOP a frame,
// which is what makes fp64 affordable on the CUDA cores.
//
// What bounds it on the H100: neither bytes (640 B in, 320 B out a frame)
// nor fp64 operations (a few us for 4,784 frames at the 34 TFLOP/s CUDA-core
// peak), but the length of one warp's dependent chain and the shared-memory
// round trips in it. The design shortens both:
//
// - Real input used: a warp packs two neighbouring frames as the real and
//   the imaginary part of ONE complex 512-point transform and separates
//   them afterwards by symmetry, X_a[k] = (Z[k] + conj Z[512-k]) / 2,
//   X_b[k] = (Z[k] - conj Z[512-k]) / 2i; the powers come straight from
//   sums and differences. An odd last frame is paired with zeros.
// - 512 = 8 x 8 x 8: three passes of radix-8 butterflies held in registers
//   (every loop unrolled, every index a compile-time constant), two per lane
//   and pass, with two exchanges through shared memory instead of nine.
//   With n = 64 n1 + 8 n2 + n3 and k = k1 + 8 k2 + 64 k3, pass 1 transforms
//   over n1 and multiplies by W64^(n2 k1), pass 2 over n2 and multiplies by
//   W512^(n3 (k1 + 8 k2)), pass 3 over n3. Each butterfly writes its outputs
//   over its own inputs, so a pass needs no barrier between its reads and
//   writes. The three digits of an index live at 72 a + 9 b + c doubles:
//   with that padding the passes' 8-byte accesses take the 2 wavefronts they
//   always cost (pass 1's writes 3).
// - Twiddles: three fp64 table reads a butterfly, started at kernel start;
//   the seven powers of each come from repeated multiplication in registers.
// - Pass 1 reads its inputs straight from the block's staged samples: one
//   block (4 warps, 8 frames) loads its 1,520 samples once with coalesced
//   16-byte loads; DC removal, pre-emphasis and the window (read through the
//   read-only cache) are applied on the way into the butterfly. Nothing is
//   stored in bit-reversed order.
// - Mel weights compact and on chip: only the non-zero run of each triangle
//   is kept (~500 floats for 80 bins), loaded once a block. Four lanes share
//   a mel bin and stride its run; a 2-step shuffle finishes the sum.
// - One wave. A batch of 8 x 6 s is 600 blocks, 18 warps' worth of frames
//   an SM. At 96 registers a thread (__launch_bounds__ asks for 5 blocks an
//   SM; no spill) and 45.5 KB of static shared memory a block, 5 blocks = 20
//   warps fit an SM, so every frame is resident at once and the kernel's
//   time is about one warp's chain. At 113 registers and 47.6 KB only 4
//   blocks fit and the last 72 blocks ran as a second wave: 0.0230 ms
//   against 0.0185 ms on an H100 at 700 W. Registers and shared memory bound the occupancy
//   alike; 32 warps an SM would need half of both.
#include "common.cuh"

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int NFFT = 512;
constexpr int WARPS = 4;
constexpr int FRAMES_PER_BLOCK = 2 * WARPS;  // a pair of frames per warp
constexpr int TILE_SAMPLES = (FRAMES_PER_BLOCK - 1) * FRAME_SHIFT + FRAME_LEN;  // 1520
constexpr int BUF = 8 * 72;     // padded doubles of one 512-point array
constexpr int MAX_MEL = 128;    // mel bins a call may ask for
constexpr int MAX_NNZ = 520;    // non-zero mel weights (at most 2 an FFT bin)
constexpr float LOG_FLOOR = 1.1920929e-07f;
constexpr double SQRT_HALF = 0.70710678118654752440;

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// where element (a, b, c) of an 8 x 8 x 8 array lives
__device__ __forceinline__ int slot(int a, int b, int c) { return 72 * a + 9 * b + c; }
// where bin k = k1 + 8 k2 + 64 k3 of the finished transform lives
__device__ __forceinline__ int bin_slot(int k) { return slot(k & 7, (k >> 3) & 7, k >> 6); }

__device__ __forceinline__ void cmul(double& re, double& im, double wr, double wi) {
  const double r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// 4-point transform of (y0, y1, y2, y3), in place, outputs in natural order
__device__ __forceinline__ void fft4(double& r0, double& i0, double& r1, double& i1, double& r2,
                                     double& i2, double& r3, double& i3) {
  const double ar = r0 + r2, ai = i0 + i2, br = r0 - r2, bi = i0 - i2;
  const double cr = r1 + r3, ci = i1 + i3, dr = r1 - r3, di = i1 - i3;
  r0 = ar + cr; i0 = ai + ci;
  r2 = ar - cr; i2 = ai - ci;
  r1 = br + di; i1 = bi - dr;  // b - i d
  r3 = br - di; i3 = bi + dr;  // b + i d
}

// X[k] = sum_n x[n] e^{-2 pi i n k / 8}, in place, natural order
__device__ __forceinline__ void fft8(double (&re)[8], double (&im)[8]) {
  fft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6]);  // even samples -> slots 0,2,4,6
  fft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7]);  // odd samples  -> slots 1,3,5,7
  // E[k] = slot 2k, O[k] = slot 2k + 1; X[k] = E[k] + W8^k O[k], X[k+4] = E[k] - W8^k O[k]
  double er[4], ei[4], pr[4], pi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    er[k] = re[2 * k];
    ei[k] = im[2 * k];
  }
  pr[0] = re[1];                       pi[0] = im[1];                        // W8^0
  pr[1] = (re[3] + im[3]) * SQRT_HALF; pi[1] = (im[3] - re[3]) * SQRT_HALF;  // (1 - i) / sqrt 2
  pr[2] = im[5];                       pi[2] = -re[5];                       // -i
  pr[3] = (im[7] - re[7]) * SQRT_HALF; pi[3] = -(re[7] + im[7]) * SQRT_HALF;  // (-1 - i) / sqrt 2
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[k] = er[k] + pr[k];     im[k] = ei[k] + pi[k];
    re[k + 4] = er[k] - pr[k]; im[k + 4] = ei[k] - pi[k];
  }
}

// multiplies x[k] by w0 * w^k, k = 0..7, the powers by repeated multiplication
__device__ __forceinline__ void twiddle8(double (&re)[8], double (&im)[8], double w0r, double w0i,
                                         double wr, double wi) {
  double tr = w0r, ti = w0i;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cmul(re[k], im[k], tr, ti);
    cmul(tr, ti, wr, wi);
  }
}

__global__ void __launch_bounds__(WARPS * 32, 5)
logmel_kernel(const float* __restrict__ wav, const float* __restrict__ window,
              const double* __restrict__ twiddle, const float* __restrict__ mel_w,
              const int* __restrict__ mel_meta, float* __restrict__ out, int samples,
              int frames, int mel_bins, int mel_nnz, double preemph) {
  __shared__ double buf_re[WARPS][BUF];
  __shared__ double buf_im[WARPS][BUF];
  __shared__ __align__(16) float tile[TILE_SAMPLES];
  __shared__ float mw[MAX_NNZ];
  __shared__ short m_first[MAX_MEL + 1], m_off[MAX_MEL + 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES_PER_BLOCK;
  const int n_frames = min(FRAMES_PER_BLOCK, frames - f0);
  const int n_samples = (n_frames - 1) * FRAME_SHIFT + FRAME_LEN;  // a multiple of 4
  const float* src = wav + (size_t)b * samples + (size_t)f0 * FRAME_SHIFT;

  // ---- stage the block's samples, the window and the compact mel weights
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = tid * 4; i < n_samples; i += WARPS * 32 * 4)
      *reinterpret_cast<float4*>(tile + i) = *reinterpret_cast<const float4*>(src + i);
  } else {
    for (int i = tid; i < n_samples; i += WARPS * 32) tile[i] = src[i];
  }
  for (int i = tid; i < mel_nnz; i += WARPS * 32) mw[i] = mel_w[i];
  for (int i = tid; i <= mel_bins; i += WARPS * 32) {
    m_first[i] = (short)mel_meta[i];
    m_off[i] = (short)mel_meta[mel_bins + 1 + i];
  }

  // ---- this lane's twiddles (the same for every frame): butterfly
  // u = lane + 32 h has digits (hi, lo) = (u >> 3, u & 7). Table: 256 cos
  // then 256 -sin of 2 pi i / 512.
  double w1r[2], w1i[2], w2r[2], w2i[2], w20r[2], w20i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h, hi = u >> 3, lo = u & 7;
    w1r[h] = twiddle[8 * hi];        w1i[h] = twiddle[NFFT / 2 + 8 * hi];   // pass 1: W64^n2
    w2r[h] = twiddle[8 * lo];        w2i[h] = twiddle[NFFT / 2 + 8 * lo];   // pass 2: W64^n3
    w20r[h] = twiddle[hi * lo];      w20i[h] = twiddle[NFFT / 2 + hi * lo];  // W512^(n3 k1)
  }
  __syncthreads();

  const int fa = f0 + 2 * warp;  // the warp's frames: fa (real part), fa + 1 (imaginary part)
  if (fa >= frames) return;
  const bool has_b = fa + 1 < frames;
  const float* xa = tile + 2 * warp * FRAME_SHIFT;
  const float* xb = xa + FRAME_SHIFT;
  double* re = buf_re[warp];
  double* im = buf_im[warp];
  const double a = preemph;

  // ---- frame means (over the 400 samples)
  double sa = 0.0, sb = 0.0;
#pragma unroll
  for (int r = 0; r < (FRAME_LEN + 31) / 32; ++r) {
    const int j = lane + 32 * r;
    if (j < FRAME_LEN) {
      sa += (double)xa[j];
      if (has_b) sb += (double)xb[j];
    }
  }
  const double mean_a = warp_sum_f64(sa) / FRAME_LEN;
  const double mean_b = warp_sum_f64(sb) / FRAME_LEN;

  // ---- pass 1: butterfly (n2, n3) over n1, inputs j = 64 n1 + 8 n2 + n3
  // made on the way in: (v_j - a v_{j-1}) w_j with v = x - mean, v_{-1} = v_0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h, n2 = u >> 3, n3 = u & 7;
    double xr[8], xi[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int j = 64 * n1 + u;
      xr[n1] = 0.0;
      xi[n1] = 0.0;
      if (j < FRAME_LEN) {
        const int jp = j > 0 ? j - 1 : 0;
        const double w = (double)__ldg(window + j);
        xr[n1] = (((double)xa[j] - mean_a) - a * ((double)xa[jp] - mean_a)) * w;
        if (has_b) xi[n1] = (((double)xb[j] - mean_b) - a * ((double)xb[jp] - mean_b)) * w;
      }
    }
    fft8(xr, xi);
    twiddle8(xr, xi, 1.0, 0.0, w1r[h], w1i[h]);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      re[slot(k1, n2, n3)] = xr[k1];
      im[slot(k1, n2, n3)] = xi[k1];
    }
  }
  __syncwarp();

  // ---- pass 2: butterfly (k1, n3) over n2, outputs k2 over its inputs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h, k1 = u >> 3, n3 = u & 7;
    double xr[8], xi[8];
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      xr[n2] = re[slot(k1, n2, n3)];
      xi[n2] = im[slot(k1, n2, n3)];
    }
    fft8(xr, xi);
    twiddle8(xr, xi, w20r[h], w20i[h], w2r[h], w2i[h]);
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      re[slot(k1, k2, n3)] = xr[k2];
      im[slot(k1, k2, n3)] = xi[k2];
    }
  }
  __syncwarp();

  // ---- pass 3: butterfly (k1, k2) over n3, outputs k3 over its inputs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h, k1 = u >> 3, k2 = u & 7;
    double xr[8], xi[8];
#pragma unroll
    for (int n3 = 0; n3 < 8; ++n3) {
      xr[n3] = re[slot(k1, k2, n3)];
      xi[n3] = im[slot(k1, k2, n3)];
    }
    fft8(xr, xi);
#pragma unroll
    for (int k3 = 0; k3 < 8; ++k3) {
      re[slot(k1, k2, k3)] = xr[k3];
      im[slot(k1, k2, k3)] = xi[k3];
    }
  }
  __syncwarp();

  // ---- separate the two frames and take their powers, bins 0..256. Bin
  // k < 256 is read as Z[k] by its own lane only and Z[512 - k] lies above
  // 256 (or is bin 0 itself), so the powers go over Z[k] in place: frame a's
  // into re, frame b's into im.
#pragma unroll
  for (int it = 0; it <= 8; ++it) {
    // it < 8: k2 = lane & 7, k1 = lane / 8 + 4 (it & 1), k3 = it / 2; it = 8: bin 256, lane 0
    const int k = it < 8 ? ((lane >> 3) + 4 * (it & 1)) + 8 * (lane & 7) + 64 * (it >> 1) : 256;
    if (it < 8 || lane == 0) {
      const int s = bin_slot(k), sm = bin_slot((NFFT - k) & (NFFT - 1));
      const double zr = re[s], zi = im[s], yr = re[sm], yi = im[sm];
      const double ar = zr + yr, ai = zi - yi;  // 2 X_a[k]
      const double br = zi + yi, bi = yr - zr;  // 2 X_b[k]
      re[s] = 0.25 * (ar * ar + ai * ai);
      im[s] = 0.25 * (br * br + bi * bi);
    }
  }
  __syncwarp();

  // ---- mel sums: four lanes a mel bin, each every fourth weight of its run
  float* dst_a = out + ((size_t)b * frames + fa) * mel_bins;
  float* dst_b = dst_a + mel_bins;
  const int part = lane & 3;
  for (int m = lane >> 2; m < mel_bins + (lane >> 2); m += 8) {  // uniform trip count
    double acc_a = 0.0, acc_b = 0.0;
    if (m < mel_bins) {
      const int first = m_first[m], off = m_off[m], len = m_off[m + 1] - off;
      for (int i = part; i < len; i += 4) {
        const double w = (double)mw[off + i];
        const int s = bin_slot(first + i);
        acc_a += w * re[s];
        acc_b += w * im[s];
      }
    }
    acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 1);
    acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 2);
    acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 1);
    acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 2);
    if (m < mel_bins) {
      if (part == 0) dst_a[m] = logf(fmaxf((float)acc_a, LOG_FLOOR));
      if (part == 1 && has_b) dst_b[m] = logf(fmaxf((float)acc_b, LOG_FLOOR));
    }
  }
}

}  // namespace

// wav: [batch, samples] fp32; window: [400] fp32; twiddle: [512] fp64 (256
// cos, then 256 -sin, of 2 pi k / 512); mel_w: [mel_nnz] fp32, the non-zero
// run of each mel row, one after the other; mel_meta: [2, mel_bins + 1]
// int32, row 0 the first FFT bin of each run, row 1 its offset in mel_w
// (entry mel_bins = mel_nnz); out: [batch, frames, mel_bins] fp32 with
// frames = 1 + (samples - 400) / 160 >= 1. Returns the launch's cudaError_t.
extern "C" int chimera_logmel(const void* wav, const void* window, const void* twiddle,
                              const void* mel_w, const void* mel_meta, void* out, int batch,
                              int samples, int frames, int mel_bins, int mel_nnz,
                              double preemph, void* stream) {
  if (batch <= 0 || batch > 65535 || frames <= 0 || mel_bins <= 0 || mel_bins > MAX_MEL ||
      mel_nnz <= 0 || mel_nnz > MAX_NNZ ||
      (long long)(frames - 1) * FRAME_SHIFT + FRAME_LEN > samples)
    return (int)cudaErrorInvalidValue;
  dim3 grid((frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK, batch);
  // all of the SM's shared memory, so that 5 blocks fit: set at every launch
  // (a host-side setting of the current device's function, cheap), so that a
  // second card or a second thread gets it too
  cudaError_t set = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (set != cudaSuccess) return (int)set;
  logmel_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const double*>(twiddle), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_meta), static_cast<float*>(out), samples, frames, mel_bins,
      mel_nnz, preemph);
  return (int)cudaGetLastError();
}
