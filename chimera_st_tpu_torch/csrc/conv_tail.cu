// K2: one layer of the wav2vec2 conv-extractor tail, as an implicit GEMM
// with an exact-GELU epilogue.
//
// Replaces the Pallas kernel chimera_st_tpu/ops/pallas_conv.py
// `_conv_tail_kernel_windows` (via `conv_tail_fused_windows` /
// `fused_conv_tail`), which cascades all six stride-2 layers of the tail
// (kernels 3,3,3,3,2,2; 512 -> 512 channels; no bias; GELU after each) in
// VMEM. That design does not carry over: one output frame of the cascade
// needs a 254-row input halo (260 KB in bf16), more than the 227 KB of
// shared memory a block may hold. So each layer is its own launch here, six
// per forward, with the intermediates in device memory.
//
// One layer computes  out[b, t, co] = gelu(sum_{j, ci} x[b, 2t + j, ci] * w[co, ci, j]).
// With x channels-last [B, T_in, C], this is a GEMM [B*T_out, k*C] x [k*C, C]
// whose A row (b, t) is x[b, 2t .. 2t + k - 1, :], k*C contiguous elements.
//
// What bounds it on the H100: operations. Layer 1 at batch 8 x 6 s is
// 76,792 x 1,536 x 512 (121 GFLOP); the six layers are ~234 GFLOP against
// ~0.46 GB of activations in and out: 0.24 ms at the bf16 tensor-core peak
// against 0.14 ms of bytes.
//
// bf16: a wgmma GEMM fed by TMA. Blocks of 128 output frames of one batch
// row x 128 output channels; two consumer warpgroups (64 rows each, wgmma
// m64n128k16, fp32 sums in registers) and one producer warp that keeps a
// 3-stage ring of 64-deep A/B tiles in shared memory (128-byte swizzle,
// full/empty mbarriers). A is read through one 3-D tensor map per tap j:
// dims (C, T_out, B), strides (2C, T_in*C) elements, based at x + j*C, so
// the map's row t is input row 2t + j, a tile never crosses a batch row,
// and rows past T_out read as zeros (the ragged M edge). The k*C depth is
// the k taps one after the other. B is the weight as [C_out, k*C_in]
// (K-major). Two blocks share an SM, so one block's epilogue (exact-erf
// GELU in fp32, bf16, masked store) overlaps the other's main loop.
//
// fp32: the CUDA-core kernel of the first port (classic 128x128x16 tiling,
// 8x8 outputs a thread), kept because the fp32 path must agree with the
// fp32 plain version to 1e-4 of the output's max and TF32 tensor cores keep
// only ~3 decimal digits.
#include "common.cuh"
#include "sm90.cuh"

namespace {

// ------------------------------------------------- fp32: CUDA-core kernel

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// w: [k, C_in, C_out] ([j, ci, co])
__global__ void __launch_bounds__(THREADS)
conv_tail_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int rows, int t_in, int t_out, int channels,
                     int depth) {
  __shared__ float as[BK][BM];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_cols = channels;  // output channels == input channels

  // A tile: 128 rows x 16 depth; each thread loads 8 consecutive depth values of one row
  const int a_row = tid >> 1, a_col = (tid & 1) * 8;
  const int m_load = m0 + a_row;
  const float* a_ptr = nullptr;
  if (m_load < rows) {
    const int b = m_load / t_out, t = m_load % t_out;
    a_ptr = x + ((size_t)b * t_in + 2 * (size_t)t) * channels;
  }
  // W tile: 16 depth x 128 columns; each thread loads 8 consecutive columns
  const int w_row = tid >> 4, w_col = (tid & 15) * 8;

  const int tr = (tid >> 4) * TM, tc = (tid & 15) * TN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += BK) {
    float buf[8];
    if (a_ptr) {
      load8(a_ptr + k0 + a_col, buf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) buf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) as[a_col + i][a_row] = buf[i];
    load8(w + (size_t)(k0 + w_row) * n_cols + n0 + w_col, buf);
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[w_row][w_col + i] = buf[i];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][tr + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tc + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tr + i;
    if (m >= rows) continue;
    float* o = out + (size_t)m * n_cols + n0 + tc;
#pragma unroll
    for (int j = 0; j < TN; ++j) o[j] = gelu_erf(acc[i][j]);
  }
}

// ------------------------------------------------ bf16: tensor-core kernel

constexpr int GM = 128, GN = 128, GK = 64;  // block tile; GK bf16 = one 128-byte swizzle row
constexpr int G_STAGES = 3;
constexpr int A_BYTES = GM * GK * 2, B_BYTES = GN * GK * 2;  // 16 KB each
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BAR_OFF = G_STAGES * STAGE_BYTES;
constexpr int G_SMEM = BAR_OFF + 16 * G_STAGES + 1024;  // + alignment slack
constexpr int G_THREADS = 288;  // warps 0-7: two consumer warpgroups; warp 8: producer
constexpr int MAX_TAPS = 3;

__global__ void __launch_bounds__(G_THREADS, 2)
conv_tail_tc_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
                    const __grid_constant__ CUtensorMap a2, const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ out, int t_out, int channels, int tiles_per_row,
                    int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern is a function of the address
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + BAR_OFF, empty0 = full0 + 8 * G_STAGES;

  const int n0 = blockIdx.x * GN;
  const int b = blockIdx.y / tiles_per_row, t0 = (blockIdx.y % tiles_per_row) * GM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      const int c_tiles = channels / GK;  // depth tiles per tap
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % G_STAGES;
        if (kt >= G_STAGES) mbar_wait(empty0 + 8 * st, ((kt / G_STAGES) - 1) & 1);
        const uint32_t a_s = base + st * STAGE_BYTES, b_s = a_s + A_BYTES;
        const int tap = kt / c_tiles, c0 = (kt % c_tiles) * GK;
        const CUtensorMap* a_map = tap == 0 ? &a0 : (tap == 1 ? &a1 : &a2);
        mbar_expect_tx(full0 + 8 * st, STAGE_BYTES);
        tma_load_3d(a_s, a_map, full0 + 8 * st, c0, t0, b);
        tma_load_2d(b_s, &w_map, full0 + 8 * st, kt * GK, n0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 * wg .. 64 * wg + 63 of the block tile
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % G_STAGES;
    const uint32_t a_s = base + st * STAGE_BYTES + wg * (A_BYTES / 2);
    const uint32_t b_s = base + st * STAGE_BYTES + A_BYTES;
    mbar_wait(full0 + 8 * st, (kt / G_STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      // K-major, 128-byte rows in 8-row groups of 1024 bytes; 16 deep (32 bytes) a step
      wgmma_m64n128k16_ss(acc, gmma_desc(a_s + kk * 32, 16, 1024, GMMA_SW128),
                          gmma_desc(b_s + kk * 32, 16, 1024, GMMA_SW128), 1);
    }
    wgmma_commit();
    // keep one group in flight; the one before it is done, release its stage
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % G_STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: exact GELU in fp32, bf16, rows past T_out dropped
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + 64 * wg + 16 * (warp & 3) + g + 8 * half;
    if (t >= t_out) continue;
    __nv_bfloat16* row = out + ((size_t)b * t_out + t) * channels + n0 + 2 * t4;
#pragma unroll
    for (int c = 0; c < GN / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) = __floats2bfloat162_rn(
          gelu_erf(acc[4 * c + 2 * half]), gelu_erf(acc[4 * c + 2 * half + 1]));
    }
  }
}

int launch_f32(const void* x, const void* w, void* out, int batch, int t_in, int t_out,
               int channels, int kernel, cudaStream_t stream) {
  const int rows = batch * t_out;
  dim3 grid(channels / BN, (rows + BM - 1) / BM);
  conv_tail_f32_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), rows,
      t_in, t_out, channels, kernel * channels);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, void* out, int batch, int t_in, int t_out,
                int channels, int kernel, cudaStream_t stream) {
  if (kernel > MAX_TAPS) return (int)cudaErrorInvalidValue;
  CUtensorMap a_maps[MAX_TAPS], w_map;
  // tap j: row t of batch b is input row 2t + j
  const uint64_t a_dims[3] = {(uint64_t)channels, (uint64_t)t_out, (uint64_t)batch};
  const uint64_t a_strides[2] = {(uint64_t)channels * 2 * 2, (uint64_t)t_in * channels * 2};
  const uint32_t a_box[3] = {GK, GM, 1};
  for (int j = 0; j < MAX_TAPS; ++j) {
    const int t = j < kernel ? j : kernel - 1;  // a map for every parameter
    const __nv_bfloat16* tap = static_cast<const __nv_bfloat16*>(x) + (size_t)t * channels;
    int err = encode_bf16_map(&a_maps[j], tap, 3, a_dims, a_strides, a_box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  const uint64_t w_dims[2] = {(uint64_t)kernel * channels, (uint64_t)channels};
  const uint64_t w_strides[1] = {(uint64_t)kernel * channels * 2};
  const uint32_t w_box[2] = {GK, GN};
  int err = encode_bf16_map(&w_map, w, 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_tail_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_per_row = (t_out + GM - 1) / GM;
  // channel tiles fastest: the blocks that share an A tile run together
  dim3 grid(channels / GN, batch * tiles_per_row);
  conv_tail_tc_kernel<<<grid, G_THREADS, G_SMEM, stream>>>(
      a_maps[0], a_maps[1], a_maps[2], w_map, static_cast<__nv_bfloat16*>(out), t_out, channels,
      tiles_per_row, kernel * channels / GK);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [batch, t_in, channels] contiguous; out: [batch, t_out, channels] with
// t_out = (t_in - kernel) / 2 + 1; channels a multiple of 128. The weight's
// layout follows the element type: bf16 (tensor cores) takes
// [channels_out, kernel, channels_in] ([co, j, ci]), fp32 (CUDA cores)
// [kernel, channels_in, channels_out] ([j, ci, co]); both contiguous.
// Returns the launch's cudaError_t.
extern "C" int chimera_conv_tail_layer(int dtype, const void* x, const void* w, void* out,
                                       int batch, int t_in, int t_out, int channels,
                                       int kernel, void* stream) {
  if (channels % BN != 0 || t_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == CHIMERA_F32) return launch_f32(x, w, out, batch, t_in, t_out, channels, kernel, s);
  if (dtype == CHIMERA_BF16) return launch_bf16(x, w, out, batch, t_in, t_out, channels, kernel, s);
  return (int)cudaErrorInvalidValue;
}
