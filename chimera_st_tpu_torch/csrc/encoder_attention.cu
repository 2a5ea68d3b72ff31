// K1: bidirectional encoder self-attention with a key-padding mask.
//
// Replaces the Pallas kernel chimera_st_tpu/ops/pallas_attention.py
// `_attn_kernel` (via `_fused_forward` / `fused_encoder_attention`).
//
// Semantics are those of chimera_st_tpu/ops/attention.py
// `dot_product_attention`: fp32 logits q.k * scale, a padded key's logit is
// SET to the finite value -1e8 (not -inf), fp32 softmax, P.V accumulated in
// fp32, output in the input type. A query whose keys are all padding
// therefore averages V uniformly over its T real keys. (The Pallas kernel
// pads T to a multiple of 128 and averages over the padded width instead;
// this kernel follows the XLA path.) There is no cap on T (the Pallas
// kernel's MAX_T = 1024 came from VMEM) and no padding of T.
//
// What bounds it on the H100: at the flagship shapes (T = 299 wav2vec2 trunk,
// T = 75 shared encoder; H = 8; D = 96 or 64) the work per (batch, head) is
// a T x T x D product pair, ~4*T*T*D = 34 MFLOP for the trunk, against
// 4*T*D*2 bytes of Q/K/V/O: about 90 FLOP per byte, below the bf16
// tensor-core ridge (~295), so a perfect kernel would be bound by bytes.
// In practice it is bound by latency: a (batch, head) holds only 5 key tiles
// on the trunk, so each block is a short chain of dependent steps.
//
// Two kernels, chosen by element type only:
//
// bf16: a flash-attention forward on the tensor cores. One block per
// (64-query tile, head, batch): one consumer warpgroup and one producer
// warp. The producer loads the Q tile once and streams K/V tiles of 64 keys
// through a 2-stage ring with TMA (a 4-D tensor map over [B, T, H, D]; keys
// past T read as zeros), signalling full/empty mbarriers. D is cut into
// 32-column slabs of 64-byte rows in the 64-byte swizzle, so D = 96 (192-byte
// rows, not a 128-byte atom), D = 64 and D = 128 share one layout. D = 80
// (the xlm preset's 1,280 / 16 heads) keeps three slabs, 96 columns: the
// tensor map's innermost extent stays 80, so TMA fills columns 80-95 of the
// third slab with zeros; Q.K^T steps over the 80 real columns only, and
// P.V runs at n = 96 into an accumulator whose last 16 columns (0 . P) are
// never written out. At D = 128
// (the MT presets of 512 / 4 and 1024 / 8 heads) a stage holds 32 KB of K
// and V, the Q tile 16 KB: 81 KB of shared memory a block, two blocks an SM;
// the O accumulator is 64 registers a thread. S = Q.K^T runs as
// wgmma m64n64k16 with Q and K both K-major in shared memory; the online
// softmax (running max and sum in fp32, in the log2 domain) runs on the
// accumulator fragments; P is rounded to bf16 in registers and is the A
// operand of O += P.V (wgmma m64nDk16, V MN-major via the transpose flag).
// A padded real key's logit is -1e8 (scaled into the log2 domain like every
// logit), a key past T is -inf: key 0 of every tile is real, so the running
// max is finite from the first tile on, and a fully padded row weights its
// T real keys equally while keys past T weigh 0.
//
// fp32: the CUDA-core kernel of the first port, kept because the fp32 path
// must agree with the fp32 plain version to 1e-4 and TF32 tensor cores keep
// only ~3 decimal digits. One block per (query tile of 32, head, batch); 8
// warps, each owns 4 queries; keys stream through shared memory 32 at a
// time, lane j scores key j, the warp keeps an online softmax per query. At
// D = 128 a warp owns 2 queries (a tile of 16), which keeps the block's
// static shared memory under 48 KB. Lane j owns output columns j + 32 e;
// at D = 80 the third column of lanes 16-31 is past D and idle.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr float MASKED = -1e8f;  // ops/attention.py NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------- fp32: CUDA-core kernel

constexpr int KT = 32;                // keys per shared-memory tile (one per lane)
constexpr int WARPS = 8;
// queries per warp and per block: 4 and 32, 2 and 16 at D = 128
template <int D>
struct F32Tile {
  static constexpr int QPW = D > 96 ? 2 : 4;
  static constexpr int QT = WARPS * QPW;
};

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
encoder_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int seq, int heads, float scale) {
  constexpr int QPW = F32Tile<D>::QPW, QT = F32Tile<D>::QT;
  constexpr int DL = (D + 31) / 32;  // output columns per lane (the last may be past D)
  __shared__ float qs[QT][D];
  __shared__ float ks[KT][D + 1];
  __shared__ float vs[KT][D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_stride = (size_t)heads * D;  // [B, T, H, D] contiguous
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * D;

  for (int e = tid; e < QT * D; e += blockDim.x) {
    int r = e / D, d = e % D, t = q0 + r;
    qs[r][d] = t < seq ? q[base + (size_t)t * row_stride + d] : 0.f;
  }

  float m[QPW], l[QPW], acc[QPW][DL];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += KT) {
    __syncthreads();  // previous tile consumed (and qs written, first time)
    for (int e = tid; e < KT * D; e += blockDim.x) {
      int j = e / D, d = e % D, t = k0 + j;
      bool in = t < seq;
      ks[j][d] = in ? k[base + (size_t)t * row_stride + d] : 0.f;
      vs[j][d] = in ? v[base + (size_t)t * row_stride + d] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool real = key < seq;
    const bool padded = real && mask != nullptr && mask[(size_t)b * seq + key];
    const int n_keys = min(KT, seq - k0);
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int r = warp * QPW + i;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      s *= scale;
      if (padded) s = MASKED;
      if (!real) s = -INFINITY;  // beyond T: not a key at all
      // key k0 is always real, so the tile max is finite
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[i][e] *= alpha;
      for (int j = 0; j < n_keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < DL; ++e)
          if (lane + 32 * e < D) acc[i][e] = fmaf(pj, vs[j][lane + 32 * e], acc[i][e]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int t = q0 + warp * QPW + i;
    if (t >= seq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (lane + 32 * e < D) out[base + (size_t)t * row_stride + lane + 32 * e] = acc[i][e] * inv;
  }
}

// ------------------------------------------------ bf16: tensor-core kernel

constexpr int TQ = 64;          // query rows per block: one warpgroup
constexpr int TK = 64;          // keys per K/V tile
constexpr int SLAB = 32;        // head-dim columns per TMA box (64-byte rows)
constexpr int SLAB_BYTES = TK * SLAB * 2;  // one slab of a 64-row tile: 4 KB
constexpr int STAGES = 2;       // K/V ring
constexpr int TC_THREADS = 160;  // warps 0-3 consumers, warp 4 producer

template <int D>
struct TcLayout {
  static constexpr int SLABS = (D + SLAB - 1) / SLAB;  // 3 at D = 80: columns past D read as 0
  static constexpr int DP = SLABS * SLAB;  // the head dim as the tiles and P.V hold it
  static constexpr int TILE = SLABS * SLAB_BYTES;  // one [64, D] bf16 tile
  // Q tile, then per stage a K tile and a V tile, then the mbarriers
  static constexpr int K_OFF = TILE;
  static constexpr int BAR_OFF = TILE * (1 + 2 * STAGES);
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
encoder_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                            int seq, int heads, float scale_log2) {
  using L = TcLayout<D>;
  static_assert(D % 16 == 0, "Q.K^T steps over 16 head-dim columns at a time");
  constexpr int NO = L::DP / 2;  // output accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern is a function of the address
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int n_tiles = (seq + TK - 1) / TK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int s = 0; s < L::SLABS; ++s)
        tma_load_4d(q_s + s * SLAB_BYTES, &q_map, q_full, s * SLAB, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) - 1) & 1);
        const uint32_t k_s = base + L::K_OFF + st * 2 * L::TILE, v_s = k_s + L::TILE;
        mbar_expect_tx(full0 + 8 * st, 2 * L::TILE);
        for (int s = 0; s < L::SLABS; ++s) {
          tma_load_4d(k_s + s * SLAB_BYTES, &k_map, full0 + 8 * st, s * SLAB, h, j * TK, b);
          tma_load_4d(v_s + s * SLAB_BYTES, &v_map, full0 + 8 * st, s * SLAB, h, j * TK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: thread (warp, lane) holds rows r and r + 8 of the
  // 64-row tile, and for each 8-column chunk c the columns 8c + 2 * t4 + {0, 1}
  const int g = lane >> 2, t4 = lane & 3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * seq;
  const float masked = MASKED * LOG2E;  // -1e8 in the log2 domain of the logits
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t k_s = base + L::K_OFF + st * 2 * L::TILE, v_s = k_s + L::TILE;
    mbar_wait(full0 + 8 * st, (j / STAGES) & 1);

    // S = Q . K^T: K-major 64-byte-swizzled slabs, 16 head-dim columns a step
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 2) * SLAB_BYTES + (kk % 2) * 32;
      wgmma_m64n64k16_ss(s, gmma_desc(q_s + off, 16, 512, GMMA_SW64),
                         gmma_desc(k_s + off, 16, 512, GMMA_SW64), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // logits in the log2 domain, masked
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * TK + 8 * c + 2 * t4 + e;
        const bool real = key < seq;
        const bool padded = real && mask_row != nullptr && mask_row[key];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = s[4 * c + 2 * half + e];
          x = padded ? masked : x * scale_log2;
          if (!real) x = -INFINITY;
        }
      }
    }
    // online softmax per row; the 4 threads of a quad share a row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        mx = fmaxf(mx, fmaxf(s[4 * c + 2 * half], s[4 * c + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);  // finite: key j * TK is real
      const float alpha = exp2f(m_run[half] - m_new);  // 0 on the first tile
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * c + 2 * half + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      }
      l_run[half] = l_run[half] * alpha + sum;  // this thread's columns only
#pragma unroll
      for (int c = 0; c < L::DP / 8; ++c) {
        o[4 * c + 2 * half] *= alpha;
        o[4 * c + 2 * half + 1] *= alpha;
      }
    }

    // O += P . V: P in bf16 registers (accumulator layout = A-fragment
    // layout), V MN-major: 32-column atoms LBO = SLAB_BYTES apart, 8-key
    // groups 512 bytes apart, 16 keys (1024 bytes) a step
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc_v = gmma_desc(v_s + kk * 1024, SLAB_BYTES, 512, GMMA_SW64);
      if constexpr (L::DP == 64)
        wgmma_m64n64k16_rs_tb(o, a[kk], desc_v);
      else if constexpr (L::DP == 96)
        wgmma_m64n96k16_rs_tb(o, a[kk], desc_v);
      else
        wgmma_m64n128k16_rs_tb(o, a[kk], desc_v);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
  }

  const size_t row_stride = (size_t)heads * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int t = q0 + warp * 16 + g + 8 * half;
    if (t >= seq) continue;
    __nv_bfloat16* row = out + ((size_t)b * seq + t) * row_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + 2 * t4) = __floats2bfloat162_rn(
          o[4 * c + 2 * half] * inv, o[4 * c + 2 * half + 1] * inv);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
               int batch, int seq, int heads, float scale, cudaStream_t stream) {
  dim3 grid((seq + F32Tile<D>::QT - 1) / F32Tile<D>::QT, heads, batch);
  encoder_attention_f32_kernel<D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), seq, heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
              int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using L = TcLayout<D>;
  // [B, T, H, D] as a 4-D map, innermost first; a box is one 32-column slab
  // of 64 rows of one (batch, head); at D = 80 the third box reaches past the
  // innermost extent and TMA fills its last 16 columns with zeros
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)seq, (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)seq * heads * D * 2};
  const uint32_t box[4] = {SLAB, 1, TK, 1};
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int err = encode_bf16_map(&maps[i], ptrs[i], 4, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_64B);
    if (err) return err;
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(encoder_attention_tc_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((seq + TQ - 1) / TQ, heads, batch);
  encoder_attention_tc_kernel<D><<<grid, TC_THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], mask, static_cast<__nv_bfloat16*>(out), seq, heads,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [batch, seq, heads, head_dim] contiguous (bf16: 16-byte
// aligned); mask: [batch, seq] bytes (1 = padded) or null. bf16 runs on the
// tensor cores, fp32 on the CUDA cores. Returns the launch's cudaError_t.
extern "C" int chimera_encoder_attention(int dtype, const void* q, const void* k,
                                         const void* v, const void* mask, void* out,
                                         int batch, int seq, int heads, int head_dim,
                                         float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == CHIMERA_F32) {
    if (head_dim == 64) return launch_f32<64>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 80) return launch_f32<80>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 96) return launch_f32<96>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 128) return launch_f32<128>(q, k, v, m, out, batch, seq, heads, scale, s);
  }
  if (dtype == CHIMERA_BF16) {
    if (head_dim == 64) return launch_tc<64>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 80) return launch_tc<80>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 96) return launch_tc<96>(q, k, v, m, out, batch, seq, heads, scale, s);
    if (head_dim == 128) return launch_tc<128>(q, k, v, m, out, batch, seq, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
