// K3: one beam-search step of decoder self-attention over a lazily
// reordered KV cache.
//
// Replaces the Pallas kernel chimera_st_tpu/ops/pallas_decode_attention.py
// `_kernel` (via `decode_step_attention`); the XLA oracle is the crosscol
// branch of chimera_st_tpu/models/layers.py MultiheadAttention.
//
// Lazy beam reorder: the beam search never permutes the cache. Hypothesis
// (sentence s, beam kq) finds its time-l entry in column
// anc[l, s*C + kq] of its own sentence. Mosaic has no 2-D gather, so the
// Pallas kernel turned that select into a mask over all C columns; here the
// ancestor row is gathered directly, in the style of paged attention.
//
// Cache layout [B*C, H, L, D]: one (column, head) timeline is contiguous,
// so a gathered row is D contiguous elements. The call also writes this
// step's K and V rows into the cache at time `step` (the caller preallocates
// L = max_decode_len; positions past `step` are never loaded, so results do
// not depend on L or on what lies there).
//
// What bounds it on the H100: not bytes (7 MB a step at the flagship shape,
// 2 us at 3.35 TB/s) and not operations (4 FLOP per element read), but the
// chain of dependent trips to device memory inside one launch, each
// 0.6-0.8 us, and the launch itself. The design keeps the chain at two
// trips and gives every SM work:
//
// - One block of 4 warps per (hypothesis column, head): 640 blocks at the
//   flagship shape, 160 on the fbank path, one wave on 132 SMs.
// - Indices first, then every row at once. Each thread loads the one
//   ancestry entry of the row it copies (trip 1), then starts 16-byte
//   cp.async copies of that row's K and V slices into shared memory
//   (trip 2). A tile holds at most 512 16-byte chunks of K (and of V), a
//   whole number of rows: the largest power of two of times that fits,
//   so 64 times in bf16 and 32 in fp32 at D = 64; 32 and 16 at D = 96 and
//   D = 128; 128 and 64 at D = 32; unless one pass of the warps' row
//   groups needs more: D = 80 (the xlm preset) takes 64 times in bf16 and
//   32 in fp32, 640 chunks. A row is D / 8 chunks in bf16, D / 4 in fp32,
//   and the 128 threads split a tile's rows evenly, 1 to 8 threads a row.
//   Longer timelines loop over tiles through a two-stage ring, the next
//   tile's copies in flight while this one is reduced.
// - The time-`step` row is taken from k_new / v_new of the ancestor column
//   (inputs, never written), and a block writes only its own column's row
//   into the cache: no block reads what another block writes, so there is
//   no race across blocks and the cache ends bit-equal to a plain copy.
// - Wide reads from shared memory: a group of 8 lanes shares a row (else
//   the largest power of two that divides the row's chunks: 4 at D = 32
//   and D = 96 in bf16 and D = 80 in fp32, 2 at D = 80 in bf16), each
//   lane reading a whole number of 16-byte chunks; a shuffle across the
//   group finishes the dot product, and the same lanes then read the same
//   slice of the V row, so P.V needs no exchange of probabilities. A warp
//   holds 4 (or 8) groups and takes every fourth run of them over a tile;
//   each warp keeps its own online softmax (max, sum, accumulator) in
//   fp32, and the four partial results are merged through shared memory at
//   the end.
#include "common.cuh"

#include <initializer_list>

namespace {

constexpr int MAX_BEAM = 32;
constexpr int K3_WARPS = 4;
constexpr int K3_THREADS = K3_WARPS * 32;
constexpr int CHUNKS_PER_TILE = 512;  // at most this many 16-byte chunks of K (and of V) a tile

constexpr int pow2_floor(int n) { return n < 2 ? 1 : 2 * pow2_floor(n / 2); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 16-byte chunk -> fp32 values (8 of bf16, 4 of fp32)
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float (&out)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float (&out)[4], float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// the split of a (T, D) row and tile (see the header)
template <typename T, int D>
struct K3Split {
  static constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CH = D / EPC;           // chunks per row
  static constexpr int LPR = CH % 8 == 0 ? 8 : CH % 4 == 0 ? 4 : 2;  // lanes per row
  static constexpr int CPL = CH / LPR;         // chunks a lane reads per row
  static constexpr int GPW = 32 / LPR;         // row groups per warp
  // times per tile: within 512 chunks, but at least one pass of row groups
  static constexpr int TILE = pow2_floor(CHUNKS_PER_TILE / CH) > GPW * K3_WARPS
                                  ? pow2_floor(CHUNKS_PER_TILE / CH) : GPW * K3_WARPS;
  static constexpr int TPR = K3_THREADS / TILE;  // copying threads per row
  static constexpr int CPT = CH / TPR;         // chunks a thread copies per row
  static constexpr int PASSES = TILE / (GPW * K3_WARPS);  // runs of groups a warp takes per tile
  static_assert(D % EPC == 0 && CH % LPR == 0 && CPL >= 1, "a lane reads whole chunks");
  static_assert(K3_THREADS % TILE == 0 && CH % TPR == 0 && CPT >= 1,
                "the threads copy whole chunks of whole rows");
  static_assert(PASSES >= 1 && TILE % (GPW * K3_WARPS) == 0, "a tile holds whole row groups");
  static_assert(D <= K3_THREADS && 2 * CH <= K3_THREADS, "one thread an output element");
  static_assert(2 * 2 * TILE * D * sizeof(T) <= 40 * 1024, "the ring fits in 40 KB");
};

template <typename T, int D>
__global__ void __launch_bounds__(K3_THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_cache, T* v_cache,
                        const int* __restrict__ anc,
                        T* __restrict__ out, int n_cols, int beam, int heads, int max_len,
                        int step, float scale_log2) {
  using S = K3Split<T, D>;
  constexpr int EPC = S::EPC, CH = S::CH, LPR = S::LPR, CPL = S::CPL, GPW = S::GPW;
  constexpr int TILE = S::TILE, TPR = S::TPR, CPT = S::CPT, PASSES = S::PASSES;
  constexpr int ROW_BYTES = D * sizeof(T);

  __shared__ __align__(16) unsigned char k_tile[2][TILE * ROW_BYTES];
  __shared__ __align__(16) unsigned char v_tile[2][TILE * ROW_BYTES];
  __shared__ float part_m[K3_WARPS], part_l[K3_WARPS], part_acc[K3_WARPS][D];

  const int col = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int first_col = col / beam * beam;
  const size_t own = ((size_t)col * heads + h) * D;  // this block's row of q, k_new, v_new, out

  // copies of one tile: thread -> row tid / TPR, chunks (tid % TPR) * CPT ...
  const int copy_row = tid / TPR, copy_chunk = (tid % TPR) * CPT;
  auto fetch = [&](int tile, int stage) {
    const int t = tile * TILE + copy_row;
    if (t <= step) {
      const size_t src_col = (size_t)first_col + anc[(size_t)t * n_cols + col];
      const size_t head_row = src_col * heads + h;
      const T* ks;
      const T* vs;
      if (t == step) {  // this step's row: from the inputs, not from the cache
        ks = k_new + head_row * D;
        vs = v_new + head_row * D;
      } else {
        ks = k_cache + (head_row * max_len + t) * D;
        vs = v_cache + (head_row * max_len + t) * D;
      }
      unsigned char* kd = k_tile[stage] + copy_row * ROW_BYTES;
      unsigned char* vd = v_tile[stage] + copy_row * ROW_BYTES;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        cp_async16(kd + (copy_chunk + c) * 16, ks + (copy_chunk + c) * EPC);
        cp_async16(vd + (copy_chunk + c) * 16, vs + (copy_chunk + c) * EPC);
      }
    }
    cp_async_commit();
  };
  fetch(0, 0);

  // while the copies fly: this column's new rows into the cache, the query
  // slice of this lane into registers
  if (tid < 2 * CH) {
    const int c = tid % CH;
    const T* src = (tid < CH ? k_new : v_new) + own + c * EPC;
    T* dst = (tid < CH ? k_cache : v_cache) + (own * max_len + (size_t)step * D) + c * EPC;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
  float qv[CPL][EPC];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + own + (sub + LPR * j) * EPC);
    chunk_to_f32(raw, qv[j], T());
  }

  // this warp's online softmax over its rows; lane (grp, sub) sees the rows
  // of group grp and the columns of chunks sub, sub + LPR, ...
  float m = -INFINITY, l = 0.f, acc[CPL][EPC];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[j][e] = 0.f;

  const int n_tiles = step / TILE + 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      fetch(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed

    float s[PASSES];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int row = (i * K3_WARPS + warp) * GPW + grp;
      const bool live = tile * TILE + row <= step;
      float dot = 0.f;
      if (live) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float kv[EPC];
          chunk_to_f32(*reinterpret_cast<const uint4*>(k_tile[stage] + row * ROW_BYTES +
                                                        (sub + LPR * j) * 16), kv, T());
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(qv[j][e], kv[e], dot);
        }
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[i] = live ? dot * scale_log2 : -INFINITY;  // log2 domain
      tile_max = fmaxf(tile_max, s[i]);
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    if (tile_max > -INFINITY) {  // the warp has a live row in this tile (warp-uniform)
      const float m_new = fmaxf(m, tile_max);
      const float alpha = exp2f(m - m_new);  // 0 on the warp's first live tile
      l *= alpha;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const int row = (i * K3_WARPS + warp) * GPW + grp;
        if (s[i] > -INFINITY) {  // a dead row's bytes are never loaded
          const float p = exp2f(s[i] - m_new);
          l += p;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            float vv[EPC];
            chunk_to_f32(*reinterpret_cast<const uint4*>(v_tile[stage] + row * ROW_BYTES +
                                                          (sub + LPR * j) * 16), vv, T());
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
          }
        }
      }
      m = m_new;
    }
    if (tile + 1 < n_tiles) __syncthreads();  // the stage is refilled two tiles on
  }

  // the warp's row groups -> one partial result (l is the same in the
  // lanes of a group, so it is summed across groups only)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      float a = acc[j][e];
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (grp == 0) part_acc[warp][(sub + LPR * j) * EPC + e] = a;
    }
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
  __syncthreads();

  // merge the four partial softmaxes; warp 0 always holds time 0, so the
  // overall max is finite and a warp without a live row weighs 0
  if (tid < D) {
    float big = part_m[0];
#pragma unroll
    for (int w = 1; w < K3_WARPS; ++w) big = fmaxf(big, part_m[w]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < K3_WARPS; ++w) {
      const float wgt = exp2f(part_m[w] - big);
      sum = fmaf(part_l[w], wgt, sum);
      o = fmaf(part_acc[w][tid], wgt, o);
    }
    out[own + tid] = from_f32<T>(o / sum);
  }
}

// an empty kernel: what one launch costs on this card with nothing to do
__global__ void launch_floor_kernel() {}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const int* anc, void* out, int n_cols, int beam, int heads, int head_dim,
           int max_len, int step, float scale, cudaStream_t stream) {
  if ((head_dim != 32 && head_dim != 64 && head_dim != 80 && head_dim != 96 && head_dim != 128) ||
      beam < 1 ||
      beam > MAX_BEAM || n_cols % beam != 0 || heads > 65535 || step < 0 || step >= max_len)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k_new, v_new, (const void*)k_cache, (const void*)v_cache,
                        (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  dim3 grid(n_cols, heads);
  auto kernel = head_dim == 32   ? decode_attention_kernel<T, 32>
                : head_dim == 64 ? decode_attention_kernel<T, 64>
                : head_dim == 80 ? decode_attention_kernel<T, 80>
                : head_dim == 96 ? decode_attention_kernel<T, 96>
                                 : decode_attention_kernel<T, 128>;
  kernel<<<grid, K3_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), anc, static_cast<T*>(out), n_cols,
      beam, heads, max_len, step, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_new, v_new, out: [n_cols, heads, head_dim]; k_cache, v_cache:
// [n_cols, heads, max_len, head_dim]; anc: [>= step + 1, n_cols] int32
// within-sentence source columns; n_cols = sentences * beam. All contiguous
// and 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int chimera_decode_attention(int dtype, const void* q, const void* k_new,
                                        const void* v_new, void* k_cache, void* v_cache,
                                        const void* anc, void* out, int n_cols, int beam,
                                        int heads, int head_dim, int max_len, int step,
                                        float scale, void* stream) {
  const int* a = static_cast<const int*>(anc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == CHIMERA_F32)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, a, out, n_cols, beam, heads,
                         head_dim, max_len, step, scale, s);
  if (dtype == CHIMERA_BF16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, a, out, n_cols, beam,
                                 heads, head_dim, max_len, step, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Launches the empty kernel on `stream`. Returns the launch's cudaError_t.
extern "C" int chimera_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
