// K2/K3: SimVote scores (paper Algorithm 3) for every cluster of a round in
// one launch.  score_i = sum_j w_ij y_j / max(sum_j w_ij, 1e-30) with
// w_ij = exp(-max(|x_i - s_j|^2, 0) / (2 tau_c^2)); labels of -1 are
// padding and weigh nothing.  K2 (one cluster) is this kernel with C = 1.
//
// Replaces: simvote_scores_pallas, src/repro/kernels/simvote/kernel.py:55
// (pallas_call at :71, body _simvote_kernel at :30), and
// simvote_scores_segmented_pallas, kernel.py:102 (pallas_call at :160).
//
// Bound on the H100 at the main-path shape (a round of C = 4 clusters,
// N ~ 49,600 unsampled rows, M = 101 samples each, D = 1024, f32): the
// product is 2*N*M*D ~ 10 GFLOP, 153 us at 67 TFLOP/s (f32, no tensor
// cores; TF32 would keep about three decimal digits, too few for the
// scores' 1e-5); x is 203 MB, 61 us at 3.35 TB/s.  So it is bound by
// operations: the FMA pipes must be kept busy, so no other unit (shared
// memory above all) may issue as often as they do, and the (N x M) weight
// matrix must never reach device memory.
//
// Design: a register-tiled f32 product, as an SGEMM on CUDA cores, with the
// vote fused into its epilogue.  One block of 128 threads owns BN = 8 * TN
// rows of one cluster (TN = 8; 4 when 64-row blocks would come to fewer
// than four an SM, as for one cluster of the sequential executor) and
// walks all of that cluster's samples in tiles of BM = 16 * TM, TM = 4, 7
// or 8 samples a thread, the fewest that cover M in as few tiles as 8
// would (M 101 takes one tile of 112, not 128: 10% padding, not 21%).
// Rows stay as the caller grouped them: each block finds its cluster
// through a block->cluster table and its rows through CSR row offsets.  D
// is staged in chunks of 32 by 16-byte cp.async into a double buffer in
// dynamic shared memory (4-byte copies in the scalar instantiation, for D
// not a multiple of 4 or rows not on 16 bytes).  Each thread holds a TN x
// TM tile of (row, sample) dot products in registers: one 16-byte shared
// load of a row feeds 4 TM FMAs and one of a sample 4 TN, 14.9 FMAs a load
// at TN 8, TM 7 (the old kernel: 0.8).  A warp spans 4 row groups and 8
// samples, and rows lie 36 words apart, so each quarter warp's 16-byte
// loads hit distinct banks.  Three blocks share an SM (at most 168
// registers a thread).  |x|^2 is summed once per row (in the first sample
// tile) and |s|^2 once per sample tile, from the staged chunks.  The
// epilogue of a tile computes w = exp(-max(|x|^2 - 2 acc + |s|^2, 0) g),
// masks y < 0, sums w y and w over the tile's samples by shuffles within a
// warp and adds them to the row's slot in shared memory (one writer a
// slot); the two warps that share a row are added at the end.  w <= 1, so
// no max-rebasing is needed; if every weight underflows the score is 0.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;  // blocks an SM: at most 170 registers
constexpr int RS = 8;          // row groups: a thread's rows are RS apart
constexpr int TM_MAX = 8;      // samples a thread, at most
constexpr int BM_MAX = 16 * TM_MAX;  // samples a tile, at most
constexpr int DC = 32;         // D a staged chunk
constexpr int LDS = DC + 4;    // row pitch in shared memory, in floats
static_assert(THREADS == BM_MAX, "a thread stages |s|^2 and y of a sample");
static_assert(THREADS == 16 * RS, "16 sample lanes x RS row groups");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// This thread's share of copying ROWS rows (pitch d, from row0) at columns
// [d0, d0 + DC) into dst (ROWS x LDS): one column slot, every STEP-th row.
// Rows from `valid` on and columns from d on are written as zeros.  Offsets
// within the tile are 32-bit (ROWS * d < 2^31), so that the copies' hoisted
// addresses take one register each.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* row0,
                                      int valid, int d0, int d, int tid) {
  constexpr int W = VEC ? 4 : 1;         // floats a copy
  constexpr int SLOTS = DC / W;          // copies a row
  constexpr int STEP = THREADS / SLOTS;  // rows between this thread's copies
  const int col = (tid % SLOTS) * W;
  const int r0 = tid / SLOTS;
  const bool col_in = d0 + col < d;
#pragma unroll
  for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
    const int r = r0 + k * STEP;
    if (ROWS % STEP == 0 || r < ROWS) {
      const bool in = col_in && r < valid;
      const float* src = in ? row0 + (r * d + d0 + col) : row0;
      if constexpr (VEC)
        cp_async16(dst + r * LDS + col, src, in ? 16 : 0);
      else
        cp_async4(dst + r * LDS + col, src, in ? 4 : 0);
    }
  }
}

template <int TN, int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    simvote_kernel(const float* __restrict__ x,
                   const int* __restrict__ block_cluster,
                   const int* __restrict__ row_offsets,
                   const int* __restrict__ block_offsets,
                   const float* __restrict__ s_pad,
                   const float* __restrict__ y_pad,
                   const float* __restrict__ inv2t2,
                   float* __restrict__ scores, int m, int d) {
  constexpr int BN = RS * TN;
  constexpr int BM = 16 * TM;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [2][BN][LDS]
  float* ss = xs + 2 * BN * LDS;                // [2][BM][LDS]
  __shared__ float xsq_s[BN], ssq_s[BM], y_s[BM];
  __shared__ float red[2][BN][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a warp spans 8 samples (tx) of 4 row groups (ty); rows ty + RS i,
  // samples tx + 16 j
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int cl = block_cluster[blockIdx.x];
  const int row0 = row_offsets[cl] + (blockIdx.x - block_offsets[cl]) * BN;
  const int rows = row_offsets[cl + 1] - row0;  // of this block, if < BN
  const float* xb = x + static_cast<size_t>(row0) * d;  // BN rows from here
  const float* s = s_pad + static_cast<size_t>(cl) * m * d;
  const float* y = y_pad + static_cast<size_t>(cl) * m;
  const float g = inv2t2[cl];
  const int chunks = (d + DC - 1) / DC;

  // sum w y and sum w of each row, from the two warps that share it
  for (int e = tid; e < 2 * BN * 2; e += THREADS) (&red[0][0][0])[e] = 0.f;
  float xq = 0.f;  // |x|^2 of row tid (first sample tile)

  for (int m0 = 0; m0 < m; m0 += BM) {
    const float* sb = s + static_cast<size_t>(m0) * d;
    float acc[TN][TM];
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    float sq = 0.f;  // |s|^2 of sample tid
    const bool first = m0 == 0;

    stage<BN, VEC>(xs, xb, rows, 0, d, tid);
    stage<BM, VEC>(ss, sb, m - m0, 0, d, tid);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      const int buf = ch & 1;
      const float* xc = xs + buf * BN * LDS;
      const float* sc = ss + buf * BM * LDS;
      if (ch + 1 < chunks) {
        stage<BN, VEC>(xs + (buf ^ 1) * BN * LDS, xb, rows, (ch + 1) * DC, d,
                       tid);
        stage<BM, VEC>(ss + (buf ^ 1) * BM * LDS, sb, m - m0, (ch + 1) * DC,
                       d, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // everything but the newest group has landed
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < DC; q += 4) {
        float4 xv[TN];
#pragma unroll
        for (int i = 0; i < TN; ++i)
          xv[i] = *reinterpret_cast<const float4*>(
              xc + (ty + RS * i) * LDS + q);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const float4 sv =
              *reinterpret_cast<const float4*>(sc + (tx + 16 * j) * LDS + q);
#pragma unroll
          for (int i = 0; i < TN; ++i) acc[i][j] = dot4(xv[i], sv, acc[i][j]);
        }
      }
      if (tid < BM) {
#pragma unroll
        for (int q = 0; q < DC; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sc + tid * LDS + q);
          sq = dot4(v, v, sq);
        }
      }
      if (first && tid < BN) {
#pragma unroll
        for (int q = 0; q < DC; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xc + tid * LDS + q);
          xq = dot4(v, v, xq);
        }
      }
      __syncthreads();  // the next copy overwrites this buffer
    }
    if (tid < BM) {
      ssq_s[tid] = sq;
      y_s[tid] = m0 + tid < m ? y[m0 + tid] : -1.f;
    }
    if (first && tid < BN) xsq_s[tid] = xq;
    __syncthreads();
    float num[TN], den[TN];
#pragma unroll
    for (int i = 0; i < TN; ++i) num[i] = den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const float yj = y_s[tx + 16 * j];
      if (yj < 0.f) continue;
      const float sj = ssq_s[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float d2 = fmaxf(xsq_s[ty + RS * i] - 2.f * acc[i][j] + sj, 0.f);
        const float w = expf(-d2 * g);
        num[i] += w * yj;
        den[i] += w;
      }
    }
    // sum over the tile's samples: the 8 lanes of a row group in a warp,
    // then into the row's slot for this warp (one writer a slot)
#pragma unroll
    for (int i = 0; i < TN; ++i) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        num[i] += __shfl_xor_sync(0xffffffffu, num[i], off);
        den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);
      }
      if ((lane & 7) == 0) {
        red[warp & 1][ty + RS * i][0] += num[i];
        red[warp & 1][ty + RS * i][1] += den[i];
      }
    }
  }
  __syncthreads();
  if (tid < BN && tid < rows) {
    const float nm = red[0][tid][0] + red[1][tid][0];
    const float dn = red[0][tid][1] + red[1][tid][1];
    scores[row0 + tid] = nm / fmaxf(dn, 1e-30f);
  }
}

template <int TN, int TM, bool VEC>
cudaError_t launch(const void* x, const void* block_cluster,
                   const void* row_offsets, const void* block_offsets,
                   const void* s_pad, const void* y_pad, const void* inv2t2,
                   void* scores, int n_blocks, int m, int d,
                   cudaStream_t stream) {
  auto kernel = simvote_kernel<TN, TM, VEC>;
  const int smem = 2 * (RS * TN + 16 * TM) * LDS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(block_cluster),
      static_cast<const int*>(row_offsets),
      static_cast<const int*>(block_offsets), static_cast<const float*>(s_pad),
      static_cast<const float*>(y_pad), static_cast<const float*>(inv2t2),
      static_cast<float*>(scores), m, d);
  return cudaGetLastError();
}

}  // namespace

// x (N, d) rows grouped by cluster; block_cluster (n_blocks,) the cluster of
// each block of block_rows (32 or 64) rows; row_offsets (C+1,) CSR row
// starts; block_offsets (C+1,) first block of each cluster; s_pad (C, m, d);
// y_pad (C, m) with -1 padding; inv2t2 (C,) = 1 / (2 tau^2).  All
// float32/int32, contiguous; vec 1 takes the 16-byte instantiation (d a
// multiple of 4, x and s_pad on 16 bytes), vec 0 the 4-byte one.  Writes
// scores (N,).
extern "C" int simvote_segmented(const void* x, const void* block_cluster,
                                 const void* row_offsets,
                                 const void* block_offsets, const void* s_pad,
                                 const void* y_pad, const void* inv2t2,
                                 void* scores, int n_blocks, int m, int d,
                                 int block_rows, int vec, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || d <= 0 || static_cast<long long>(BM_MAX) * d >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit tile offsets
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // samples a thread: the fewest of 4, 7 and 8 that cover m in as few
  // tiles as 8 would (at m 101 one tile of 112, not 128)
  const int tiles = (m + BM_MAX - 1) / BM_MAX;
  const int tm = 64 * tiles >= m ? 4 : 112 * tiles >= m ? 7 : 8;
  if (block_rows != 64 && block_rows != 32)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SIMVOTE(TN, TM)                                                 \
  (vec ? launch<TN, TM, true>(x, block_cluster, row_offsets, block_offsets,    \
                              s_pad, y_pad, inv2t2, scores, n_blocks, m, d, s) \
       : launch<TN, TM, false>(x, block_cluster, row_offsets, block_offsets,   \
                               s_pad, y_pad, inv2t2, scores, n_blocks, m, d,   \
                               s))
  cudaError_t err;
  if (block_rows == 64)
    err = tm == 4 ? REPRO_SIMVOTE(64 / RS, 4)
        : tm == 7 ? REPRO_SIMVOTE(64 / RS, 7) : REPRO_SIMVOTE(64 / RS, 8);
  else
    err = tm == 4 ? REPRO_SIMVOTE(32 / RS, 4)
        : tm == 7 ? REPRO_SIMVOTE(32 / RS, 7) : REPRO_SIMVOTE(32 / RS, 8);
#undef REPRO_SIMVOTE
  return static_cast<int>(err);
}
