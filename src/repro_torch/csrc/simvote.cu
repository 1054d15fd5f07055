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
// cores); x is 203 MB, 61 us at 3.35 TB/s.  So it is bound by operations,
// and the (N x M) weight matrix must never reach device memory.
//
// Design: one block owns BN = 32 rows of one cluster.  The TPU version
// re-packed x on the host so that every row block held one cluster
// (kernel.py:129-134); here x stays as the caller grouped it, and each
// block finds its cluster through a device block->cluster table and its
// rows through CSR row offsets, masking the cluster's last, partial block.
// The block streams over the cluster's samples in tiles of BM = 32 (one
// per lane) and over D in chunks of DC = 128 through shared memory, and
// keeps two f32 accumulators (numerator, denominator) per row.  w <= 1, so
// no max-rebasing is needed; if every weight underflows the score is 0.
#include "common.cuh"

namespace {

constexpr int BN = 32;
constexpr int BM = 32;
constexpr int DC = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BN / WARPS;  // rows per warp

__global__ void __launch_bounds__(THREADS)
    simvote_kernel(const float* __restrict__ x,
                   const int* __restrict__ block_cluster,
                   const int* __restrict__ row_offsets,
                   const int* __restrict__ block_offsets,
                   const float* __restrict__ s_pad,
                   const float* __restrict__ y_pad,
                   const float* __restrict__ inv2t2,
                   float* __restrict__ scores, int m, int d) {
  __shared__ float xs[BN][DC];
  __shared__ float ss[BM][DC + 1];  // +1: lanes read distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = block_cluster[blockIdx.x];
  const int row0 = row_offsets[cl] + (blockIdx.x - block_offsets[cl]) * BN;
  const int row_end = row_offsets[cl + 1];
  const float* s = s_pad + static_cast<size_t>(cl) * m * d;
  const float* y = y_pad + static_cast<size_t>(cl) * m;
  const float g = inv2t2[cl];

  float num[RPW], den[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    num[i] = 0.f;
    den[i] = 0.f;
  }

  for (int m0 = 0; m0 < m; m0 += BM) {
    float acc[RPW], xsq[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      acc[i] = 0.f;
      xsq[i] = 0.f;
    }
    float ssq = 0.f;
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < BN * DC; e += THREADS) {
        const int r = e / DC, cc = e % DC;
        const int gr = row0 + r, gd = d0 + cc;
        xs[r][cc] = (gr < row_end && gd < d)
                        ? x[static_cast<size_t>(gr) * d + gd]
                        : 0.f;
      }
      for (int e = tid; e < BM * DC; e += THREADS) {
        const int r = e / DC, cc = e % DC;
        const int gm = m0 + r, gd = d0 + cc;
        ss[r][cc] = (gm < m && gd < d) ? s[static_cast<size_t>(gm) * d + gd]
                                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < DC; ++cc) {
        const float sv = ss[lane][cc];
        ssq = fmaf(sv, sv, ssq);
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          acc[i] = fmaf(xs[warp * RPW + i][cc], sv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        for (int cc = lane; cc < DC; cc += 32) {
          const float v = xs[warp * RPW + i][cc];
          xsq[i] = fmaf(v, v, xsq[i]);
        }
      }
      __syncthreads();
    }
    const int j = m0 + lane;
    const float yj = j < m ? y[j] : -1.f;
    const bool valid = yj >= 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float sx = repro::warp_sum(xsq[i]);
      const float d2 = fmaxf(sx - 2.f * acc[i] + ssq, 0.f);
      const float w = valid ? expf(-d2 * g) : 0.f;
      num[i] += repro::warp_sum(valid ? w * yj : 0.f);
      den[i] += repro::warp_sum(w);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gr = row0 + warp * RPW + i;
      if (gr < row_end) scores[gr] = num[i] / fmaxf(den[i], 1e-30f);
    }
  }
}

}  // namespace

// x (N, d) rows grouped by cluster; block_cluster (n_blocks,) the cluster of
// each BN-row block; row_offsets (C+1,) CSR row starts; block_offsets (C+1,)
// first block of each cluster; s_pad (C, m, d); y_pad (C, m) with -1
// padding; inv2t2 (C,) = 1 / (2 tau^2).  All float32/int32; writes scores (N,).
extern "C" int simvote_segmented(const void* x, const void* block_cluster,
                                 const void* row_offsets,
                                 const void* block_offsets, const void* s_pad,
                                 const void* y_pad, const void* inv2t2,
                                 void* scores, int n_blocks, int m, int d,
                                 void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  simvote_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(block_cluster),
      static_cast<const int*>(row_offsets),
      static_cast<const int*>(block_offsets), static_cast<const float*>(s_pad),
      static_cast<const float*>(y_pad), static_cast<const float*>(inv2t2),
      static_cast<float*>(scores), m, d);
  return static_cast<int>(cudaGetLastError());
}
