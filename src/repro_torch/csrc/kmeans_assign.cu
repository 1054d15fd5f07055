// K1: k-means assignment, d = max(|x|^2 - 2 x.c + |c|^2, 0) with a fused
// min/argmin (ties to the lowest centroid index), f32 accumulation.
//
// Replaces: assign_clusters_pallas, src/repro/kernels/kmeans/kernel.py:37
// (pallas_call at :46, body _assign_kernel at :20).
//
// Bound on the H100 at the main-path shape (N = 50,000, D = 1024, K = 4,
// f32): x is read once, 205 MB, 61 us at 3.35 TB/s; the product is
// 2*N*K*D = 0.41 GFLOP, 6 us at 67 TFLOP/s (f32, no tensor cores).  So the
// kernel is bound by bytes, and what matters is reading x once, coalesced.
//
// Design: the TPU kernel kept all of D and K in one VMEM tile
// (kernel.py:7-8); shared memory cannot hold that at D = 4096.  Each block
// takes BN = 32 rows and loops over D in chunks of DC = 128 staged in shared
// memory, accumulating a (BN, KC) f32 tile in registers: one centroid per
// lane, four rows per warp.  K > 32 runs in passes of KC = 32 centroids,
// each with its own min/argmin epilogue (warp shuffles), and the running
// best per row keeps the lowest index on ties because passes go in
// increasing index order and only a strictly smaller distance replaces it.
// For K <= 32 every element of x is read from device memory once.
#include "common.cuh"

namespace {

constexpr int BN = 32;
constexpr int KC = 32;
constexpr int DC = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BN / WARPS;  // rows per warp

template <typename T>
__global__ void __launch_bounds__(THREADS)
    assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  const float* __restrict__ csq, int* __restrict__ assign,
                  float* __restrict__ dmin, int n, int d, int k) {
  __shared__ float xs[BN][DC];
  __shared__ float cs[KC][DC + 1];  // +1: lanes read distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BN;

  float best_d[RPW];
  int best_k[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    best_d[i] = CUDART_INF_F;
    best_k[i] = 0;
  }

  for (int k0 = 0; k0 < k; k0 += KC) {
    float acc[RPW];
    float xsq[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      acc[i] = 0.f;
      xsq[i] = 0.f;
    }
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < BN * DC; e += THREADS) {
        const int r = e / DC, cc = e % DC;
        const int gr = row0 + r, gd = d0 + cc;
        xs[r][cc] = (gr < n && gd < d)
                        ? repro::to_f32(x[static_cast<size_t>(gr) * d + gd])
                        : 0.f;
      }
      for (int e = tid; e < KC * DC; e += THREADS) {
        const int r = e / DC, cc = e % DC;
        const int gk = k0 + r, gd = d0 + cc;
        cs[r][cc] = (gk < k && gd < d)
                        ? repro::to_f32(c[static_cast<size_t>(gk) * d + gd])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < DC; ++cc) {
        const float cv = cs[lane][cc];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          acc[i] = fmaf(xs[warp * RPW + i][cc], cv, acc[i]);
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
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float sx = repro::warp_sum(xsq[i]);
      const int gk = k0 + lane;
      float dv = gk < k ? fmaxf(sx - 2.f * acc[i] + csq[gk], 0.f)
                        : CUDART_INF_F;
      int kv = gk;
      for (int off = 16; off; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, dv, off);
        const int ok = __shfl_xor_sync(0xffffffffu, kv, off);
        if (od < dv || (od == dv && ok < kv)) {
          dv = od;
          kv = ok;
        }
      }
      if (dv < best_d[i]) {
        best_d[i] = dv;
        best_k[i] = kv;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gr = row0 + warp * RPW + i;
      if (gr < n) {
        assign[gr] = best_k[i];
        dmin[gr] = best_d[i];
      }
    }
  }
}

}  // namespace

// x (n, d) and c (k, d) in float32 (dtype 0) or bfloat16 (dtype 1); csq (k,)
// float32 = |c|^2; writes assign (n,) int32 and dmin (n,) float32.
extern "C" int kmeans_assign(const void* x, const void* c, const void* csq,
                             void* assign, void* dmin, int n, int d, int k,
                             int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cq = static_cast<const float*>(csq);
  int* a = static_cast<int*>(assign);
  float* dm = static_cast<float*>(dmin);
  if (dtype == repro::kFloat32) {
    assign_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(c), cq, a, dm,
        n, d, k);
  } else if (dtype == repro::kBFloat16) {
    assign_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(c), cq, a, dm, n, d, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
