// K1: k-means assignment, d = max(|x|^2 - 2 x.c + |c|^2, 0) with a fused
// min/argmin (ties to the lowest centroid index), f32 accumulation.
//
// Replaces: assign_clusters_pallas, src/repro/kernels/kmeans/kernel.py:37
// (pallas_call at :46, body _assign_kernel at :20).
//
// Bound on the H100 at the main-path shape (N = 50,000, D = 1024, K = 4,
// f32): x is read once, 205 MB, 61 us at 3.35 TB/s; the product is
// 2*N*K*D = 0.41 GFLOP, 6 us at 67 TFLOP/s (f32, no tensor cores).  So the
// kernel is bound by bytes: each element of x must be read once, in wide
// coalesced loads, with enough of them in flight to cover the latency of
// device memory, and no other unit (shared memory, shuffles) may be slower.
//
// Design: rows are streamed, not centroids.  Each warp owns one row at a
// time and its lanes span D: a lane reads 16 bytes (4 f32 or 8 bf16) a
// load, 128 bytes in flight before it computes, straight into registers.
// The block stages KR centroids once, in f32, into dynamic shared memory,
// computes their |c|^2 there, and then walks its rows grid-stride (a
// persistent grid of as many blocks as fit on the card), so the centroids
// are read from memory once a block, not once per tile of rows.  Each lane
// keeps KR partial dot products and |x|^2 of its slice of D in registers;
// one 16-byte shared-memory load of a centroid feeds 4 FMAs (f32), and the
// lanes of a warp read consecutive 16 bytes, so without bank conflicts.
// Warp shuffles then give every lane the row's KR distances, and lane 0
// keeps the lowest (the first index on ties).  K > KR runs in passes of KR
// centroids, in increasing index order; a later pass replaces the row's
// running best in assign/dmin only with a strictly smaller distance, and
// the same lane of the same block owns the row in every pass.
//
// KR is 1, 4, 8 or 16, the least of them that holds K, halved until the
// staged centroids take at most 64 KB (three blocks an SM; KR = 1 may take
// up to 227 KB, so D up to 58,048, the widest the wrapper passes).  When D is not a multiple of the
// vector width, or x does not start on 16 bytes, the
// wrapper picks the scalar instantiation (VEC = false) of the same kernel:
// one element a lane a load, still coalesced.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_BUDGET = 64 * 1024;  // three blocks an SM
constexpr size_t SMEM_MAX = 227 * 1024 - 256;

template <typename T, bool VEC>
struct Access;

// 16 bytes a lane a load
template <>
struct Access<float, true> {
  static constexpr int W = 4;
  __device__ static void load(const float* p, float (&v)[W]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Access<__nv_bfloat16, true> {
  static constexpr int W = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[W]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
// one element a lane a load
template <typename T>
struct Access<T, false> {
  static constexpr int W = 1;
  __device__ static void load(const T* p, float (&v)[W]) {
    v[0] = repro::to_f32(*p);
  }
};

// partial dot products of W elements of x with KR staged centroids
template <int KR, int W>
__device__ __forceinline__ void accumulate(const float (&xv)[W],
                                           const float* cs, int ld, int off,
                                           float (&acc)[KR], float& xsq) {
#pragma unroll
  for (int e = 0; e < W; ++e) xsq = fmaf(xv[e], xv[e], xsq);
#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const float* cr = cs + kk * ld + off;
    if constexpr (W == 1) {
      acc[kk] = fmaf(xv[0], cr[0], acc[kk]);
    } else {
#pragma unroll
      for (int e = 0; e < W; e += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cr + e);
        acc[kk] = fmaf(xv[e], c4.x, acc[kk]);
        acc[kk] = fmaf(xv[e + 1], c4.y, acc[kk]);
        acc[kk] = fmaf(xv[e + 2], c4.z, acc[kk]);
        acc[kk] = fmaf(xv[e + 3], c4.w, acc[kk]);
      }
    }
  }
}

template <typename T, bool VEC, int KR>
__global__ void __launch_bounds__(THREADS)
    assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  int* __restrict__ assign, float* __restrict__ dmin, int n,
                  int d, int k) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // (KR, d) f32
  __shared__ float csq[KR];
  using A = Access<T, VEC>;
  constexpr int W = A::W;
  constexpr int STEP = 32 * W;  // elements of a row a warp covers a load
  constexpr int U = W == 1 ? 8 : 32 / W;  // loads a lane keeps in flight
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_step = gridDim.x * WARPS;

  for (int k0 = 0; k0 < k; k0 += KR) {
    __syncthreads();  // the previous pass is done with cs
    for (int e = tid; e < KR * d; e += THREADS) {
      const int kk = e / d, gk = k0 + kk;
      cs[e] = gk < k ? repro::to_f32(c[static_cast<size_t>(gk) * d + e % d])
                     : 0.f;
    }
    __syncthreads();
    for (int kk = warp; kk < KR; kk += WARPS) {
      float s = 0.f;
      for (int dd = lane; dd < d; dd += 32) s = fmaf(cs[kk * d + dd],
                                                     cs[kk * d + dd], s);
      s = repro::warp_sum(s);
      if (lane == 0) csq[kk] = s;
    }
    __syncthreads();

    for (int row = blockIdx.x * WARPS + warp; row < n; row += row_step) {
      const T* xr = x + static_cast<size_t>(row) * d;
      float acc[KR];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) acc[kk] = 0.f;
      float xsq = 0.f;
      for (int base = lane * W; base < d; base += STEP * U) {
        float xv[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int off = base + u * STEP;
          if (off < d) A::load(xr + off, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int off = base + u * STEP;
          if (off < d) accumulate<KR, W>(xv[u], cs, d, off, acc, xsq);
        }
      }
      xsq = repro::warp_sum(xsq);
      float best = CUDART_INF_F;
      int best_k = 0;
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        const float dot = repro::warp_sum(acc[kk]);
        const float dv = fmaxf(xsq - 2.f * dot + csq[kk], 0.f);
        if (k0 + kk < k && dv < best) {
          best = dv;
          best_k = k0 + kk;
        }
      }
      if (lane == 0 && (k0 == 0 || best < dmin[row])) {
        assign[row] = best_k;
        dmin[row] = best;
      }
    }
  }
}

template <typename T, bool VEC, int KR>
cudaError_t launch(const void* x, const void* c, int* a, float* dm, int n,
                   int d, int k, cudaStream_t s) {
  auto kernel = assign_kernel<T, VEC, KR>;
  const size_t smem = sizeof(float) * KR * d;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  const int want = (n + WARPS - 1) / WARPS;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid > 0 ? grid : 1, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), a, dm, n, d, k);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_kr(const void* x, const void* c, int* a, float* dm,
                        int n, int d, int k, cudaStream_t s) {
  int kr = k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
  while (kr > 1 && sizeof(float) * kr * d > SMEM_BUDGET)
    kr = kr > 4 ? kr / 2 : 1;
  if (sizeof(float) * kr * d > SMEM_MAX) return cudaErrorInvalidValue;
  switch (kr) {
    case 1: return launch<T, VEC, 1>(x, c, a, dm, n, d, k, s);
    case 4: return launch<T, VEC, 4>(x, c, a, dm, n, d, k, s);
    case 8: return launch<T, VEC, 8>(x, c, a, dm, n, d, k, s);
    default: return launch<T, VEC, 16>(x, c, a, dm, n, d, k, s);
  }
}

}  // namespace

// x (n, d) and c (k, d), contiguous, in float32 (dtype 0) or bfloat16
// (dtype 1); vec 1 takes the 16-byte instantiation (d a multiple of 16
// bytes' elements and x on 16 bytes), vec 0 the scalar one.  Writes
// assign (n,) int32 and dmin (n,) float32.
extern "C" int kmeans_assign(const void* x, const void* c, void* assign,
                             void* dmin, int n, int d, int k, int dtype,
                             int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(assign);
  float* dm = static_cast<float*>(dmin);
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    err = vec ? dispatch_kr<float, true>(x, c, a, dm, n, d, k, s)
              : dispatch_kr<float, false>(x, c, a, dm, n, d, k, s);
  } else if (dtype == repro::kBFloat16) {
    err = vec ? dispatch_kr<__nv_bfloat16, true>(x, c, a, dm, n, d, k, s)
              : dispatch_kr<__nv_bfloat16, false>(x, c, a, dm, n, d, k, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
