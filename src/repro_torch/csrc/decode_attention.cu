// K5: flash-decoding, one new query row per (batch, head) against an
// L-long KV cache.  q (B, H, hd); k, v (B, KV, L, hd) given by strides, so
// the model's (B, L, KV, hd) cache reaches the kernel as a permuted view
// with no copy; lengths (B,) int32.  Query head h reads KV head h / G,
// G = H / KV.  Slot l of row b is visible when l < lengths[b]; a masked
// score is -1e30.  Scale 1/sqrt(hd); the output is acc / max(l, 1e-30) in
// q's type.
//
// Replaces: decode_attention_pallas, src/repro/kernels/decode_attention/
// kernel.py:62 (pallas_call at :79, body _decode_kernel at :27).
//
// Bound on the H100 at the generate path's shape (B = 64, H = 32, KV = 8,
// hd = 128, L = 128, bf16): each (b, kv) pair reads its visible K/V prefix
// once for G = 4 query heads, about 4 operations per byte read, far below
// the card's ~295 bf16 operations per byte.  So it is bound by bytes:
// about 21 MB of K/V a step when every slot is visible, ~6 us at
// 3.35 TB/s.  At that size launch overhead and occupancy, not bandwidth,
// set this simple version's time.
//
// Design: one block per (kv head, batch row) holds the G query rows of
// that group in shared memory as f32 and streams the K/V tiles of
// [0, lengths[b]) through shared memory once for all G heads.  The Pallas
// grid (B, KV, nL) visited every tile; the block stops after the last
// visible one instead.  That gives the reference's result: a tile past
// lengths[b] is fully masked, and in the reference it is a no-op once the
// row's first visible key has set m (lengths >= 1 on the decode path).
// lengths[b] <= 0 visits every tile with every score masked, which gives
// the plain version's uniform average.  Per tile: (1) scores for the
// (G, BL) pairs, one pair per thread, into an f32 tile; (2) one warp per
// query head updates m and l online and turns the row into p; (3) each
// thread owns (g, d) outputs of the f32 accumulator, held in shared
// memory so that G needs no template parameter.  Templated over hd in
// {16, 32, 64, 128, 256} and float32 / bfloat16; above 48 KB of shared
// memory the launch opts in with cudaFuncSetAttribute.  Tensor cores, TMA
// and a split of L over blocks with a combine pass are later work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int BL = 64;  // cache slots per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

template <typename T, int HD>
struct Smem {
  // row stride in elements; the pad keeps lanes that read different rows
  // of the same column on distinct banks
  static constexpr int LD = HD + (sizeof(T) == 4 ? 1 : 2);
  static size_t bytes(int G) {
    return static_cast<size_t>(2 * BL) * LD * sizeof(T) +  // K, V tiles
           (static_cast<size_t>(2) * G * HD +               // q, acc
            static_cast<size_t>(G) * BL + 3 * G) *          // p; m, l, corr
               sizeof(float);
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      T* __restrict__ o, int H, int G, int L, long long sb,
                      long long sc, long long sl, float scale) {
  constexpr int LD = Smem<T, HD>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BL * LD;
  float* qs = reinterpret_cast<float*>(vs + BL * LD);
  float* acc = qs + G * HD;
  float* ps = acc + G * HD;
  float* m_s = ps + G * BL;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  // visible slots; a row with none averages all L, as the plain version
  const int n_rows = len <= 0 ? L : min(len, L);
  const T* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
  const T* kg = k + b * sb + kvh * sc;
  const T* vg = v + b * sb + kvh * sc;
  T* og = o + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;

  for (int e = tid; e < G * HD; e += THREADS) {
    qs[e] = repro::to_f32(qg[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (int t0 = 0; t0 < n_rows; t0 += BL) {
    const int rows = min(BL, n_rows - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BL * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const bool in = r < rows;
      const long long off = (t0 + r) * sl + c;
      ks[r * LD + c] = in ? kg[off] : repro::from_f32<T>(0.f);
      vs[r * LD + c] = in ? vg[off] : repro::from_f32<T>(0.f);
    }
    __syncthreads();

    // (1) scores: pair (g, j) per thread; lanes of a warp share g
    for (int e = tid; e < G * BL; e += THREADS) {
      const int g = e / BL, j = e % BL;
      const float* qrow = qs + g * HD;
      const T* krow = ks + j * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], repro::to_f32(krow[d]), s);
      ps[e] = (j < rows && t0 + j < len) ? s * scale : NEG_INF;
    }
    __syncthreads();

    // (2) online softmax, one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* prow = ps + g * BL;
      float mx = NEG_INF;
      for (int j = lane; j < BL; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BL; j += 32) {
        // slots past the tile's rows are no cache entries at all
        const float p = j < rows ? expf(prow[j] - m_new) : 0.f;
        prow[j] = p;
        sum += p;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc[g, d] = acc * corr + sum_j p[g, j] v[j, d]
    for (int e = tid; e < G * HD; e += THREADS) {
      const int g = e / HD, d = e % HD;
      const float* prow = ps + g * BL;
      float a = acc[e] * corr_s[g];
      for (int j = 0; j < rows; ++j)
        a = fmaf(prow[j], repro::to_f32(vs[j * LD + d]), a);
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += THREADS)
    og[e] = repro::from_f32<T>(acc[e] / fmaxf(l_s[e / HD], 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int H, int KV, int L,
                   long long sb, long long sc, long long sl, float scale,
                   cudaStream_t stream) {
  auto kern = decode_fwd_kernel<T, HD>;
  const int G = H / KV;
  const size_t smem = Smem<T, HD>::bytes(G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), H, G, L, sb, sc,
      sl, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* lengths, void* o, int B, int H, int KV,
                        int L, long long sb, long long sc, long long sl,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd) and o (B, H, hd) contiguous; k and v share the element
// strides sb (batch), sc (KV head) and sl (cache slot), with hd at stride
// 1; lengths (B,) int32 on the card; all float32 (dtype 0) or bfloat16
// (dtype 1).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int H, int KV, int L,
                                    int hd, long long sb, long long sc,
                                    long long sl, int dtype, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || L <= 0 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the reference's scale: 1 / math.sqrt(hd) in double, used as float32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = dispatch_hd<float>(hd, q, k, v, len, o, B, H, KV, L, sb, sc, sl, scale, s);
  else if (dtype == repro::kBFloat16)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, len, o, B, H, KV, L, sb, sc, sl, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
