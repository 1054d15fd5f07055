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
// 3.35 TB/s.  At that size the loads must be wide and many must be in
// flight at once, with no phases that wait on each other in between.
//
// Design: one block of 4 warps per (kv head, batch row) serves GT query
// heads of that group (GT = 8, 4, 2 or 1, the largest that divides G; a
// group of G > 8 heads takes G / GT blocks).  Nothing is staged in shared
// memory: each lane loads 16 bytes of a K row and of a V row straight
// from the strided cache into registers (LPR = hd * size / 16 lanes to a
// row, 16 lanes for hd 128 in bf16), dots them with the GT query rows it
// holds in f32 registers and sums the row's dot products with shuffles
// inside its lane group.  The visible slots [0, lengths[b]) are split
// across the warps' lane groups ("slots" of the block, 8 at hd 128 in
// bf16): slot w takes rows w, w + 8, ..., U = 4 of them with their loads
// in flight together (2 where the registers of GT = 8 leave no room).
// Each slot keeps its own (m, l, acc) per head in registers and updates
// them online; at the end the slots of a warp merge by shuffles and the
// warps merge in shared memory, the log-sum-exp merge a split-L combine
// pass would do.  At 128 registers a thread four blocks share an SM, so
// the generate shape's B * KV = 512 blocks run in one wave on 132 SMs
// (blocks of 8 warps, two an SM, were slower there), and L is not
// split over blocks; at long contexts and small batches (B * KV well
// under 4 * 132) a split of L would be needed.  The Pallas grid (B, KV,
// nL) visited every tile; the block stops after lengths[b] instead.  That
// gives the reference's result: a slot past lengths[b] is masked, and in
// the reference adds p = 0 once the row's first visible key has set m
// (lengths >= 1 on the decode path).  lengths[b] <= 0 visits every slot
// with every score masked, which gives the plain version's uniform
// average.  Templated over hd in {16, 32, 64, 128, 256}, float32 /
// bfloat16 and GT; the merge takes at most 33 KB of shared memory (GT = 8
// at hd 256).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

template <typename T, int HD, int GT>
struct Dec {
  static constexpr int VEC = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int CHUNKS = HD / VEC;     // 16-byte chunks in a row
  static constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;  // lanes a row
  static constexpr int CPL = CHUNKS / LPR;    // chunks a lane
  static constexpr int RPW = 32 / LPR;        // rows a warp takes at once
  static constexpr int NW = WARPS * RPW;      // row slots of the block
  static constexpr int U = GT * CPL >= 8 ? 2 : 4;  // rows a slot loads at once
  // the merge: acc (WARPS, GT, HD), then m and l (WARPS, GT)
  static constexpr size_t bytes = WARPS * GT * (HD + 2) * sizeof(float);
};

// 16 bytes as floats
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 pairs, low half first
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(THREADS, GT >= 8 ? 2 : 4)
    decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      T* __restrict__ o, int H, int G, int L, long long sb,
                      long long sc, long long sl, float scale) {
  using C = Dec<T, HD, GT>;
  constexpr int VEC = C::VEC, LPR = C::LPR, CPL = C::CPL, RPW = C::RPW;
  constexpr int NW = C::NW, U = C::U;
  extern __shared__ __align__(16) float red[];
  float* m_s = red + WARPS * GT * HD;
  float* l_s = m_s + WARPS * GT;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = lane / LPR, li = lane % LPR;  // lane group, lane in it
  const int per_kv = G / GT;
  const int kvh = blockIdx.x / per_kv;
  const int h0 = kvh * G + (blockIdx.x % per_kv) * GT;
  const int b = blockIdx.y;
  const int len = lengths[b];
  // visible slots; a row with none averages all L, as the plain version
  const int n_rows = len <= 0 ? L : min(len, L);
  const T* qg = q + (static_cast<size_t>(b) * H + h0) * HD;
  const T* kg = k + b * sb + kvh * sc;
  const T* vg = v + b * sb + kvh * sc;
  T* og = o + (static_cast<size_t>(b) * H + h0) * HD;

  // the lane's columns: chunk li + c * LPR of each row, c < CPL
  float qf[GT][CPL][VEC], acc[GT][CPL][VEC], m_i[GT], l_i[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m_i[g] = NEG_INF;
    l_i[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[g][c][e] = repro::to_f32(qg[g * HD + (li + c * LPR) * VEC + e]);
        acc[g][c][e] = 0.f;
      }
  }

  // warp-uniform loop: all lanes take part in the shuffles
  for (int base = warp * RPW; base < n_rows; base += NW * U) {
    uint4 kr[U][CPL], vr[U][CPL];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + rg + u * NW;
      in[u] = r < n_rows;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const long long off = r * sl + (li + c * LPR) * VEC;
        kr[u][c] = in[u] ? *reinterpret_cast<const uint4*>(kg + off)
                         : make_uint4(0, 0, 0, 0);
        vr[u][c] = in[u] ? *reinterpret_cast<const uint4*>(vg + off)
                         : make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float kf[VEC];
        unpack(kr[u][c], kf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s[u][g] = fmaf(qf[g][c][e], kf[e], s[u][g]);
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int off = LPR / 2; off; off >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
        s[u][g] = base + rg + u * NW < len ? s[u][g] * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (in[u]) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m_i[g], mx);
      const float corr = expf(m_i[g] - m_new);
      m_i[g] = m_new;
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // slots past n_rows are no cache entries at all
        p[u] = in[u] ? expf(s[u][g] - m_new) : 0.f;
        sum += p[u];
      }
      l_i[g] = l_i[g] * corr + sum;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][c][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float vf[VEC];
          unpack(vr[u][c], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][c][e] = fmaf(p[u], vf[e], acc[g][c][e]);
        }
    }
  }

  // merge the warp's lane groups, then the warps
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_i[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l_i[g], off);
      const float mm = fmaxf(m_i[g], mo);
      const float f = expf(m_i[g] - mm), fo = expf(mo - mm);
      l_i[g] = l_i[g] * f + lo * fo;
      m_i[g] = mm;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][c][e] = acc[g][c][e] * f +
                         __shfl_xor_sync(0xffffffffu, acc[g][c][e], off) * fo;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[(warp * GT + g) * HD + (li + c * LPR) * VEC + e] = acc[g][c][e];
      if (li == 0) {
        m_s[warp * GT + g] = m_i[g];
        l_s[warp * GT + g] = l_i[g];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < GT * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_s[w * GT + g]);
    float tot = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_s[w * GT + g] - mm);
      tot = fmaf(red[(w * GT + g) * HD + d], f, tot);
      lsum = fmaf(l_s[w * GT + g], f, lsum);
    }
    og[e] = repro::from_f32<T>(tot / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int H, int KV, int L,
                   long long sb, long long sc, long long sl, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Dec<T, HD, GT>::bytes;
  static_assert(smem <= 48 * 1024, "the merge needs no opt-in");
  const int G = H / KV;
  const dim3 grid(KV * (G / GT), B);
  decode_fwd_kernel<T, HD, GT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), H, G, L, sb, sc,
      sl, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* k, const void* v,
                       const int* lengths, void* o, int B, int H, int KV,
                       int L, long long sb, long long sc, long long sl,
                       float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G % 8 == 0)
    return launch<T, HD, 8>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
  if (G % 4 == 0)
    return launch<T, HD, 4>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
  if (G % 2 == 0)
    return launch<T, HD, 2>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
  return launch<T, HD, 1>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* lengths, void* o, int B, int H, int KV,
                        int L, long long sb, long long sc, long long sl,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 32:
      return dispatch_g<T, 32>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 64:
      return dispatch_g<T, 64>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    case 256:
      return dispatch_g<T, 256>(q, k, v, lengths, o, B, H, KV, L, sb, sc, sl, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd) and o (B, H, hd) contiguous; k and v share the element
// strides sb (batch), sc (KV head) and sl (cache slot), with hd at stride
// 1, 16-byte aligned rows (pointers on 16 bytes, strides multiples of 16
// bytes); lengths (B,) int32 on the card; all float32 (dtype 0) or
// bfloat16 (dtype 1).
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
