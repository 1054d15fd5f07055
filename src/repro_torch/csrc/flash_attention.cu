// K4: causal (optionally sliding-window) GQA prefill attention with an
// online f32 softmax.  q (B, H, Sq, hd); k, v (B, KV, Sk, hd); query head h
// reads KV head h / (H / KV).  Scale 1/sqrt(hd); masked scores are -1e30;
// the output is acc / max(l, 1e-30) in q's type.
//
// Replaces: flash_attention_pallas, src/repro/kernels/flash_attention/
// kernel.py:70 (pallas_call at :90, body _flash_kernel at :28).
//
// Bound on the H100 at the main-path shape (one oracle batch: B = 64,
// H = 32, KV = 8, S = 64, hd = 128, bf16, causal): 2,080 visible (q, k)
// pairs per head, 4*hd operations each, 2.2 GFLOP, 2.2 us at 989 TFLOP/s;
// q, k, v and o are 84 MB, 25 us at 3.35 TB/s.  So it is bound by bytes at
// this shape, and the next cost is the score work done outside the
// tensor cores (this first version uses f32 FMAs; wgmma comes later).
//
// Design: one block per (q tile of BQ = 64 rows, head, batch).  The block
// loops over K/V tiles of BK = 64 staged in shared memory and skips the
// tiles that lie wholly above the diagonal or wholly before the window
// (the static Pallas grid could not skip them, kernel.py:9-11).  Skipping
// gives the reference's result: a skipped tile is fully masked for every
// row, and the reference's pass over it is either a no-op (after the
// row's first visible key) or wiped by the first visible key (corr = 0).
// Scores go through a (BQ, BK) f32 tile in shared memory; four threads
// share a row for the softmax and for the P.V update, and keep the row's
// m, l and hd/4 accumulators in registers.  Templated over hd in
// {16, 32, 64, 128, 256} and over float32 and bfloat16; above 48 KB of
// shared memory the launch opts in with cudaFuncSetAttribute.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

template <typename T, int HD>
struct Tiles {
  // row stride in elements; the pad keeps lanes that read different rows
  // of the same column on distinct banks
  static constexpr int LD = HD + (sizeof(T) == 4 ? 1 : 2);
  static constexpr int PLD = BK + 1;
  static constexpr size_t bytes =
      static_cast<size_t>(BQ + 2 * BK) * LD * sizeof(T) +
      static_cast<size_t>(BQ) * PLD * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KV, int Sq, int Sk, int causal, int window,
                     float scale) {
  using TL = Tiles<T, HD>;
  constexpr int LD = TL::LD;
  constexpr int PLD = TL::PLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * LD;
  T* vs = ks + BK * LD;
  float* ps = reinterpret_cast<float*>(vs + BK * LD);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qg = q + (static_cast<size_t>(b) * H + h) * Sq * HD;
  const T* kg = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const T* vg = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  T* og = o + (static_cast<size_t>(b) * H + h) * Sq * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    qs[r * LD + c] = (q0 + r < Sq) ? qg[static_cast<size_t>(q0 + r) * HD + c]
                                   : repro::from_f32<T>(0.f);
  }

  // scores: thread (ty, tx) owns rows ty*4+i and columns tx+16*j
  const int ty = tid / 16, tx = tid % 16;
  // softmax and P.V: four threads per row, each owning hd/4 columns
  const int pr = tid / 4, part = tid % 4;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Sk;
      const size_t off = static_cast<size_t>(k0 + r) * HD + c;
      ks[r * LD + c] = in ? kg[off] : repro::from_f32<T>(0.f);
      vs[r * LD + c] = in ? vg[off] : repro::from_f32<T>(0.f);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < HD; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = repro::to_f32(qs[(ty * 4 + i) * LD + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = repro::to_f32(ks[(tx + 16 * j) * LD + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + ty * 4 + i, kp = k0 + tx + 16 * j;
        const bool vis =
            kp < Sk &&
            (!causal || (kp <= qp && (window <= 0 || kp > qp - window)));
        ps[(ty * 4 + i) * PLD + tx + 16 * j] = vis ? sc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    float* prow = ps + pr * PLD;
    constexpr int PER = BK / 4;
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < PER; ++jj) mx = fmaxf(mx, prow[part * PER + jj]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < PER; ++jj) {
      const float p = expf(prow[part * PER + jj] - m_new);
      prow[part * PER + jj] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + rs;
    m_i = m_new;
    __syncwarp();  // the row's four writers share this warp

#pragma unroll
    for (int j = 0; j < HD / 4; ++j) acc[j] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j)
        acc[j] = fmaf(p, repro::to_f32(vs[kk * LD + part + 4 * j]), acc[j]);
    }
  }

  const int qp = q0 + pr;
  if (qp < Sq) {
    const float lsafe = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 4; ++j)
      og[static_cast<size_t>(qp) * HD + part + 4 * j] =
          repro::from_f32<T>(acc[j] / lsafe);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = Tiles<T, HD>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int KV, int Sq, int Sk,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, KV, Sk, hd), o (B, H, Sq, hd), contiguous, all
// float32 (dtype 0) or bfloat16 (dtype 1); window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KV, int Sq, int Sk, int hd, int causal,
                                   int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the reference's scale: 1 / math.sqrt(hd) in double, used as float32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  else if (dtype == repro::kBFloat16)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
