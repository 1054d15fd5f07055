// K4: causal (optionally sliding-window) GQA prefill attention with an
// online f32 softmax.  q (B, H, Sq, hd); k, v (B, KV, Sk, hd); o (B, H, Sq,
// hd), each given by its batch, head and sequence strides with hd at
// stride 1, so the model's (B, S, H, hd) projections arrive as views and
// the output can be written where `.transpose(1, 2).reshape(B, S, -1)` is
// free.  Query head h reads KV head h / (H / KV).  Scale 1/sqrt(hd);
// masked scores are -1e30; the output is acc / max(l, 1e-30) in q's type.
//
// Replaces: flash_attention_pallas, src/repro/kernels/flash_attention/
// kernel.py:70 (pallas_call at :90, body _flash_kernel at :28).
//
// Bound on the H100 at the main-path shape (one oracle batch: B = 64,
// H = 32, KV = 8, S = 64, hd = 128, bf16, causal): 2,080 visible (q, k)
// pairs per head, 4*hd operations each, 2.2 GFLOP, 2.2 us at 989 TFLOP/s;
// q, k, v and o are 84 MB, 25 us at 3.35 TB/s.  So it is bound by bytes,
// and what stands between a kernel and that bound is keeping the score
// work off the CUDA cores and the loads wide and in flight.
//
// bfloat16 design (tensor cores).  One block per (q tile, KV head, batch)
// serves all G = H / KV query heads of the group: its R = G * BQ rows are
// (head g, position q0 + i) pairs, 16 rows to a warp, so each K/V tile is
// staged in shared memory once for all G heads.  A block holds at most
// 128 rows (8 warps): the f32 accumulator of hd 128 takes 64 registers a
// thread, a block of 8 warps keeps to 128 registers a thread, and two
// blocks share an SM, so one block's copies overlap the other's products
// and stores.  BQ is 64 where G * 64 rows fit and shrinks for larger G
// (32 at G = 4: 1,024 blocks at the record shape).  One block of 256 rows
// (16 warps) an SM was slower there, and so was a persistent block that
// walks several q tiles and prefetches the next tile's Q.
// Q (R x hd) and a double-buffered ring of K/V tiles of BK = 32 keys are
// copied with 16-byte cp.async.cg; the next tile's copy is in flight
// while this one is used.  Both products are mma.sync.m16n8k16 (bf16 in,
// f32 accumulate) fed by ldmatrix (V through ldmatrix.trans), in the
// register layout of FlashAttention-2: the S accumulator of Q.K^T becomes
// the A operand of P.V without a trip through shared memory (P is
// rounded to bf16 there; l sums the f32 p).  mma.sync and not wgmma: at
// this shape the products are 2.2 us of the 25 us byte bound, so the
// warpgroup pipeline would buy nothing that the byte traffic does not
// hide, and mma.sync keeps any R that is a multiple of 16.  The online
// softmax keeps m and l of each thread's two rows in f32 registers.  Rows
// are padded by 8 bf16 (16 bytes) so the 8 row addresses of an ldmatrix
// fall on distinct banks.  The output goes through the warp's own rows of
// the Q tile and leaves as 16-byte stores.
//
// Tile skipping: a block visits only the K/V tiles from the window's
// start to the diagonal of its last row, and a warp skips the products of
// a tile that is fully masked for all of its rows.  That gives the
// reference's result: a fully masked tile is, for a row, either past the
// diagonal (after the row's first visible key, where the reference's pass
// adds p = 0 and corr = 1) or wholly before the window (the reference's
// pass is wiped by the first visible key, corr = 0).  The static Pallas
// grid could not skip them (kernel.py:9-11).
//
// float32 keeps the FMA design (tensor cores would mean TF32, which the
// 2e-4 f32 tolerance rules out): one block per (q tile of 64 rows, head,
// batch), K/V tiles of 64 staged in shared memory, scores through a
// (64, 64) f32 tile, four threads to a row for the softmax and P.V.
//
// Both are templated over hd in {16, 32, 64, 128, 256}; above 48 KB of
// shared memory the launch opts in with cudaFuncSetAttribute.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct Strides {  // element strides of one (B, heads, S, hd) operand
  long long b, h, s;
};

__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal,
                                        int window) {
  return kp < Sk &&
         (!causal || (kp <= qp && (window <= 0 || kp > qp - window)));
}

// ------------------------------------------------------------ bfloat16

constexpr int TC_BK = 32;  // keys per K/V tile

template <int HD>
struct TcCfg {
  static constexpr int MAX_ROWS = 128;
  static constexpr int MAX_THREADS = MAX_ROWS * 2;  // 16 rows a warp
  static constexpr int LD = HD + 8;                 // row stride, elements
  static size_t bytes(int rows) {
    return static_cast<size_t>(rows + 4 * TC_BK) * LD * sizeof(__nv_bfloat16);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(TcCfg<HD>::MAX_THREADS)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                    Strides vs, Strides os, int G, int BQ, int Sq, int Sk,
                    int causal, int window, float scale) {
  constexpr int LD = TcCfg<HD>::LD;
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  constexpr int NT = TC_BK / 8;  // n-tiles of S
  constexpr int DT = HD / 8;     // n-tiles of the output
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + rows * LD;  // stage st: K at 2*st, V at 2*st + 1

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = G * BQ;  // rows past n_rows pad the last warp
  const bf16* qg = q + b * qs.b + static_cast<long long>(kvh) * G * qs.h;
  const bf16* kg = k + b * ks.b + kvh * ks.h;
  const bf16* vg = v + b * vs.b + kvh * vs.h;
  bf16* og = o + b * os.b + static_cast<long long>(kvh) * G * os.h;

  // Q tile: row r is head kvh * G + r / BQ at position q0 + r % BQ
  for (int c = tid; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    const int qp = q0 + r % BQ;
    const bool in = r < n_rows && qp < Sq;
    const bf16* src = in ? qg + (r / BQ) * qs.h + qp * qs.s + col : q;
    cp_async16(q_s + r * LD + col, src, in ? 16 : 0);
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / TC_BK;
  const int n_tiles = (k_end + TC_BK - 1) / TC_BK - t_begin;

  auto load_tile = [&](int t, int st) {
    const int k0 = (t_begin + t) * TC_BK;
    bf16* kd = kv_s + (2 * st) * TC_BK * LD;
    bf16* vd = kd + TC_BK * LD;
    for (int c = tid; c < TC_BK * CH; c += blockDim.x) {
      const int r = c / CH, col = (c % CH) * 8;
      const int kp = k0 + r;
      const bool in = kp < Sk;  // zeros past Sk keep 0 * v finite
      cp_async16(kd + r * LD + col, in ? kg + kp * ks.s + col : k,
                 in ? 16 : 0);
      cp_async16(vd + r * LD + col, in ? vg + kp * vs.s + col : v,
                 in ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();  // Q and the first tile

  // this thread's rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int wr0 = warp * 16;
  const int qpos[2] = {q0 + (wr0 + lane / 4) % BQ,
                       q0 + (wr0 + lane / 4 + 8) % BQ};
  // the warp's position range, for skipping fully masked tiles
  int qmin = INT_MAX, qmax = -1;
  for (int i = 0; i < 16; ++i) {
    const int r = wr0 + i, qp = q0 + r % BQ;
    if (r < n_rows && qp < Sq) {
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();

    const int k0 = (t_begin + t) * TC_BK;
    const bool skip =
        qmax < 0 ||
        (causal && (k0 > qmax ||
                    (window > 0 && k0 + TC_BK - 1 <= qmin - window)));
    if (!skip) {
      const bf16* kt = kv_s + (2 * (t & 1)) * TC_BK * LD;
      const bf16* vt = kt + TC_BK * LD;

      // S = Q K^T over the tile: (16 rows) x (TC_BK keys) a warp
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, q_s + (wr0 + (lane / 8 % 2) * 8 + lane % 8) * LD +
                           kc * 16 + (lane / 16) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + ((2 * jj + lane / 16) * 8 + lane % 8) * LD +
                              kc * 16 + (lane / 8 % 2) * 8);
          mma_bf16(s[2 * jj], a, bk[0], bk[1]);
          mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
        }
      }

      // mask, scale and the online softmax of the thread's two rows
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          const float val = visible(qpos[e / 2], kp, Sk, causal, window)
                                ? s[j][e] * scale
                                : NEG_INF;
          s[j][e] = val;
          mx[e / 2] = fmaxf(mx[e / 2], val);
        }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        corr[i] = expf(m_i[i] - m_new);
        m_i[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_i[e / 2]);
          s[j][e] = p;
          rs[e / 2] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l_i[i] = l_i[i] * corr[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }

      // acc += P V: S's accumulator tiles are P's A fragments
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane / 8 % 2) * 8 +
                                      lane % 8) * LD +
                                    dp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies into the Q tile have landed

  // epilogue: the warp's own 16 rows of the Q tile take the output, then
  // leave as 16-byte stores
  bf16* stage = q_s + wr0 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsafe = fmaxf(l_i[i], 1e-30f);
    bf16* row = stage + (lane / 4 + 8 * i) * LD + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * i] / lsafe, acc[j][2 * i + 1] / lsafe);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = wr0 + c / CH, col = (c % CH) * 8;
    const int qp = q0 + r % BQ;
    if (r < n_rows && qp < Sq)
      *reinterpret_cast<uint4*>(og + (r / BQ) * os.h + qp * os.s + col) =
          *reinterpret_cast<const uint4*>(stage + (c / CH) * LD + col);
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const Strides* st, int B, int H, int KV, int Sq, int Sk,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int MAX_ROWS = TcCfg<HD>::MAX_ROWS;
  const int G = H / KV;
  if (G > MAX_ROWS) return cudaErrorInvalidValue;
  // the q tile: 64 rows where G of them fit, fewer for larger G, and no
  // more than Sq rounded up to a warp's 16
  int bq = 64;
  while (bq > 16 && G * bq > MAX_ROWS) bq /= 2;
  if (G * bq > MAX_ROWS) bq = MAX_ROWS / G;
  bq = std::min(bq, std::max(16, (Sq + 15) / 16 * 16));
  const int rows = (G * bq + 15) / 16 * 16;
  auto kern = flash_tc_kernel<HD>;
  const size_t smem = TcCfg<HD>::bytes(rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, rows * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], G, bq, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- float32

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

template <int HD>
struct Tiles {
  // row stride in elements; the pad keeps lanes that read different rows
  // of the same column on distinct banks
  static constexpr int LD = HD + 1;
  static constexpr int PLD = BK + 1;
  static constexpr size_t bytes =
      static_cast<size_t>(BQ + 2 * BK) * LD * sizeof(float) +
      static_cast<size_t>(BQ) * PLD * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides qst, Strides kst, Strides vst, Strides ost,
                     int H, int KV, int Sq, int Sk, int causal, int window,
                     float scale) {
  using TL = Tiles<HD>;
  constexpr int LD = TL::LD;
  constexpr int PLD = TL::PLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float* qg = q + b * qst.b + h * qst.h;
  const float* kg = k + b * kst.b + kvh * kst.h;
  const float* vg = v + b * vst.b + kvh * vst.h;
  float* og = o + b * ost.b + h * ost.h;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    qs[r * LD + c] = (q0 + r < Sq) ? qg[(q0 + r) * qst.s + c] : 0.f;
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
      ks[r * LD + c] = in ? kg[(k0 + r) * kst.s + c] : 0.f;
      vs[r * LD + c] = in ? vg[(k0 + r) * vst.s + c] : 0.f;
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
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + dd];
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
        ps[(ty * 4 + i) * PLD + tx + 16 * j] =
            visible(qp, kp, Sk, causal, window) ? sc[i][j] * scale : NEG_INF;
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
        acc[j] = fmaf(p, vs[kk * LD + part + 4 * j], acc[j]);
    }
  }

  const int qp = q0 + pr;
  if (qp < Sq) {
    const float lsafe = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 4; ++j)
      og[qp * ost.s + part + 4 * j] = acc[j] / lsafe;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, int B, int H, int KV, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD>;
  const size_t smem = Tiles<HD>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], H, KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, const Strides* st, int B, int H, int KV, int Sq,
                   int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  if (dtype == repro::kFloat32)
    return launch_f32<HD>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window,
                          scale, stream);
  if (dtype == repro::kBFloat16)
    return launch_tc<HD>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window,
                         scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, KV, Sk, hd), o (B, H, Sq, hd), each at element
// strides (batch, head, sequence) from `strides` (12 values: q, k, v, o)
// with hd at stride 1; all float32 (dtype 0) or bfloat16 (dtype 1).  The
// bfloat16 path copies 16 bytes at a time: its pointers are 16-byte
// aligned and its strides multiples of 8.  window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KV, int Sq, int Sk, int hd, int causal,
                                   int window, int dtype,
                                   const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Sk <= 0 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  // the reference's scale: 1 / math.sqrt(hd) in double, used as float32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16:
      err = launch<16>(dtype, q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
      break;
    case 32:
      err = launch<32>(dtype, q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
      break;
    case 256:
      err = launch<256>(dtype, q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
