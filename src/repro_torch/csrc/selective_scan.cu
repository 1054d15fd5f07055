// K6: Mamba-1's selective scan over a whole prefill, for every batch row b
// and channel d of d_inner, with d_state 16:
//   h = h0[b, d] (zeros when none); for t = 0 .. S - 1:
//     h[n] = exp(dt[b,t,d] A[d,n]) h[n] + (dt[b,t,d] x[b,t,d]) B[b,t,n]
//     y    = sum_n h[n] C[b,t,n] + D[d] x[b,t,d]
//     out[b,t,d] = y silu(z[b,t,d]) in x's type
//   h_last[b, d] = h.
// x, z, out (B, S, di) in float32 or bfloat16; dt (B, S, di), A (di, 16),
// D (di,), h0 and h_last (B, di, 16) float32, all contiguous; B and C
// (B, S, 16) float32 with the state at stride 1 and the element strides
// sb (batch) and st (time) shared by both (the gates' split of one
// product).  Every product, exponential and sum is float32, in the plain
// version's order along t.  The decay is exp2f(dt (A log2 e)), A scaled
// once as it is loaded: a full-precision exp2f (no fast math) costs about
// half the instructions of expf, which reduces its argument itself, and
// differs from the plain torch.exp(dt A) by a few units in the last place
// (h_last within 6e-7 of the plain version's, relative, at the engine's
// shape on the card).  The 16-term read-out may sum in another order.
//
// Replaces no Pallas kernel: the reference's mamba_scan is a
// lax.associative_scan over (B, chunk, di, 16) stacks (src/repro/models/
// layers.py:587).  The port's plain version steps that recurrence in torch
// and writes the (B, chunk, di, 16) decay and input tensors and every
// state to device memory, 16 times the bytes of its inputs.  K6 was added
// for the engine's prefill, where that scan took most of Jamba's device
// time.
//
// Bound on the H100: at the engine's batch (B 64, S 32, di 8,192) a
// call reads dt (f32), x and z (bf16) and writes y (bf16) and h_last
// (f32): about 0.20 GB, 0.06 ms at 3.35 TB/s; it takes 268 M exponentials
// (16 a state element and step), about 0.064 ms at the SFU's 16 a clock an
// SM.  So bytes bound it at small batch and the SFU's exponentials at
// large, and the two are close at the engine's shape: the kernel must
// stream its inputs at full width and keep the exponentials' unit busy,
// with nothing of the state ever leaving registers.
//
// Design: one thread a channel, 128 channels of one batch row a block
// (grid (di / 128, B): 4,096 blocks at the engine's shape).  A thread
// keeps h[16] and A[16] in registers.  The time steps' B_t and C_t, which
// every channel of a row shares, are staged in shared memory a tile of
// TT = 32 steps at a time by 4-byte cp.async (any strides), the next tile
// in flight while the block works on this one.  dt, x and z do not depend
// on h: a thread loads them a group of U = 4 steps ahead, coalesced
// (neighbouring threads on neighbouring channels), so their latency
// overlaps the current group's 16 x 4 exponentials.  At 96 registers a
// thread (U = 8 took 128) five blocks share an SM; more blocks, fewer
// threads a block or fewer steps ahead were no faster on the card.  Any S: the last tile
// and group are partial.  A channel past di (a partial last block) loads
// channel di - 1 and stores nothing.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int DS = 16;        // d_state
constexpr int THREADS = 128;  // channels a block
constexpr int TT = 32;        // time steps a staged tile of B and C
constexpr int U = 4;          // time steps a thread loads ahead
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TT % U == 0, "groups never straddle a tile");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const T* __restrict__ z, const float* __restrict__ A,
                          const float* __restrict__ Dp,
                          const float* __restrict__ h0, T* __restrict__ out,
                          float* __restrict__ h_last, int S, int di,
                          long long sb, long long st) {
  // [buffer][step][B_t (16) then C_t (16)]
  __shared__ __align__(16) float sbc[2][TT][2 * DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  const int dd = live ? d : di - 1;

  float a[DS], h[DS];
  {
    const float4* a4 = reinterpret_cast<const float4*>(A + (size_t)dd * DS);
    const float4* h4 =
        h0 ? reinterpret_cast<const float4*>(h0 + ((size_t)b * di + dd) * DS)
           : nullptr;
#pragma unroll
    for (int i = 0; i < DS / 4; ++i) {
      const float4 av = a4[i];  // A log2 e, for exp2f
      a[4 * i] = av.x * LOG2E, a[4 * i + 1] = av.y * LOG2E,
             a[4 * i + 2] = av.z * LOG2E, a[4 * i + 3] = av.w * LOG2E;
      const float4 hv = h4 ? h4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      h[4 * i] = hv.x, h[4 * i + 1] = hv.y, h[4 * i + 2] = hv.z,
             h[4 * i + 3] = hv.w;
    }
  }
  const float dskip = Dp[dd];
  const size_t base = (size_t)b * S * di + dd;  // element (b, 0, dd)
  const float* Bb = Bm + b * sb;
  const float* Cb = Cm + b * sb;

  // B_t, C_t of tile `tile` into buffer `buf`, as one commit group
  auto stage = [&](int tile, int buf) {
    const int t0 = tile * TT;
    const int tn = min(TT, S - t0);
    for (int i = threadIdx.x; i < tn * 2 * DS; i += THREADS) {
      const int t = i / (2 * DS), n = i % (2 * DS);
      const float* src = (n < DS ? Bb + n : Cb + (n - DS)) + (t0 + t) * st;
      cp_async4(&sbc[buf][t][n], src);
    }
    cp_async_commit();
  };
  // dt, x, z of steps g * U .. g * U + U - 1 (zeros past S)
  float ndt[U], nx[U], nz[U];
  auto fetch = [&](int g) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = g * U + u;
      const bool in = t < S;
      const size_t i = base + (size_t)(in ? t : 0) * di;
      ndt[u] = in ? dt[i] : 0.f;
      nx[u] = in ? repro::to_f32(x[i]) : 0.f;
      nz[u] = in ? repro::to_f32(z[i]) : 0.f;
    }
  };

  stage(0, 0);
  fetch(0);
  const int groups = (S + U - 1) / U;
  for (int g = 0; g < groups; ++g) {
    const int t0 = g * U;
    if (t0 % TT == 0) {
      const int tile = t0 / TT;
      __syncthreads();  // every thread is done with the buffer staged next
      if ((tile + 1) * TT < S) {
        stage(tile + 1, (tile + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile's B and C are visible to the block
    }
    float cdt[U], cx[U], cz[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cdt[u] = ndt[u], cx[u] = nx[u], cz[u] = nz[u];
    if (g + 1 < groups) fetch(g + 1);
    const float* bc = sbc[(t0 / TT) & 1][t0 % TT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u >= S) break;
      const float dtv = cdt[u], xv = cx[u];
      const float dtx = dtv * xv;
      const float4* b4 = reinterpret_cast<const float4*>(bc + u * 2 * DS);
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < DS / 4; ++i) {
        const float4 bv = b4[i], cv = b4[DS / 4 + i];
        const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * i + j;
          h[n] = fmaf(exp2f(dtv * a[n]), h[n], dtx * bn[j]);
          y = fmaf(h[n], cn[j], y);
        }
      }
      y += dskip * xv;
      const float zv = cz[u];
      const float gate = zv / (1.f + expf(-zv));
      if (live) out[base + (size_t)(t0 + u) * di] = repro::from_f32<T>(y * gate);
    }
  }
  if (live) {
    float4* o4 = reinterpret_cast<float4*>(h_last + ((size_t)b * di + d) * DS);
#pragma unroll
    for (int i = 0; i < DS / 4; ++i)
      o4[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const void* z, const void* A,
                   const void* Dp, const void* h0, void* out, void* h_last,
                   int B, int S, int di, long long sb, long long st,
                   cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, B);
  selective_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const T*>(z), static_cast<const float*>(A),
      static_cast<const float*>(Dp), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(h_last), S, di, sb, st);
  return cudaGetLastError();
}

}  // namespace

// See the note at the top for the layouts; h0 may be null.  dtype 0 is
// float32, 1 bfloat16 (x, z and out).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* Bm, const void* Cm,
                                  const void* z, const void* A,
                                  const void* Dp, const void* h0, void* out,
                                  void* h_last, int B, int S, int di,
                                  long long sb, long long st, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = launch<float>(x, dt, Bm, Cm, z, A, Dp, h0, out, h_last, B, S, di,
                        sb, st, s);
  else if (dtype == repro::kBFloat16)
    err = launch<__nv_bfloat16>(x, dt, Bm, Cm, z, A, Dp, h0, out, h_last, B,
                                S, di, sb, st, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
