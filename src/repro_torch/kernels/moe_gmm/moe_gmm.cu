// Grouped (per-expert) matmul of the MoE FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gmm/moe_gmm.py::gmm (body
// _kernel). For xe (G,M,D) and w (G,D,F) it computes, for every group g,
//
//   out[g] = xe[g] @ w[g]                                   (G,M,F)
//
// with the products summed in f32 and one rounding to xe's dtype at the
// store (ref.gmm_reference). The TPU kernel carries the f32 sum over its
// sequential D grid axis in a VMEM scratch; here blocks run in no order, so
// each block owns one output tile and loops over the D tiles itself, with
// the sum in registers. Row tiles are ragged (M = B*C slots of every batch
// row, any count: 2048, 160, 53, 8, 1): rows >= M are zero-filled at the
// load and skipped at the store. D and F must be multiples of 16.
//
// Bound. At the serving prefill (G=16 experts, M=2048 slots, D=5120,
// F=8192, bf16) one call is 2 G M D F = 2.75 TFLOP against 2.21 GB of
// bytes: 2.78 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.66 ms at
// 3.35 TB/s, so operations bound it; the bf16 path therefore runs on the
// tensor cores (nvcuda::wmma 16x16x16 bf16 fragments, f32 accumulators;
// products of bf16 are exact in f32, so it differs from the plain version
// only in summation order). At decode (M=8: one slot per batch row) the
// same call reads 1.34 GB of weights for 2.7 GFLOP: 0.40 ms at 3.35 TB/s,
// so bytes bound it. There each weight byte is read once per call (every
// F tile of every group is one block, and xe's few rows are shared), the
// loads are 16-byte cp.async copies kept one tile ahead of the products,
// and a warp skips the fragments whose rows all lie past M, so the empty
// rows of a 128-row tile cost no tensor-core work. wgmma, TMA and warp
// specialisation are later work.
//
// bf16 design: 256 threads per 128x128 output tile, 8 warps of 64x32
// (4x2 fragments); D is stepped 32 at a time through two shared-memory
// stages (cp.async, zero-fill past M and D). The f32 tile goes through a
// 1 KiB per-warp shared buffer to bf16 and is written 16 bytes per lane.
//
// f32 design: CUDA-core FMA, no TF32 (the f32 parity checks need ~1e-5):
// 256 threads per 64x64 tile, 4x4 outputs per thread, D stepped 16 at a
// time through shared memory.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

struct Bf16Tile {
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
  static constexpr int WM = 64, WN = 32;   // warp tile
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int AS = BK + 8;        // padded shared row of A
  static constexpr int BS = BN + 8;        // padded shared row of B
};

struct F32Tile {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int kThreads = 256;     // 16 x 16 threads, 4x4 outputs each
  static constexpr int PAD = 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(Bf16Tile::kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ xe,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int M, int D, int F) {
  using T = Bf16Tile;
  __shared__ __align__(128) __nv_bfloat16 As[2][T::BM * T::AS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][T::BK * T::BS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const long long g = blockIdx.z;
  const __nv_bfloat16* xg = xe + g * M * D;
  const __nv_bfloat16* wg = w + g * D * F;

  auto load_tile = [&](int stage, int k0) {
    // A: 128 rows x 32 columns = 512 chunks of 8; B: 32 rows x 128 columns
#pragma unroll
    for (int c = tid; c < T::BM * T::BK / 8; c += T::kThreads) {
      const int row = c / (T::BK / 8), kc = (c % (T::BK / 8)) * 8;
      const bool ok = m0 + row < M && k0 + kc < D;
      const __nv_bfloat16* src = ok ? xg + (long long)(m0 + row) * D + k0 + kc : xg;
      cp_async16(&As[stage][row * T::AS + kc], src, ok);
    }
#pragma unroll
    for (int c = tid; c < T::BK * T::BN / 8; c += T::kThreads) {
      const int row = c / (T::BN / 8), nc = (c % (T::BN / 8)) * 8;
      const bool ok = k0 + row < D && n0 + nc < F;
      const __nv_bfloat16* src = ok ? wg + (long long)(k0 + row) * F + n0 + nc : wg;
      cp_async16(&Bs[stage][row * T::BS + nc], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // fragments (of 16 rows) of this warp that hold at least one row < M
  const int live = min(T::FM, max(0, (M - m0 - wm * T::WM + 15) / 16));
  const int nk = (D + T::BK - 1) / T::BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) {
      load_tile(stage ^ 1, (kt + 1) * T::BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[T::FN];
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[stage][kk * T::BS + wn * T::WN + j * 16], T::BS);
#pragma unroll
      for (int i = 0; i < T::FM; ++i) {
        if (i < live) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &As[stage][(wm * T::WM + i * 16) * T::AS + kk], T::AS);
#pragma unroll
          for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // epilogue: each fragment through a per-warp 16x16 f32 buffer (reusing A's
  // shared memory) to bf16, two lanes per row, 8 columns (16 bytes) a lane
  float* buf = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      const int row0 = m0 + wm * T::WM + i * 16, col0 = n0 + wn * T::WN + j * 16;
      if (i >= live || col0 >= F) continue;  // warp-uniform
      wmma::store_matrix_sync(buf, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (row0 + r < M) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16_rn(buf[r * 16 + c + q]);
        *reinterpret_cast<uint4*>(out + (g * M + row0 + r) * F + col0 + c) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(F32Tile::kThreads)
gmm_f32_kernel(const float* __restrict__ xe, const float* __restrict__ w,
               float* __restrict__ out, int M, int D, int F) {
  using T = F32Tile;
  __shared__ __align__(16) float As[T::BK][T::BM + T::PAD];  // A transposed
  __shared__ __align__(16) float Bs[T::BK][T::BN + T::PAD];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const long long g = blockIdx.z;
  const float* xg = xe + g * M * D;
  const float* wg = w + g * D * F;
  // one float4 of A (row ar, columns ak..ak+3) and one of B per thread
  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int br = tid / 16, bn = (tid % 16) * 4;
  const bool a_ok = m0 + ar < M, b_ok = n0 + bn < F;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += T::BK) {  // D % 16 == 0: no ragged k tile
    const float4 a = a_ok ? *reinterpret_cast<const float4*>(
                                xg + (long long)(m0 + ar) * D + k0 + ak)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = b_ok ? *reinterpret_cast<const float4*>(
                                wg + (long long)(k0 + br) * F + n0 + bn)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    As[ak][ar] = a.x;
    As[ak + 1][ar] = a.y;
    As[ak + 2][ar] = a.z;
    As[ak + 3][ar] = a.w;
    *reinterpret_cast<float4*>(&Bs[br][bn]) = b;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < T::BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar4[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= F) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < M)
      *reinterpret_cast<float4*>(out + (g * M + row) * F + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// xe (G,M,D), w (G,D,F), out (G,M,F), all contiguous, 16-byte aligned and
// of one dtype (bf16 if bf16 != 0, else f32); D % 16 == 0, F % 16 == 0.
extern "C" int moe_gmm_fwd(const void* xe, const void* w, void* out, int G,
                           int M, int D, int F, int bf16, void* stream) {
  if (G < 1 || M < 1 || D < 16 || F < 16 || D % 16 || F % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = Bf16Tile;
    const dim3 grid((F + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, G);
    gmm_bf16_kernel<<<grid, T::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xe),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, D, F);
  } else {
    using T = F32Tile;
    const dim3 grid((F + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, G);
    gmm_f32_kernel<<<grid, T::kThreads, 0, s>>>(
        static_cast<const float*>(xe), static_cast<const float*>(w),
        static_cast<float*>(out), M, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}
