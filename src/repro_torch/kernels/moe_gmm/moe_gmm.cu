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
// the sum in registers. Row counts are ragged (M = B*C slots of every batch
// row, any count: 2048, 160, 53, 8, 1). D and F must be multiples of 16.
// `live` (G bytes, or null) marks the experts that hold a token: a block of
// an expert with live[g] == 0 writes zeros and reads nothing. Such an
// expert's rows of xe are the dispatch's zero row, so the output is the
// same.
//
// Bound. At the serving prefill (G=16 experts, M=2048 slots, D=5120,
// F=8192, bf16) one call is 2 G M D F = 2.75 TFLOP against 2.21 GB of
// bytes: 2.78 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.66 ms at
// 3.35 TB/s, so operations bound it. At decode (M=8: one slot per batch
// row) the same call reads 1.34 GB of weights for 2.7 GFLOP: 0.40 ms at
// 3.35 TB/s with every expert live, so bytes bound it, and skipping the
// experts that hold no token (at least 8 of 16 at batch 8, top-1) cuts the
// bytes.
//
// bf16 design (Hopper TMA + wgmma, hopper.cuh): one 128 x 256 output tile
// per block of three warpgroups. One producer thread (its warpgroup
// otherwise idle, down to 40 registers) streams K tiles of 64
// through a ring of 4 shared-memory stages (48 KiB each: xe 128 x 64,
// K-major; w 64 x 256 as four 64-column boxes, F-major) with TMA, each
// stage guarded by a full and an empty mbarrier; 3-D tensor maps over
// (D, M, G) and (F, D, G) keep a box inside one expert, and TMA zero-fills
// the ragged M, D and F tails. Two consumer warpgroups each own 64 rows and
// run wgmma m64n256k16 (B through the transpose bit) with the f32 sum in
// 128 registers a thread, keeping one stage's products in flight while the
// next is issued; setmaxnreg moves registers from the producer to them. A
// warpgroup whose rows all lie past M issues no wgmma (decode: one of the
// two). At decode the 4 stages keep 128 KiB of weights in flight per SM,
// well above what the 3.35 TB/s bound needs. The epilogue rounds to bf16
// into a padded shared tile and writes rows of 16-byte stores, clipped at M
// and F.
//
// f32 design: CUDA-core FMA, no TF32 (the f32 parity checks need ~1e-5):
// 256 threads per 64x64 tile, 4x4 outputs per thread, D stepped 16 at a
// time through shared memory.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../hopper.cuh"

namespace {

struct Bf16Tile {
  static constexpr int BM = 128, BN = 256, BK = 64, kStages = 4;
  static constexpr int kConsumers = 2;                   // warpgroups of 64 rows
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
  static constexpr int A_BYTES = BM * BK * 2;            // 16 KiB, K-major
  static constexpr int B_BOX = BK * 64 * 2;              // 8 KiB: 64 columns
  static constexpr int B_BYTES = BN / 64 * B_BOX;        // 32 KiB, F-major
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int CS = BN + 8;                      // padded bf16 row of C
  static constexpr int SMEM = kStages * STAGE_BYTES + 1024;  // + alignment
};
static_assert(Bf16Tile::BM * Bf16Tile::CS * 2 <=
                  Bf16Tile::kStages * Bf16Tile::STAGE_BYTES,
              "the C tile reuses the ring");

__global__ void __launch_bounds__(Bf16Tile::kThreads, 1)
gmm_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                __nv_bfloat16* __restrict__ out,
                const uint8_t* __restrict__ live, int M, int D, int F) {
  using T = Bf16Tile;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int g = blockIdx.z;
  __nv_bfloat16* og = out + static_cast<long long>(g) * M * F;
  if (live != nullptr && !live[g]) {
    // an expert that holds no token: its rows of xe are zero, and so is out
    const int rows = min(T::BM, M - m0), chunks = min(T::BN, F - n0) / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += T::kThreads)
      *reinterpret_cast<uint4*>(og + static_cast<long long>(m0 + i / chunks) * F +
                                n0 + (i % chunks) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], T::kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int nk = (D + T::BK - 1) / T::BK;
  const int wg = threadIdx.x / 128;
  if (wg == T::kConsumers) {
    // producer: one thread keeps the ring full
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 128 * T::kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % T::kStages;
        if (t >= T::kStages) hopper::mbar_wait(&empty[s], (t / T::kStages - 1) & 1);
        uint8_t* a = smem + s * T::STAGE_BYTES;
        hopper::mbar_expect_tx(&full[s], T::STAGE_BYTES);
        hopper::tma_load_3d(a, &xmap, &full[s], t * T::BK, m0, g);
        for (int c = 0; c < T::BN / 64; ++c)
          hopper::tma_load_3d(a + T::A_BYTES + c * T::B_BOX, &wmap, &full[s],
                              n0 + 64 * c, t * T::BK, g);
      }
    }
  } else {
    hopper::reg_alloc<232>();
    float acc[T::BN / 2];
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
    const bool rows_live = m0 + 64 * wg < M;
    for (int t = 0; t < nk; ++t) {
      const int s = t % T::kStages;
      hopper::mbar_wait(&full[s], (t / T::kStages) & 1);
      if (rows_live) {
        const uint8_t* a = smem + s * T::STAGE_BYTES + wg * 64 * 128;
        const uint8_t* b = smem + s * T::STAGE_BYTES + T::A_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk)
          hopper::Wgmma<T::BN>::ss<1>(
              acc, hopper::make_desc(a + 32 * kk, 16, 1024, hopper::kB128),
              hopper::make_desc(b + 16 * 128 * kk, T::B_BOX, 1024, hopper::kB128), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done
      }
      if (t > 0 && threadIdx.x % 128 == 0)
        hopper::mbar_arrive(&empty[(t - 1) % T::kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // epilogue: bf16 into a padded shared tile over the ring (both consumer
    // warpgroups are done reading it), then rows of 16-byte stores
    hopper::named_barrier(1, 128 * T::kConsumers);
    if (rows_live) {
      __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem);
      const int tid = threadIdx.x % 128, lane = tid % 32;
      const int r = wg * 64 + (tid / 32) * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(ct + r * T::CS + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ct + (r + 8) * T::CS + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hopper::named_barrier(2 + wg, 128);
      for (int i = tid; i < 64 * (T::BN / 8); i += 128) {
        const int row = wg * 64 + i / (T::BN / 8), col = (i % (T::BN / 8)) * 8;
        if (m0 + row < M && n0 + col < F)
          *reinterpret_cast<uint4*>(og + static_cast<long long>(m0 + row) * F + n0 + col) =
              *reinterpret_cast<const uint4*>(ct + row * T::CS + col);
      }
    }
  }
}

struct F32Tile {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int kThreads = 256;     // 16 x 16 threads, 4x4 outputs each
  static constexpr int PAD = 4;
};

__global__ void __launch_bounds__(F32Tile::kThreads)
gmm_f32_kernel(const float* __restrict__ xe, const float* __restrict__ w,
               float* __restrict__ out, const uint8_t* __restrict__ live, int M,
               int D, int F) {
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
  // an expert that holds no token: its rows of xe are zero, and so is out
  const int d_end = live != nullptr && !live[g] ? 0 : D;
  for (int k0 = 0; k0 < d_end; k0 += T::BK) {  // D % 16 == 0: no ragged k tile
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


int launch_bf16(const void* xe, const void* w, void* out, const uint8_t* live,
                int G, int M, int D, int F, cudaStream_t stream) {
  using T = Bf16Tile;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(M),
                               static_cast<cuuint64_t>(G)};
  const cuuint64_t xstrides[2] = {2ull * D, 2ull * M * D};
  const cuuint32_t xbox[3] = {T::BK, T::BM, 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(G)};
  const cuuint64_t wstrides[2] = {2ull * F, 2ull * D * F};
  const cuuint32_t wbox[3] = {64, T::BK, 1};
  int err = hopper::make_bf16_map(&xmap, xe, 3, xdims, xstrides, xbox,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hopper::make_bf16_map(&wmap, w, 3, wdims, wstrides, wbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + T::BM - 1) / T::BM, (F + T::BN - 1) / T::BN, G);
  gmm_bf16_kernel<<<grid, T::kThreads, T::SMEM, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), live, M, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xe (G,M,D), w (G,D,F), out (G,M,F), all contiguous, 16-byte aligned and
// of one dtype (bf16 if bf16 != 0, else f32); D % 16 == 0, F % 16 == 0.
// live: G bytes on the device (nonzero: the expert holds a token), or null
// for all experts live.
extern "C" int moe_gmm_fwd(const void* xe, const void* w, void* out,
                           const void* live, int G, int M, int D, int F,
                           int bf16, void* stream) {
  if (G < 1 || M < 1 || D < 16 || F < 16 || D % 16 || F % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* lv = static_cast<const uint8_t*>(live);
  if (bf16) return launch_bf16(xe, w, out, lv, G, M, D, F, s);
  using T = F32Tile;
  const dim3 grid((F + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, G);
  gmm_f32_kernel<<<grid, T::kThreads, 0, s>>>(
      static_cast<const float*>(xe), static_cast<const float*>(w),
      static_cast<float*>(out), lv, M, D, F);
  return static_cast<int>(cudaGetLastError());
}
