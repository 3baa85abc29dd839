// RWKV6 ("Finch") WKV scan (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/rwkv6_scan.py::wkv6_pallas
// (body _kernel). For r, k, log_w (B,L,H,K), v (B,L,H,V), u (H,K) and an
// initial state S (B,H,K,V) it runs, per (batch, head), the recurrence
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(log_w_t)
//
// y is written in r's dtype, the final state in f32. Dispatch is by dtype:
// bf16 runs the chunked tensor-core kernel, f32 the step kernel.
//
// Bound: bytes. At the serving shape (B=8, L=2048, H=40, K=V=64, bf16
// r/k/v/log_w) the function reads r, k, v, log_w (84 MB each) and the f32
// state and writes y and the state: 410 MiB, 0.128 ms at 3.35 TB/s. In the
// chunked form (chunks of 64) its products are 16.1 GFLOP, 0.016 ms on the
// bf16 tensor cores; the step form's 13.6 GFLOP of f32 FMA would take
// 0.203 ms on the CUDA cores (the f32 kernel's bound).
//
// bf16 design: the chunked form on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate), every decay a product of per-step factors
// w <= 1, never an exp of a cumsum difference, so nothing overflows at any
// decay (log_w below -40 included) and nothing cancels. One block of 8
// warps per (batch, head) walks the sequence in chunks of 32 steps (its own
// chunking: the form is exact in any, so the caller's Q only decides which
// prompts are accepted) with the (K,V) state in f32 registers. Rows past L
// are loaded as zeros (r = k = v = 0, log_w = 0), which leaves y and the
// state unchanged, so any L runs. Per chunk, in 8-step blocks I, with
// rl_t = r_t prod_{I's start <= s < t} w_s and kl_j = k_j prod_{j < s <=
// J's end} w_s (ref.wkv6_subchunked with chunk=32, sub=8 is this
// arrangement in plain PyTorch):
//  - cp.async brings the next chunk's r, k, v, log_w into the other stage
//    of a two-stage ring while this one is computed;
//  - scan: one thread per (block, channel) forms w, rl, kl and the block's
//    total product, then a table of the products of whole blocks before,
//    after and between, and the bonus r_t . (u k_t) of each step;
//  - A below the diagonal blocks (t in I, j in J < I): A[t,j] = sum_k rl_t
//    (totals between J and I) kl_j, in 16-row by 8-column tiles;
//  - A on the diagonal blocks, exactly in f32 on the CUDA cores: A[t,j] =
//    sum_k r_t k_j prod_{j<s<t} w_s by a running product, each 16-lane
//    group pairing columns j and 6 - j so that no lane idles, and a
//    transposing butterfly for the sums over the lanes' channels;
//  - y = (rl_t times the totals before I) @ S + A v, the first operand
//    formed once a chunk as a bf16 hi + lo tile that every warp loads with
//    ldmatrix;
//  - S <- diag(prod w) S + (kl_j times the totals after J)^T v.
// Precision: the state is held to 1e-4 in bf16 runs too, and one bf16
// rounding of an f32 operand (2^-9) fails that. Operands that arrive in
// bf16 (v) are exact; every f32 operand is split into bf16 terms: the
// state update's decayed k in three (hi + mid + lo, ~2^-24) against exact
// v; the carry-in and A in hi + lo, three passes (hi hi, hi lo, lo hi) or
// two against v (~2^-16). The state that the carry-in reads is written to
// shared memory as bf16 hi + lo each chunk.
// Threads: warp w owns rows 16 (w / 4).. of y and a quarter of its columns,
// and rows 16 (w / 2).. of the state and half of its columns. 106 KiB of
// shared memory and at most 128 registers a thread, so two blocks share an
// SM: the 320 blocks of the serving shape run in 1.2 waves. Instruction
// issue and the six barriers a chunk bound it, not bytes or the tensor
// cores: taking out any one phase (the scan, either half of A, the
// carry-in, the state update) saves 0.04-0.11 ms of 0.73 (PERF.md).
//
// f32 design: the exact per-step recurrence in f32 (ref.wkv6_naive), which
// keeps the JAX tests' 1e-4. The bonus term is split off: y_t = r_t .
// S_{t-1} + a_t v_t with the scalar a_t = sum_k r_t[k] u[k] k_t[k], formed
// once per step for all v. One block per (batch, head) loops over the
// sequence with the (K,V) state in registers: warp w owns rows [16 kg,
// 16 kg + 16) of the state, kg = w / (V/32), and column v = 32 (w % (V/32))
// + lane, 16 f32 values a thread (8 warps at K=V=64). Per tile of kTile
// steps the block stages r, k, w = exp(log_w) and v as f32 in shared
// memory with coalesced loads and forms a_t. Then every warp runs the
// tile's steps on its own slice without a barrier: each step reads its 16
// r, k and w as float4 broadcasts (one address per warp) and one v, and
// writes its partial y_t[v] over its 16 rows to shared memory. After one
// barrier the block sums the K/16 partials, adds a_t v_t and writes y. The
// tiles take 64 KiB of shared memory at K=V=64, so three blocks fit on an
// SM and the 320 blocks of the serving shape are all resident at once.
//
// ptxas (sm_90a, -O3; chip_smoke.py prints the report of each build):
// registers and spills of both kernels are in PERF.md.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../hopper.cuh"

namespace {

constexpr int kTile = 32;  // steps staged per tile (independent of the chunk)
constexpr int kRows = 16;  // state rows (k) per thread

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const float* u;    // (H,K) contiguous
  const float* s0;   // (B,H,K,V) contiguous
  void* y;           // (B,L,H,V) contiguous
  float* s_out;      // (B,H,K,V) contiguous
  int B, L, H;
  long long rs[3], ks[3], vs[3], ws[3];  // (batch, seq, head) strides
  int bf16;     // r, k, v and y are bf16 (else f32)
  int lw_bf16;  // log_w is bf16 (else f32)
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int K>
constexpr size_t smem_bytes() {
  // R, Kk, W [kTile][K]; Vv [kTile][K]; Yp [K/16][kTile][K]; A [kTile]; U [K]
  return sizeof(float) * (4 * kTile * K + (K / kRows) * kTile * K + kTile + K);
}

template <int K>
__global__ void __launch_bounds__(32 * (K / kRows) * (K / 32), 3)
wkv6_scan_kernel(const Params p) {
  constexpr int V = K;
  constexpr int NVG = V / 32;                  // column groups of 32
  constexpr int NW = (K / kRows) * NVG;        // warps
  constexpr int kThreads = 32 * NW;
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                   // [kTile][K]
  float* Kk = R + kTile * K;         // [kTile][K]
  float* W = Kk + kTile * K;         // [kTile][K]  exp(log_w)
  float* Vv = W + kTile * K;         // [kTile][V]
  float* Yp = Vv + kTile * V;        // [K/16][kTile][V]  partial y per row group
  float* A = Yp + (K / kRows) * kTile * V;  // [kTile]  a_t = sum_k r u k
  float* U = A + kTile;              // [K]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp / NVG, col = (warp % NVG) * 32 + lane;
  const int bi = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const long long bh = static_cast<long long>(bi) * p.H + h;

  for (int i = tid; i < K; i += kThreads) U[i] = p.u[h * K + i];
  float s[kRows];
  const float* s0 = p.s0 + bh * K * V;
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = s0[(kg * kRows + i) * V + col];

  const long long rb = bi * p.rs[0] + h * p.rs[2];
  const long long kb = bi * p.ks[0] + h * p.ks[2];
  const long long vb = bi * p.vs[0] + h * p.vs[2];
  const long long wb = bi * p.ws[0] + h * p.ws[2];

  for (int l0 = 0; l0 < p.L; l0 += kTile) {
    const int n = min(kTile, p.L - l0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < n * K; e += kThreads) {
      const int t = e / K, i = e % K;
      const long long l = l0 + t;
      R[e] = load(p.r, rb + l * p.rs[1] + i, p.bf16);
      Kk[e] = load(p.k, kb + l * p.ks[1] + i, p.bf16);
      W[e] = expf(load(p.lw, wb + l * p.ws[1] + i, p.lw_bf16));
      Vv[e] = load(p.v, vb + l * p.vs[1] + i, p.bf16);
    }
    __syncthreads();
    // a_t = sum_k r_t[k] u[k] k_t[k]: one warp per step, lanes over k
    for (int t = warp; t < n; t += NW) {
      float a = 0.f;
#pragma unroll
      for (int i = lane; i < K; i += 32) a = fmaf(R[t * K + i] * U[i], Kk[t * K + i], a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) A[t] = a;
    }
    // the steps: y_t[col] over the rows of kg from S_{t-1}, then the update
    const int r0 = kg * kRows;
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float vv = Vv[t * V + col];
      const float* rt = R + t * K + r0;
      const float* kt = Kk + t * K + r0;
      const float* wt = W + t * K + r0;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; j += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + j);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + j);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + j);
        y0 = fmaf(r4.x, s[j], y0);
        y1 = fmaf(r4.y, s[j + 1], y1);
        y0 = fmaf(r4.z, s[j + 2], y0);
        y1 = fmaf(r4.w, s[j + 3], y1);
        s[j] = fmaf(s[j], w4.x, k4.x * vv);
        s[j + 1] = fmaf(s[j + 1], w4.y, k4.y * vv);
        s[j + 2] = fmaf(s[j + 2], w4.z, k4.z * vv);
        s[j + 3] = fmaf(s[j + 3], w4.w, k4.w * vv);
      }
      Yp[(kg * kTile + t) * V + col] = y0 + y1;
    }
    __syncthreads();
    // y_t = sum of the row groups' partials + a_t v_t
    for (int e = tid; e < n * V; e += kThreads) {
      const int t = e / V, c = e % V;
      float out = A[t] * Vv[e];
#pragma unroll
      for (int g = 0; g < K / kRows; ++g) out += Yp[(g * kTile + t) * V + c];
      const long long idx = ((static_cast<long long>(bi) * p.L + l0 + t) * p.H + h) * V + c;
      if (p.bf16) {
        static_cast<__nv_bfloat16*>(p.y)[idx] = __float2bfloat16_rn(out);
      } else {
        static_cast<float*>(p.y)[idx] = out;
      }
    }
  }

  float* s_out = p.s_out + bh * K * V;
#pragma unroll
  for (int i = 0; i < kRows; ++i) s_out[(kg * kRows + i) * V + col] = s[i];
}

template <int K>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<K>();
  constexpr int threads = 32 * (K / kRows) * (K / 32);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_scan_kernel<K><<<p.B * p.H, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the chunked form on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

// Timing builds only: benchmarks/bench_port_scan_ablation.py compiles this
// file with -DABLATE=<mask> to leave phases of the bf16 kernel out and read
// what each one costs; such a build computes wrong results. Without the
// flag ABLATE is 0 and every phase runs.
#ifndef ABLATE
#define ABLATE 0
#endif
enum : unsigned {
  kNoScan = 1, kNoOffDiag = 2, kNoDiag = 4, kNoCarryIn = 8, kNoAV = 16, kNoStateUpdate = 32,
  kOnePass = 64,  // every f32 operand rounded to one bf16 term
};
__host__ __device__ constexpr bool ablated(unsigned phase) { return (ABLATE & phase) != 0; }

template <int K>
struct Bf16Tile {
  static constexpr int QC = 32, SUB = 8, NSUB = QC / SUB;  // steps a chunk, a block
  static constexpr int NPAIR = NSUB * (NSUB - 1) / 2;     // pairs of blocks J < I
  static constexpr int kThreads = 256;                      // 8 warps, two blocks an SM
  static constexpr int RB = K + 8;   // row stride (elements) of the bf16 r, k, v, S tiles
  static constexpr int RF = K + 4;   // row stride of the f32 log_w, w, rl, kl tiles
  static constexpr int AF = QC + 4;  // row stride of the f32 A tile
  static constexpr int TILE_B = QC * RB * 2, TILE_F = QC * RF * 4;
  // r, k, v; log_w as f32 rows of RF or bf16 rows of RB
  static constexpr int STAGE = 3 * TILE_B + TILE_F;
  // stages; w, rl, kl; TOT, PT, ST; MID; A; carry-in operand hi, lo;
  // state hi, lo; u
  static constexpr int SMEM = 2 * STAGE + 3 * TILE_F + 3 * NSUB * K * 4 + NPAIR * K * 4 +
                              QC * AF * 4 + 2 * TILE_B + 2 * K * RB * 2 + K * 4;
};

__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// 16 bytes from global to shared memory, or zeros (src_bytes = 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the cp.async loads of rows l0.. of one (B,L,H,*) tensor into a
// tile of QC rows of row_bytes each; rows past L are zeros.
template <int QC>
__device__ __forceinline__ void load_tile(uint8_t* tile, int row_bytes, const uint8_t* base,
                                          long long row_stride, int pieces, int l0, int L,
                                          int threads) {
  for (int e = threadIdx.x; e < QC * pieces; e += threads) {
    const int t = e / pieces, piece = e % pieces;
    const bool live = l0 + t < L;
    cp_async16(tile + t * row_bytes + piece * 16,
               base + (live ? (l0 + t) * row_stride : 0) + piece * 16, live ? 16 : 0);
  }
}

// Issues the loads of the chunk at l0 into a stage: r, k and v in bf16 rows
// of RB elements, log_w in its own dtype. Rows past L are zeros (r = k =
// v = 0 and log_w = 0 leave y and the state as they are).
template <int K>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const Params& p, int bi, int h,
                                           int l0) {
  using T = Bf16Tile<K>;
  constexpr int CH = K * 2 / 16;  // 16-byte pieces of a bf16 row
  const auto at = [=](const void* t, long long b_stride, long long h_stride) {
    return static_cast<const uint8_t*>(t) + 2 * (bi * b_stride + h * h_stride);
  };
  load_tile<T::QC>(stage, T::RB * 2, at(p.r, p.rs[0], p.rs[2]), 2 * p.rs[1], CH, l0, p.L,
                   T::kThreads);
  load_tile<T::QC>(stage + T::TILE_B, T::RB * 2, at(p.k, p.ks[0], p.ks[2]), 2 * p.ks[1], CH,
                   l0, p.L, T::kThreads);
  load_tile<T::QC>(stage + 2 * T::TILE_B, T::RB * 2, at(p.v, p.vs[0], p.vs[2]), 2 * p.vs[1],
                   CH, l0, p.L, T::kThreads);
  const int esz = p.lw_bf16 ? 2 : 4;
  load_tile<T::QC>(stage + 3 * T::TILE_B, p.lw_bf16 ? T::RB * 2 : T::RF * 4,
                   static_cast<const uint8_t*>(p.lw) + esz * (bi * p.ws[0] + h * p.ws[2]),
                   esz * p.ws[1], K * esz / 16, l0, p.L, T::kThreads);
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Writes a warp's state fragment (rows k0, k0 + 8; NT n8 tiles from column
// v0) to the bf16 hi and lo tiles that the next chunk's carry-in reads.
template <int K, int NT>
__device__ __forceinline__ void store_state(const float (&st)[NT][4], __nv_bfloat16* SH,
                                            __nv_bfloat16* SL, int k0, int v0) {
  constexpr int RB = Bf16Tile<K>::RB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int off = (k0 + 8 * hh) * RB + v0 + 8 * nt;
      uint32_t hi, lo;
      hopper::split2(st[nt][2 * hh], st[nt][2 * hh + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(SH + off) = hi;
      *reinterpret_cast<uint32_t*>(SL + off) = lo;
    }
}

// mma B fragments of the NT n8 tiles from column v0, for the k-step of rows
// r0..r0+15 of a row-major bf16 tile whose rows are the k dimension.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const __nv_bfloat16* tile,
                                       int rb, int r0, int v0, int lane) {
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t x[4];
      const int m = lane / 8;
      hopper::ldmatrix_x4_trans(
          x, tile + (r0 + (m & 1) * 8 + lane % 8) * rb + v0 + 16 * np + (m >> 1) * 8);
      b[2 * np][0] = x[0]; b[2 * np][1] = x[1]; b[2 * np + 1][0] = x[2]; b[2 * np + 1][1] = x[3];
    }
  } else {
    uint32_t x[2];
    hopper::ldmatrix_x2_trans(x, tile + (r0 + ((lane / 8) & 1) * 8 + lane % 8) * rb + v0);
    b[0][0] = x[0]; b[0][1] = x[1];
  }
}

template <int K>
__global__ void __launch_bounds__(256, 2) wkv6_bf16_kernel(const Params p) {
  using T = Bf16Tile<K>;
  constexpr int V = K, QC = T::QC, SUB = T::SUB, NSUB = T::NSUB, NPAIR = T::NPAIR;
  constexpr int RB = T::RB, RF = T::RF, AF = T::AF;
  constexpr int VW = V / 4, NT = VW / 8;  // columns of a warp's y tile, its n8 tiles
  constexpr int NS = V / 16;              // n8 tiles of a warp's state tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* stages = smem_raw;
  float* W = reinterpret_cast<float*>(stages + 2 * T::STAGE);  // [QC][RF] exp(log_w)
  // W is dead after step 3: it then stages y for whole-row stores
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(W);  // [QC][RB]
  float* RL = W + QC * RF;    // [QC][RF] r_t times prod of w from its block's start to t-1
  float* KL = RL + QC * RF;   // [QC][RF] k_t times prod of w from t+1 to its block's end
  float* TOT = KL + QC * RF;  // [NSUB][K] prod of w over block I
  float* PT = TOT + NSUB * K;   // [NSUB][K] prod of the totals of the blocks before I
  float* ST = PT + NSUB * K;    // [NSUB][K] prod of the totals of those after J
  float* MID = ST + NSUB * K;   // [NPAIR][K] prod of those strictly between J and I
  float* A = MID + NPAIR * K;   // [QC][AF] intra-chunk matrix
  // [QC][RB] the carry-in's A operand, r_t prod_{s<t} w_s, split hi + lo
  __nv_bfloat16* CH = reinterpret_cast<__nv_bfloat16*>(A + QC * AF);
  __nv_bfloat16* CLO = CH + QC * RB;
  __nv_bfloat16* SH = CLO + QC * RB;  // [K][RB] state hi
  __nv_bfloat16* SL = SH + K * RB;                                    // state lo
  float* U = reinterpret_cast<float*>(SL + K * RB);                   // [K]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = 2 * (lane % 4);  // mma fragment row and column
  const int bi = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const long long bh = static_cast<long long>(bi) * p.H + h;

  // this warp's tile of y: rows t 16 TI.., a quarter of the columns v; and
  // of the state: rows k sk0.., half of the columns (K = 32: warps 0-3 only)
  const int TI = warp / 4, r16 = 16 * TI, vw0 = (warp % 4) * VW;
  const int sk0 = 16 * (warp / 2), sv0 = (warp % 2) * (V / 2);
  const bool holds_state = sk0 < K;
  float st[NS][4];
  const float* s0 = p.s0 + bh * K * V;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = holds_state ? s0[(sk0 + g + (e >> 1) * 8) * V + sv0 + 8 * nt + c + (e & 1)]
                              : 0.f;
  if (holds_state) store_state<K, NS>(st, SH, SL, sk0 + g, sv0 + c);
  for (int i = tid; i < K; i += T::kThreads) U[i] = p.u[h * K + i];

  const int chunks = (p.L + QC - 1) / QC;
  load_chunk<K>(stages, p, bi, h, 0);
  cp_async_commit();
  // y (B,L,H,V) contiguous: row (bi, l) of head h at yb + (bi L + l) H V
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(p.y) + h * V;
  const long long y_row = static_cast<long long>(p.H) * V;

  for (int ci = 0; ci < chunks; ++ci) {
    const int l0 = ci * QC, n = min(QC, p.L - l0);
    if (ci + 1 < chunks) load_chunk<K>(stages + ((ci + 1) & 1) * T::STAGE, p, bi, h, l0 + QC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* stage = stages + (ci & 1) * T::STAGE;
    const __nv_bfloat16* R = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* Kt = R + QC * RB;
    const __nv_bfloat16* Vt = Kt + QC * RB;
    const uint8_t* LW = stage + 3 * T::TILE_B;

    // 1. w = exp(log_w) and r and k decayed inside each 8-step block (to
    //    its start, from its end): one thread per (block, channel), its
    //    steps in order
    if (!ablated(kNoScan) && tid < NSUB * K) {
      const int I = tid / K, kc = tid % K, a = I * SUB;
      float wv[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const int row = a + t;
        const float l = p.lw_bf16
                            ? bf(reinterpret_cast<const __nv_bfloat16*>(LW) + row * RB + kc)
                            : reinterpret_cast<const float*>(LW)[row * RF + kc];
        wv[t] = expf(l);
        W[row * RF + kc] = wv[t];
      }
      float pr = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        RL[(a + t) * RF + kc] = bf(R + (a + t) * RB + kc) * pr;
        pr *= wv[t];
      }
      TOT[I * K + kc] = pr;
      float sf = 1.f;
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        KL[(a + t) * RF + kc] = bf(Kt + (a + t) * RB + kc) * sf;
        sf *= wv[t];
      }
    }
    __syncthreads();
    // products of the block totals, per channel
    if (tid < K) {
      float tot[NSUB];
#pragma unroll
      for (int M = 0; M < NSUB; ++M) tot[M] = TOT[M * K + tid];
      float pre = 1.f, suf = 1.f;
#pragma unroll
      for (int M = 0; M < NSUB; ++M) {
        PT[M * K + tid] = pre;
        pre *= tot[M];
        ST[(NSUB - 1 - M) * K + tid] = suf;
        suf *= tot[NSUB - 1 - M];
      }
#pragma unroll
      for (int I = 1; I < NSUB; ++I)
#pragma unroll
        for (int J = 0; J < I; ++J) {
          float mid = 1.f;
#pragma unroll
          for (int M = J + 1; M < I; ++M) mid *= tot[M];
          MID[(I * (I - 1) / 2 + J) * K + tid] = mid;
        }
    } else if (tid >= 128 && tid < 128 + QC) {
      // the bonus on the diagonal: A[t, t] = r_t . (u k_t)
      const int t = tid - 128;
      float b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 2) {
        const float2 rv = bf2(R + t * RB + i), kv = bf2(Kt + t * RB + i);
        b0 = fmaf(rv.x * U[i], kv.x, b0);
        b1 = fmaf(rv.y * U[i + 1], kv.y, b1);
      }
      A[t * AF + t] = b0 + b1;
    }
    __syncthreads();

    // the carry-in operand, once for all warps that read it
    for (int e = tid; e < QC * K / 2; e += T::kThreads) {
      const int t = e / (K / 2), k2 = 2 * (e % (K / 2));
      const float2 rl = f2(RL + t * RF + k2), pt = f2(PT + (t / SUB) * K + k2);
      uint32_t hi, lo;
      hopper::split2(rl.x * pt.x, rl.y * pt.y, hi, lo);
      *reinterpret_cast<uint32_t*>(CH + t * RB + k2) = hi;
      *reinterpret_cast<uint32_t*>(CLO + t * RB + k2) = lo;
    }
    // 2. A below the diagonal blocks, on mma.sync: for column block J and a
    //    16-row tile of rows t in later blocks I(t) > J, A[t, j] = sum_k
    //    (rl_t mid(I(t), J))[k] kl_j[k], mid the product of the totals of
    //    the blocks strictly between, both factors split hi + lo, three
    //    passes; rows of the tile at or above block J are not written
    {
      int task = 0;
#pragma unroll
      for (int J = 0; J < NSUB - 1; ++J)
#pragma unroll
        for (int TT = SUB * (J + 1) / 16; TT < QC / 16; ++TT, ++task) {
          if (ablated(kNoOffDiag) || task != warp) continue;
          const int j = SUB * J + g, lo_row = SUB * (J + 1);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < K / 16; ++kk) {
            uint32_t ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // rows t, columns k
              const int t = 16 * TT + g + (r & 1) * 8, k0 = 16 * kk + c + (r >> 1) * 8;
              const int I = t / SUB;
              float2 a2 = make_float2(0.f, 0.f);
              if (t >= lo_row) {
                const float2 rl = f2(RL + t * RF + k0),
                             md = f2(MID + (I * (I - 1) / 2 + J) * K + k0);
                a2 = make_float2(rl.x * md.x, rl.y * md.y);
              }
              hopper::split2(a2.x, a2.y, ahi[r], alo[r]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {  // k rows c (+8), column j
              const float2 kl = f2(KL + j * RF + 16 * kk + c + 8 * r);
              hopper::split2(kl.x, kl.y, bhi[r], blo[r]);
            }
            hopper::mma_bf16(acc, ahi, bhi[0], bhi[1]);
            if constexpr (!ablated(kOnePass)) {
              hopper::mma_bf16(acc, ahi, blo[0], blo[1]);
              hopper::mma_bf16(acc, alo, bhi[0], bhi[1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * TT + g + (e >> 1) * 8;
            if (t >= lo_row) A[t * AF + SUB * J + c + (e & 1)] = acc[e];
          }
        }
    }
    // 3. the diagonal blocks below their diagonal, exactly in f32: A[t, j] =
    //    sum_k r_t k_j prod_{j < s < t} w_s by a running product. A group of
    //    16 lanes takes block I and the columns j1 = q and j2 = 6 - q (eight
    //    entries between them; q = 3 has column 3 alone), each lane a
    //    sixteenth of the channels; a transposing butterfly over 8 lanes and
    //    one more shuffle leave lanes l and l + 8 with entry l's sum.
    if (!ablated(kNoDiag)) {
      constexpr int KQ = K / 16;
      const int kq = lane & 15, grp = tid >> 4, I = grp >> 2, q = grp & 3;
      const int k0 = kq * KQ, split = SUB - 1 - q;  // entries of column j1 = q
      const int j2 = q < 3 ? SUB - 2 - q : q;        // q = 3: no second column
      float kj2[KQ], e[KQ], v[SUB];
#pragma unroll
      for (int i = 0; i < KQ; i += 2) {
        const float2 k1 = bf2(Kt + (SUB * I + q) * RB + k0 + i);
        const float2 k2 = bf2(Kt + (SUB * I + j2) * RB + k0 + i);
        e[i] = k1.x; e[i + 1] = k1.y;
        kj2[i] = k2.x; kj2[i + 1] = k2.y;
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        // entry i: (t = q + 1 + i, j1) for i < split, else (t = i, j2)
        const int t = SUB * I + (i < split ? q + 1 + i : i);
        const bool restart = i == split;  // column j2 begins: an empty product
#pragma unroll
        for (int r = 0; r < KQ; ++r) e[r] = restart ? kj2[r] : e[r];
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < KQ; r += 2) {
          const float2 rv = bf2(R + t * RB + k0 + r);
          const float2 wv = f2(W + t * RF + k0 + r);
          acc = fmaf(rv.x, e[r], acc);
          acc = fmaf(rv.y, e[r + 1], acc);
          e[r] *= wv.x;
          e[r + 1] *= wv.y;
        }
        v[i] = acc;
      }
#pragma unroll
      for (int stage = 0; stage < 3; ++stage) {
        const int m = 4 >> stage;
        const bool upper = lane & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float send = upper ? v[i] : v[i + m];
          const float keep = upper ? v[i + m] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], 8);
      const int i = lane & 7;
      if (kq < 8 && (i < split || q < 3)) {
        const int t = SUB * I + (i < split ? q + 1 + i : i);
        A[t * AF + SUB * I + (i < split ? q : j2)] = v[0];
      }
    }
    __syncthreads();

    // 4. y for this warp's tile: the carry-in (r_t prod_{s<t} w_s) @ S in
    //    three bf16 passes, then A v (A split hi + lo, v exact) over the
    //    blocks up to the diagonal
    {
      float y[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; !ablated(kNoCarryIn) && kk < K / 16; ++kk) {
        uint32_t ahi[4], alo[4], bh[NT][2], bl[NT][2];
        const int m = lane / 8;
        const int arow = (r16 + (m & 1) * 8 + lane % 8) * RB + 16 * kk + (m >> 1) * 8;
        hopper::ldmatrix_x4(ahi, CH + arow);
        hopper::ldmatrix_x4(alo, CLO + arow);
        load_b<NT>(bh, SH, RB, 16 * kk, vw0, lane);
        load_b<NT>(bl, SL, RB, 16 * kk, vw0, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          hopper::mma_bf16(y[nt], ahi, bh[nt][0], bh[nt][1]);
          if constexpr (!ablated(kOnePass)) {
            hopper::mma_bf16(y[nt], ahi, bl[nt][0], bl[nt][1]);
            hopper::mma_bf16(y[nt], alo, bh[nt][0], bh[nt][1]);
          }
        }
      }
      for (int kk = 0; !ablated(kNoAV) && kk <= TI; ++kk) {  // steps j 16 kk.. up to the diagonal
        uint32_t ahi[4], alo[4], b[NT][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = r16 + g + (r & 1) * 8, j0 = 16 * kk + c + (r >> 1) * 8;
          const float2 av = f2(A + t * AF + j0);
          hopper::split2(j0 <= t ? av.x : 0.f, j0 + 1 <= t ? av.y : 0.f, ahi[r], alo[r]);
        }
        load_b<NT>(b, Vt, RB, 16 * kk, vw0, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          hopper::mma_bf16(y[nt], ahi, b[nt][0], b[nt][1]);
          if constexpr (!ablated(kOnePass)) hopper::mma_bf16(y[nt], alo, b[nt][0], b[nt][1]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(Y + (r16 + g + 8 * hh) * RB + vw0 + 8 * nt + c) =
              __floats2bfloat162_rn(y[nt][2 * hh], y[nt][2 * hh + 1]);
    }

    // 5. the state: S <- diag(prod w) S + (k_j prod_{s>j} w_s)^T v, the
    //    decayed k split in three bf16 terms (~2^-24), v exact
    if (!ablated(kNoStateUpdate) && holds_state) {
      float upd[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) upd[nt][0] = upd[nt][1] = upd[nt][2] = upd[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {  // steps j 16 kk..
        uint32_t a3[3][4], b[NS][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows k, columns j (both in block j0 / SUB)
          const int kr = sk0 + g + (r & 1) * 8, j0 = 16 * kk + c + (r >> 1) * 8;
          const float sf = ST[(j0 / SUB) * K + kr];
          hopper::split3(KL[j0 * RF + kr] * sf, KL[(j0 + 1) * RF + kr] * sf, a3[0][r], a3[1][r],
                 a3[2][r]);
        }
        load_b<NS>(b, Vt, RB, 16 * kk, sv0, lane);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int part = 0; part < (ablated(kOnePass) ? 1 : 3); ++part)
            hopper::mma_bf16(upd[nt], a3[part], b[nt][0], b[nt][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kr = sk0 + g + 8 * hh;
        const float dec = PT[(NSUB - 1) * K + kr] * TOT[(NSUB - 1) * K + kr];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          st[nt][2 * hh] = st[nt][2 * hh] * dec + upd[nt][2 * hh];
          st[nt][2 * hh + 1] = st[nt][2 * hh + 1] * dec + upd[nt][2 * hh + 1];
        }
      }
    }
    __syncthreads();  // every read of the old state tile and of this stage is done
    if (holds_state) store_state<K, NS>(st, SH, SL, sk0 + g, sv0 + c);
    // y rows t < n, whole 16-byte pieces from the staging tile
    constexpr int PIECES = V * 2 / 16;
    for (int e = tid; e < QC * PIECES; e += T::kThreads) {
      const int t = e / PIECES, piece = e % PIECES;
      if (t < n)
        *reinterpret_cast<uint4*>(yb + (static_cast<long long>(bi) * p.L + l0 + t) * y_row +
                                  piece * 8) =
            *reinterpret_cast<const uint4*>(Y + t * RB + piece * 8);
    }
  }

  if (holds_state) {
    float* so = p.s_out + bh * K * V;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(sk0 + g + (e >> 1) * 8) * V + sv0 + 8 * nt + c + (e & 1)] = st[nt][e];
  }
}

template <int K>
int launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int smem = Bf16Tile<K>::SMEM, threads = Bf16Tile<K>::kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bf16_kernel<K><<<p.B * p.H, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int last_design = -1;  // 0: f32 step kernel, 1: bf16 chunked mma.sync kernel

}  // namespace

// strides: 12 element strides, (batch, seq, head) of r, k, v and log_w in
// that order; the last dim of each is contiguous. K = V in {32, 64}. bf16
// (cp.async) takes 16-byte aligned bases and strides of 16 bytes' multiples;
// y is contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* lw, const float* u, const float* s0,
                              void* y, float* s_out, int B, int L, int H,
                              int K, const long long* strides, int bf16,
                              int lw_bf16, void* stream) {
  Params p;
  p.r = r; p.k = k; p.v = v; p.lw = lw; p.u = u; p.s0 = s0; p.y = y;
  p.s_out = s_out;
  p.B = B; p.L = L; p.H = H;
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
  }
  p.bf16 = bf16; p.lw_bf16 = lw_bf16;
  const auto s = static_cast<cudaStream_t>(stream);
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  last_design = bf16 ? 1 : 0;
  switch (K) {
    case 32: return bf16 ? launch_bf16<32>(p, s) : launch<32>(p, s);
    case 64: return bf16 ? launch_bf16<64>(p, s) : launch<64>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel the last rwkv6_scan_fwd call launched: 0 = the f32 step
// kernel, 1 = the bf16 chunked tensor-core kernel, -1 = none yet.
extern "C" int rwkv6_scan_last_design() { return last_design; }
