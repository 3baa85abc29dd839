// Mamba2 SSD chunked scan (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba2_ssd/mamba2_ssd.py::ssd_pallas
// (body _kernel). For x (B,L,H,P), log_a (B,L,H), b/c (B,L,G,N) and an
// initial state S (B,H,P,N) it runs, per head h with B/C group g = h*G/H,
// the recurrence S_t = a_t S_{t-1} + x_t b_t^T, y_t = S_t c_t in chunks of
// Q steps. Per chunk, with cum the inclusive cumsum of log_a in the chunk:
//
//   M[i,j]  = (c_i . b_j) exp(cum_i - cum_j)  for i >= j, else 0
//   y_i     = sum_j M[i,j] x_j + exp(cum_i) S c_i
//   S      <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) x_j b_j^T
//
// The decays are formed as the plain version forms them: differences of the
// cumsum, masked above the diagonal, so every exponent is <= 0; no product
// of per-step decays is taken. y is written in x's dtype, the final state in
// f32. Dispatch is by dtype: bf16 runs the tensor-core kernel, f32 the
// CUDA-core one.
//
// Bound: bytes. At the serving shape (B=8, L=2048, H=64, P=N=64, G=1,
// Q=128) the causal work is 34.5 GFLOP on 278 MiB: 0.087 ms at the card's
// HBM rate against 0.035 ms on the bf16 tensor cores.
//
// bf16 design (TMA + wgmma, hopper.cuh): one block per (batch, head) walks
// the sequence in chunks of its own, 64 steps, whatever the caller's Q is
// (the chunked form is exact in any chunking; Q only decides which prompts
// are accepted). Of each Q x Q tile of M only the 64 x 64 blocks on its
// diagonal are computed: the blocks below them reach y through the carry-in
// and the state update, and the masked blocks above them are never formed
// (inside a 64 x 64 block, the m64 tile of wgmma, the upper triangle is
// computed and zeroed). Rows past L come as TMA's zero fill with log_a = 0
// and are masked out of M and of the state update, so any L runs, 37 too.
//  - Producer warp: keeps x (64 x P), b and c (64 x N) of the next chunks in
//    a three-stage ring, one TMA box each through 4-D tensor maps over
//    (P, H, L, B) and (N, G, L, B) with the tensors' own strides; log_a,
//    strided by H and too narrow for a TMA box, is read with plain loads
//    and scanned into cum by the same warp, which then arrives on the
//    stage's full barrier beside the TMA bytes.
//  - Consumer warpgroup (64 rows):
//      C B^T      wgmma SS, m64n64;
//      C S^T      wgmma SS in the same batch, into the output accumulator,
//                 against S in bf16 split in two (hi + lo, 2^-16
//                 relative), then each row scaled by exp(cum_i);
//      M          masked and decayed in registers and split into bf16 hi
//                 + lo, as two wgmma A operands: a single bf16 M missed
//                 the 1e-1 hold by 0.139 at N = 64 (128 terms of |c.b| ~
//                 8); the TPU kernel keeps M in f32 (its .astype(x.dtype)
//                 follows x's cast to f32);
//      += M x     wgmma RS with x (exact in bf16) as an N-major B;
//      state      while M x runs, dec_j x_j^T is built from the x tile by
//                 ldmatrix.trans, scaled by dec_j = exp(cum_end - cum_j)
//                 (0 past L) and split into bf16 hi + lo; then wgmma RS
//                 against b (an N-major B), and S <- exp(cum_end) S + that
//                 sum in f32 registers (the m64nN accumulator layout, rows
//                 p); its wgmma runs while y goes out;
//      y          rounded to bf16, staged in shared memory and stored as
//                 whole 16-byte pieces of rows < L (stores straight from
//                 the accumulator layout write 16 bytes of a row an
//                 instruction and were slow);
//    the new S is written, hi and lo, to the bf16 tile the next chunk's
//    C S^T reads. Decays use exp2 on the SFU (relative error ~2^-21 at
//    these exponents; the accurate expf was slow at this count).
//  - One consumer warpgroup and one producer warp, 100 KB of shared memory
//    and 168 registers a thread at P = N = 64: two blocks share an SM, and
//    the 512 blocks of the serving shape run in 1.9 waves. A first version
//    with 128-step chunks, two consumer warpgroups (rows 0-63 and 64-127,
//    the upper-right 64 x 64 block skipped) and one block an SM was slower
//    (PERF.md).
//
// f32 design: all products as f32 FMA on the CUDA cores (no TF32), which
// keeps the JAX tests' 1e-3 in f32. One block of 256 threads per (batch,
// head) loops over the chunks and keeps the (P,N) state in registers:
// thread (tx,ty) owns state rows n of fragment ty and columns p of fragment
// tx, across all chunks. Per chunk the block stages x and b row-major and b
// and c transposed as f32 in shared memory, one warp scans log_a into cum
// and exp(cum_Q - cum_j), then three register-tiled products follow, each
// thread owning a fragment of the output: M^T = B C^T (masked, decayed,
// into shared memory), y = M x + diag(exp(cum)) C S^T (to device memory),
// and the state update. A chunk shorter than the tile (L < 64) is padded
// with zero x, b, c and log_a, which leaves every sum unchanged. At Q=128,
// P=N=64 the tiles take 211 KiB of shared memory, so the launch raises the
// dynamic limit. It runs its products at the f32 CUDA-core rate, 3.6 ms at
// the serving shape.
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

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kPad = 4;        // row padding of the transposed tiles

struct Params {
  const void* x;
  const void* la;
  const void* b;
  const void* c;
  const float* s0;  // (B,H,P,N) contiguous
  void* y;          // (B,L,H,P) contiguous
  float* s_out;     // (B,H,P,N) contiguous
  int B, L, H, G, Q;
  long long xs[3], las[3], bs[3], cs[3];  // (batch, seq, head/group) strides
  int bf16;     // x, b, c and y are bf16 (else f32)
  int la_bf16;  // log_a is bf16 (else f32)
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Fragment layout: a thread t of 16 owns T entries of a 16*T-long row, in
// groups of VW = min(T, 4) consecutive entries, group g at g*16*VW + t*VW.
template <int T>
__device__ __forceinline__ int frag_index(int t, int m) {
  constexpr int VW = T >= 4 ? 4 : T;
  return (m / VW) * 16 * VW + t * VW + m % VW;
}

template <int T>
__device__ __forceinline__ void load_frag(const float* row, int t, float (&f)[T]) {
  constexpr int VW = T >= 4 ? 4 : T;
#pragma unroll
  for (int g = 0; g < T / VW; ++g) {
    const float* src = row + g * 16 * VW + t * VW;
    if constexpr (VW == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      f[g * 4] = v.x; f[g * 4 + 1] = v.y; f[g * 4 + 2] = v.z; f[g * 4 + 3] = v.w;
    } else if constexpr (VW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(src);
      f[g * 2] = v.x; f[g * 2 + 1] = v.y;
    } else {
      f[g] = src[0];
    }
  }
}

// acc[m][n] += sum_k A[k][frag(ty, m)] * Bk[k][frag(tx, n)]: both operands
// are stored k-major in shared memory, rows of lda and ldb floats.
template <int TM, int TN>
__device__ __forceinline__ void mma(float (&acc)[TM][TN], const float* A,
                                    int lda, const float* Bk, int ldb, int K,
                                    int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
    load_frag<TM>(A + k * lda, ty, a);
    load_frag<TN>(Bk + k * ldb, tx, b);
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
  }
}

template <int QT, int P, int N>
constexpr size_t smem_bytes() {
  constexpr int QS = QT + kPad;
  return sizeof(float) * (QT * P + QT * N + 2 * N * QS + QT * QT + N * P + 2 * QT);
}

template <int QT, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  constexpr int QS = QT + kPad;
  constexpr int SM = N / 16, SN = P / 16;  // state fragment: rows n, cols p
  constexpr int MT = QT / 16;              // chunk-row fragment
  extern __shared__ __align__(16) float smem[];
  float* X = smem;             // [QT][P]   x chunk
  float* Bm = X + QT * P;      // [QT][N]   b chunk
  float* Bt = Bm + QT * N;     // [N][QS]   b chunk, transposed
  float* Ct = Bt + N * QS;     // [N][QS]   c chunk, transposed
  float* Mt = Ct + N * QS;     // [QT][QT]  Mt[j][i] = M[i][j]
  float* St = Mt + QT * QT;    // [N][P]    state at the chunk's start, transposed
  float* cum = St + N * P;     // [QT]      inclusive cumsum of log_a
  float* dec = cum + QT;       // [QT]      exp(cum[QT-1] - cum[j])

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int g = h * p.G / p.H;
  const int Q = p.Q;

  const float* s0 = p.s0 + (static_cast<long long>(bi) * p.H + h) * P * N;
  float st[SM][SN];
#pragma unroll
  for (int m = 0; m < SM; ++m)
#pragma unroll
    for (int n = 0; n < SN; ++n)
      st[m][n] = s0[frag_index<SN>(tx, n) * N + frag_index<SM>(ty, m)];

  const long long xb = bi * p.xs[0] + h * p.xs[2];
  const long long lab = bi * p.las[0] + h * p.las[2];
  const long long bb = bi * p.bs[0] + g * p.bs[2];
  const long long cb = bi * p.cs[0] + g * p.cs[2];

  for (int l0 = 0; l0 < p.L; l0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int n = 0; n < SN; ++n)
        St[frag_index<SM>(ty, m) * P + frag_index<SN>(tx, n)] = st[m][n];
    for (int e = tid; e < QT * P; e += kThreads) {
      const int j = e / P, pp = e % P;
      X[e] = j < Q ? load(p.x, xb + (l0 + j) * p.xs[1] + pp, p.bf16) : 0.f;
    }
    for (int e = tid; e < QT * N; e += kThreads) {
      const int j = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (j < Q) {
        bv = load(p.b, bb + (l0 + j) * p.bs[1] + n, p.bf16);
        cv = load(p.c, cb + (l0 + j) * p.cs[1] + n, p.bf16);
      }
      Bm[e] = bv;
      Bt[n * QS + j] = bv;
      Ct[n * QS + j] = cv;
    }
    if (tid < 32) {  // one warp: cum = inclusive cumsum, dec = exp(total - cum)
      constexpr int R = QT / 32;
      float v[R];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = tid * R + r;
        run += j < Q ? load(p.la, lab + (l0 + j) * p.las[1], p.la_bf16) : 0.f;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) cum[tid * R + r] = v[r] + excl;
      __syncwarp();
      const float total = cum[QT - 1];
#pragma unroll
      for (int r = 0; r < R; ++r) dec[tid * R + r] = expf(total - cum[tid * R + r]);
    }
    __syncthreads();

    // M^T[j][i] = (b_j . c_i) exp(cum_i - cum_j) for i >= j, else 0
    {
      float acc[MT][MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < MT; ++n) acc[m][n] = 0.f;
      mma<MT, MT>(acc, Bt, QS, Ct, QS, N, ty, tx);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int j = frag_index<MT>(ty, m);
        const float cj = cum[j];
#pragma unroll
        for (int n = 0; n < MT; n += 4) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = frag_index<MT>(tx, n + e);
            o[e] = i >= j ? acc[m][n + e] * expf(cum[i] - cj) : 0.f;
          }
          *reinterpret_cast<float4*>(&Mt[j * QT + frag_index<MT>(tx, n)]) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();

    // y_i = sum_j M[i][j] x_j + exp(cum_i) sum_n c_i[n] S[:, n]
    {
      float acc[MT][SN], inter[MT][SN];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < SN; ++n) acc[m][n] = inter[m][n] = 0.f;
      mma<MT, SN>(acc, Mt, QT, X, P, Q, ty, tx);
      mma<MT, SN>(inter, Ct, QS, St, P, N, ty, tx);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int i = frag_index<MT>(ty, m);
        if (i >= Q) continue;
        const float din = expf(cum[i]);
        const long long row = ((static_cast<long long>(bi) * p.L + l0 + i) * p.H + h) * P;
#pragma unroll
        for (int n = 0; n < SN; ++n) {
          const float out = acc[m][n] + din * inter[m][n];
          const int pp = frag_index<SN>(tx, n);
          if (p.bf16) {
            static_cast<__nv_bfloat16*>(p.y)[row + pp] = __float2bfloat16_rn(out);
          } else {
            static_cast<float*>(p.y)[row + pp] = out;
          }
        }
      }
    }

    // S^T[n][p] <- exp(total) S^T[n][p] + sum_j b_j[n] dec_j x_j[p]
    {
      float acc[SM][SN];
#pragma unroll
      for (int m = 0; m < SM; ++m)
#pragma unroll
        for (int n = 0; n < SN; ++n) acc[m][n] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        float a[SM], xv[SN];
        load_frag<SM>(Bm + j * N, ty, a);
        load_frag<SN>(X + j * P, tx, xv);
        const float d = dec[j];
#pragma unroll
        for (int m = 0; m < SM; ++m) {
          const float ad = a[m] * d;
#pragma unroll
          for (int n = 0; n < SN; ++n) acc[m][n] = fmaf(ad, xv[n], acc[m][n]);
        }
      }
      const float decay = expf(cum[QT - 1]);
#pragma unroll
      for (int m = 0; m < SM; ++m)
#pragma unroll
        for (int n = 0; n < SN; ++n) st[m][n] = st[m][n] * decay + acc[m][n];
    }
  }

  float* s_out = p.s_out + (static_cast<long long>(bi) * p.H + h) * P * N;
#pragma unroll
  for (int m = 0; m < SM; ++m)
#pragma unroll
    for (int n = 0; n < SN; ++n)
      s_out[frag_index<SN>(tx, n) * N + frag_index<SM>(ty, m)] = st[m][n];
}

template <int QT, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<QT, P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<QT, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<QT, P, N><<<p.B * p.H, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, int P>
int dispatch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch<QT, P, 16>(p, s);
    case 32: return launch<QT, P, 32>(p, s);
    case 64: return launch<QT, P, 64>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int QT>
int dispatch_p(const Params& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<QT, 32>(p, N, s);
    case 64: return dispatch_n<QT, 64>(p, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// Timing builds only: benchmarks/bench_port_scan_ablation.py compiles this
// file with -DABLATE=<mask> to leave phases of the bf16 kernel out and read
// what each one costs; such a build computes wrong results. Without the
// flag ABLATE is 0 and every phase runs.
#ifndef ABLATE
#define ABLATE 0
#endif
enum : unsigned { kNoCarryIn = 1, kNoLoPasses = 2, kNoStateUpdate = 4, kNoYStore = 8 };
__host__ __device__ constexpr bool ablated(unsigned phase) { return (ABLATE & phase) != 0; }

template <int P, int N>
struct Bf16Tile {
  static constexpr int QT = 64, kStages = 3;  // steps a chunk (the kernel's own), ring
  static constexpr int kThreads = 128 + 32;   // one consumer warpgroup, one producer warp
  static constexpr int ROWP = 2 * P, ROWN = 2 * N;  // bytes of an x / b, c row
  static constexpr hopper::Layout LP = hopper::Swizzled<ROWP>::layout;
  static constexpr hopper::Layout LN = hopper::Swizzled<ROWN>::layout;
  static constexpr int X_BYTES = QT * ROWP, BC_BYTES = QT * ROWN;
  static constexpr int STAGE = X_BYTES + 2 * BC_BYTES;
  static constexpr int S_BYTES = P * ROWN;  // one bf16 (P, N) state tile
  static constexpr int YS = ROWP + 16;      // row bytes of the y staging tile
  static constexpr int SMEM = kStages * STAGE + 2 * S_BYTES + QT * YS + 1024;  // + alignment
  static constexpr int kFullArrivals = 1 + 32;  // TMA bytes + the cum warp
};

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Writes the state (m64nN accumulator layout, rows p) to the bf16 hi and lo
// tiles that the next chunk's C S^T reads.
template <int P, int N>
__device__ __forceinline__ void store_state(uint8_t* hi_tile, const float (&st)[N / 2],
                                            int r0, int q2) {
  using T = Bf16Tile<P, N>;
  if (r0 >= P) return;  // P = 32: warps 2 and 3 hold no rows
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t o = hopper::swizzle<T::ROWN>((r0 + 8 * h) * T::ROWN + 2 * (8 * jb + q2));
      uint32_t hi, lo;
      hopper::split2(st[4 * jb + 2 * h], st[4 * jb + 2 * h + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(hi_tile + o) = hi;
      *reinterpret_cast<uint32_t*>(hi_tile + T::S_BYTES + o) = lo;
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(Bf16Tile<P, N>::kThreads, 2)
ssd_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap, const Params p) {
  using T = Bf16Tile<P, N>;
  constexpr int QT = T::QT, KS = QT / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = hopper::align1024(smem_raw);      // [stage]: x, b, c
  uint8_t* s_tile = stages + T::kStages * T::STAGE;   // state hi, lo
  uint8_t* ystage = s_tile + 2 * T::S_BYTES;          // [QT][YS] y in bf16
  __shared__ __align__(16) float cum_s[T::kStages][QT];
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];

  const int bi = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int g = h * p.G / p.H;
  const int chunks = (p.L + QT - 1) / QT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], T::kFullArrivals);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: TMA for x, b, c; plain loads and a warp scan for cum
    // (log_a is 0 past L, where TMA fills x, b and c with zeros)
    const int lane = threadIdx.x % 32;
    const long long lab = bi * p.las[0] + h * p.las[2];
    constexpr int R = QT / 32;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % T::kStages;
      if (c >= T::kStages) hopper::mbar_wait(&empty[s], (c / T::kStages - 1) & 1);
      const int l0 = c * QT;
      uint8_t* st = stages + s * T::STAGE;
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], T::STAGE);
        hopper::tma_load_4d(st, &xmap, &full[s], 0, h, l0, bi);
        hopper::tma_load_4d(st + T::X_BYTES, &bmap, &full[s], 0, g, l0, bi);
        hopper::tma_load_4d(st + T::X_BYTES + T::BC_BYTES, &cmap, &full[s], 0, g, l0, bi);
      }
      float v[R];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int l = l0 + lane * R + r;
        run += l < p.L ? load(p.la, lab + l * p.las[1], p.la_bf16) : 0.f;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) cum_s[s][lane * R + r] = v[r] + excl;
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: all 64 rows of a chunk and the state
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, q2 = 2 * (lane % 4);  // rows r0, r0 + 8
  const long long bh = static_cast<long long>(bi) * p.H + h;
  float st[N / 2];  // the state, rows p = r0, r0 + 8, in the m64nN layout
  {
    const float* s0 = p.s0 + bh * P * N;
#pragma unroll
    for (int jb = 0; jb < N / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = r0 + (e >> 1) * 8, n = 8 * jb + q2 + (e & 1);
        st[4 * jb + e] = pp < P ? s0[pp * N + n] : 0.f;
      }
  }
  store_state<P, N>(s_tile, st, r0, q2);
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 128);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(p.y) + (bi * static_cast<long long>(p.L) * p.H + h) * P;
  const long long y_row = static_cast<long long>(p.H) * P;  // elements between rows l

  for (int c = 0; c < chunks; ++c) {
    const int s = c % T::kStages, l0 = c * QT, n = min(QT, p.L - l0);
    const uint8_t* sx = stages + s * T::STAGE;
    const uint8_t* sb = sx + T::X_BYTES;
    const uint8_t* sc = sb + T::BC_BYTES;
    const float* cum = cum_s[s];
    hopper::mbar_wait(&full[s], (c / T::kStages) & 1);

    // C B^T (64 x 64) and C S^T (S in bf16 hi + lo) in one batch of wgmma
    float sco[QT / 2], y[P / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::Wgmma<QT>::template ss<0>(
          sco, hopper::make_desc(sc + 32 * kk, 16, 8 * T::ROWN, T::LN),
          hopper::make_desc(sb + 32 * kk, 16, 8 * T::ROWN, T::LN), kk > 0);
    if constexpr (ablated(kNoCarryIn)) {
#pragma unroll
      for (int i = 0; i < P / 2; ++i) y[i] = 0.f;
    } else {
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          hopper::Wgmma<P>::template ss<0>(
              y, hopper::make_desc(sc + 32 * kk, 16, 8 * T::ROWN, T::LN),
              hopper::make_desc(s_tile + part * T::S_BYTES + 32 * kk, 16, 8 * T::ROWN, T::LN),
              part > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sco);
    hopper::fence_regs(y);

    // the carry-in rows scaled by exp(cum_i); M masked (j <= i, j < n),
    // decayed and split into bf16 hi + lo A fragments; y += M x
    const float c0 = cum[r0], c1 = cum[r0 + 8];
    const float e0 = fast_exp2(c0 * kLog2e), e1 = fast_exp2(c1 * kLog2e);
#pragma unroll
    for (int jb = 0; jb < P / 8; ++jb) {
      y[4 * jb] *= e0;
      y[4 * jb + 1] *= e0;
      y[4 * jb + 2] *= e1;
      y[4 * jb + 3] *= e1;
    }
    uint32_t mhi[KS][4], mlo[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jb = 2 * kk + half, j = 8 * jb + q2;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const bool l0k = j < n, l1k = j + 1 < n;
        const int i0 = r0, i1 = r0 + 8;
        const float m0 = l0k && j <= i0 ? sco[4 * jb] * fast_exp2((c0 - cj.x) * kLog2e) : 0.f;
        const float m1 = l1k && j + 1 <= i0 ? sco[4 * jb + 1] * fast_exp2((c0 - cj.y) * kLog2e) : 0.f;
        const float m2 = l0k && j <= i1 ? sco[4 * jb + 2] * fast_exp2((c1 - cj.x) * kLog2e) : 0.f;
        const float m3 = l1k && j + 1 <= i1 ? sco[4 * jb + 3] * fast_exp2((c1 - cj.y) * kLog2e) : 0.f;
        hopper::split2(m0, m1, mhi[kk][2 * half], mlo[kk][2 * half]);
        hopper::split2(m2, m3, mhi[kk][2 * half + 1], mlo[kk][2 * half + 1]);
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t db =
          hopper::make_desc(sx + kk * 16 * T::ROWP, QT * T::ROWP, 8 * T::ROWP, T::LP);
      hopper::Wgmma<P>::template rs<1>(y, mhi[kk], db, 1);
      if constexpr (!ablated(kNoLoPasses)) hopper::Wgmma<P>::template rs<1>(y, mlo[kk], db, 1);
    }
    hopper::wgmma_commit();

    // meanwhile: dec_j x_j^T as A fragments (rows p, columns j) from the x
    // tile, dec_j = exp(cum_end - cum_j) (0 past L), split hi + lo
    const float total = cum[QT - 1];
    uint32_t ahi[KS][4], alo[KS][4];
    {
      const int m = lane / 8;
      const int p0 = 16 * warp + (m & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t xr[4] = {0u, 0u, 0u, 0u};
        if (16 * warp < P) {
          const int jr = 16 * kk + (m >> 1) * 8 + lane % 8;
          hopper::ldmatrix_x4_trans(xr, sx + hopper::swizzle<T::ROWP>(jr * T::ROWP + 2 * p0));
        }
        const int j = 16 * kk + q2;
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j + (e >> 1) * 8 + (e & 1);
          d[e] = jj < n ? fast_exp2((total - cum[jj]) * kLog2e) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: rows p (+8 if r odd), columns j (+8 if r >= 2)
          const float2 xv = hopper::unpack_bf16(xr[r]);
          const float* dd = d + (r >> 1) * 2;
          hopper::split2(xv.x * dd[0], xv.y * dd[1], ahi[kk][r], alo[kk][r]);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(y);
    hopper::fence_regs(mhi);
    hopper::fence_regs(mlo);

    // S <- exp(cum_end) S + sum_j dec_j x_j b_j^T (b an N-major B); its
    // wgmma runs while y goes out through shared memory
    float acc[N / 2];
    hopper::wgmma_fence();
    if constexpr (ablated(kNoStateUpdate)) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t db =
            hopper::make_desc(sb + kk * 16 * T::ROWN, QT * T::ROWN, 8 * T::ROWN, T::LN);
        hopper::Wgmma<N>::template rs<1>(acc, ahi[kk], db, kk > 0);
        if constexpr (!ablated(kNoLoPasses)) hopper::Wgmma<N>::template rs<1>(acc, alo[kk], db, 1);
      }
    }
    hopper::wgmma_commit();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jb = 0; jb < P / 8; ++jb)
        *reinterpret_cast<__nv_bfloat162*>(ystage + (r0 + 8 * hh) * T::YS + 2 * (8 * jb + q2)) =
            __floats2bfloat162_rn(y[4 * jb + 2 * hh], y[4 * jb + 2 * hh + 1]);
    hopper::named_barrier(1, 128);
    constexpr int PIECES = T::ROWP / 16;
    __nv_bfloat16* yc = yb + static_cast<long long>(l0) * y_row;
#pragma unroll
    for (int e = tid; e < QT * PIECES; e += 128) {
      const int row = e / PIECES, piece = e % PIECES;
      if (!ablated(kNoYStore) && row < n)
        *reinterpret_cast<uint4*>(yc + row * y_row + piece * 8) =
            *reinterpret_cast<const uint4*>(ystage + row * T::YS + piece * 16);
    }

    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(ahi);
    hopper::fence_regs(alo);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);  // x, b, c and cum of this stage are read
    const float decay = fast_exp2(total * kLog2e);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] = st[i] * decay + acc[i];
    if (c + 1 < chunks) {
      store_state<P, N>(s_tile, st, r0, q2);  // C S^T of this chunk completed above
      hopper::fence_proxy_async();
    }
    hopper::named_barrier(1, 128);  // S in place; y staging free again
  }

  if (r0 < P) {
    float* so = p.s_out + bh * P * N;
#pragma unroll
    for (int jb = 0; jb < N / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(r0 + (e >> 1) * 8) * N + 8 * jb + q2 + (e & 1)] = st[4 * jb + e];
  }
}

template <int P, int N>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tile<P, N>;
  const void* base[3] = {p.x, p.b, p.c};
  const long long* st[3] = {p.xs, p.bs, p.cs};
  const int inner[3] = {P, N, N}, heads[3] = {p.H, p.G, p.G};
  const CUtensorMapSwizzle swz[3] = {hopper::Swizzled<T::ROWP>::tma,
                                     hopper::Swizzled<T::ROWN>::tma,
                                     hopper::Swizzled<T::ROWN>::tma};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    // (P or N, head or group, seq, batch), the strides of the last three in bytes
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner[i]),
                                static_cast<cuuint64_t>(heads[i]),
                                static_cast<cuuint64_t>(p.L), static_cast<cuuint64_t>(p.B)};
    const cuuint64_t strides[3] = {2ull * st[i][2], 2ull * st[i][1], 2ull * st[i][0]};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(inner[i]), 1, T::QT, 1};
    const int err = hopper::make_bf16_map(&maps[i], base[i], 4, dims, strides, box, swz[i]);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bf16_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bf16_kernel<P, N><<<p.B * p.H, T::kThreads, T::SMEM, stream>>>(maps[0], maps[1],
                                                                      maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dispatch_bf16(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_bf16<P, 16>(p, s);
    case 32: return launch_bf16<P, 32>(p, s);
    case 64: return launch_bf16<P, 64>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int last_design = -1;  // 0: f32 CUDA-core kernel, 1: bf16 TMA + wgmma kernel

}  // namespace

// strides: 12 element strides, (batch, seq, head) for x and log_a and
// (batch, seq, group) for b and c, in that order; the last dim of x, b and
// c is contiguous. Q <= 128 and L % Q == 0. P in {32, 64}, N in {16, 32, 64}.
// bf16 (TMA) takes x, b and c with 16-byte aligned bases and strides that
// are multiples of 8 elements; y is contiguous.
extern "C" int mamba2_ssd_fwd(const void* x, const void* la, const void* b,
                              const void* c, const float* s0, void* y,
                              float* s_out, int B, int L, int H, int G, int P,
                              int N, int Q, const long long* strides,
                              int bf16, int la_bf16, void* stream) {
  Params p;
  p.x = x; p.la = la; p.b = b; p.c = c; p.s0 = s0; p.y = y; p.s_out = s_out;
  p.B = B; p.L = L; p.H = H; p.G = G; p.Q = Q;
  for (int i = 0; i < 3; ++i) {
    p.xs[i] = strides[i];
    p.las[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
  }
  p.bf16 = bf16; p.la_bf16 = la_bf16;
  const auto s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 128 || L % Q) return static_cast<int>(cudaErrorInvalidValue);
  last_design = bf16 ? 1 : 0;
  if (bf16) {
    switch (P) {
      case 32: return dispatch_bf16<32>(p, N, s);
      case 64: return dispatch_bf16<64>(p, N, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (Q <= 64) return dispatch_p<64>(p, P, N, s);
  return dispatch_p<128>(p, P, N, s);
}

// The kernel the last mamba2_ssd_fwd call launched: 0 = the f32 CUDA-core
// kernel, 1 = the bf16 TMA + wgmma kernel, -1 = none yet.
extern "C" int mamba2_ssd_last_design() { return last_design; }
