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
// of per-step decays is taken. All arithmetic is f32. The TPU kernel casts
// M to x's dtype before the M x product; this kernel, like ssd_chunked,
// keeps it in f32. y is written in x's dtype, the final state in f32.
//
// Bound: bytes. At the serving shape (B=8, L=2048, H=64, P=N=64, G=1,
// Q=128) the work is 51.5 GFLOP on 278 MiB, about 0.087 ms at the card's
// HBM rate; the same work on the bf16 tensor cores is 0.052 ms. This first
// version runs the products as f32 FMA on the CUDA cores (67 TFLOP/s), so
// it cannot beat about 0.77 ms; it skips no masked half of M.
//
// Design: Hopper has no sequential grid axis, so one block of 256 threads
// per (batch, head) loops over the chunks and keeps the (P,N) state in
// registers: thread (tx,ty) owns state rows n of fragment ty and columns p
// of fragment tx, across all chunks. Per chunk the block stages x and b
// row-major and b and c transposed as f32 in shared memory (bf16 inputs are
// converted there), one warp scans log_a into cum and exp(cum_Q - cum_j),
// then three register-tiled products follow, each thread owning a
// fragment of the output: M^T = B C^T (masked, decayed, into shared
// memory), y = M x + diag(exp(cum)) C S^T (to device memory), and the state
// update. A chunk shorter than the tile (L < 64) is padded with zero x, b,
// c and log_a, which leaves every sum unchanged. At Q=128, P=N=64 the tiles
// take 211 KiB of shared memory, so the launch raises the dynamic limit.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// strides: 12 element strides, (batch, seq, head) for x and log_a and
// (batch, seq, group) for b and c, in that order; the last dim of x, b and
// c is contiguous. Q <= 128 and L % Q == 0. P in {32, 64}, N in {16, 32, 64}.
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
  if (Q <= 64) return dispatch_p<64>(p, P, N, s);
  return dispatch_p<128>(p, P, N, s);
}
