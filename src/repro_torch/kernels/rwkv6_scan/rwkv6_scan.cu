// RWKV6 ("Finch") WKV scan (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/rwkv6_scan.py::wkv6_pallas
// (body _kernel). For r, k, log_w (B,L,H,K), v (B,L,H,V), u (H,K) and an
// initial state S (B,H,K,V) it runs, per (batch, head), the recurrence
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(log_w_t)
//
// step by step in f32 (ref.wkv6_naive). In exact arithmetic this equals the
// TPU kernel's chunked arrangement (a carry-in product per chunk plus an
// exact loop inside it); every factor w_t = exp(log_w_t) has log_w_t <= 0,
// so no product of decays can overflow, the hazard rwkv6_scan.py:1-9 warns
// of. The bonus term is split off: y_t = r_t . S_{t-1} + a_t v_t with the
// scalar a_t = sum_k r_t[k] u[k] k_t[k], formed once per step for all v.
// y is written in r's dtype, the final state in f32.
//
// Bound: operations. At the serving shape (B=8, L=2048, H=40, K=V=64,
// bf16 r/k/v/log_w) each state entry takes five f32 operations per step,
// one FMA for r S and a multiply and an FMA for S w + k v, plus the bonus
// a_t (3 K) and a_t v_t (2 V) per step: B H L (5 K V + 3 K + 2 V) =
// 13.6 GFLOP, 0.203 ms at the card's 67 TFLOP/s f32 CUDA-core peak. The
// bytes, r, k, v, log_w and y in bf16 (84 MB each) and two f32 states
// (5.2 MB each), take 0.128 ms at 3.35 TB/s. The recurrence is rank-1 per
// step, so this version keeps it on the CUDA cores, with each thread's 16
// state values in registers so that no state byte leaves the SM; the
// tensor cores would need the chunked form's (Q,K)x(K,V) carry-in
// products (a later version).
//
// Design: Hopper has no sequential grid axis, so one block per (batch,
// head) loops over the sequence with the (K,V) state in registers: warp w
// owns rows [16 kg, 16 kg + 16) of the state, kg = w / (V/32), and column
// v = 32 (w % (V/32)) + lane, 16 f32 values a thread (8 warps at K=V=64).
// Per tile of kTile steps the block stages r, k, w = exp(log_w) and v as
// f32 in shared memory with coalesced loads (bf16 inputs are converted
// there) and forms a_t. Then every warp runs the tile's steps on its own
// slice without a barrier: each step reads its 16 r, k and w as float4
// broadcasts (one address per warp) and one v, and writes its partial
// y_t[v] over its 16 rows to shared memory. After one barrier the block
// sums the K/16 partials, adds a_t v_t and writes y. The tiles take 64 KiB
// of shared memory at K=V=64, so three blocks fit on an SM and the 320
// blocks of the serving shape are all resident at once.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// strides: 12 element strides, (batch, seq, head) of r, k, v and log_w in
// that order; the last dim of each is contiguous. K = V in {32, 64}.
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
  switch (K) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
