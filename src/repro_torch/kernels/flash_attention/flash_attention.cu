// Flash attention (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention (body _kernel). For q (B,Sq,H,hd) and k/v (B,Sk,KVH,hd) it
// computes, per query row, softmax(c*tanh(s/c) masked) @ v with
// s = (q * hd^-0.5) . k, in f32, and writes o (B,Sq,H,hd) in q's dtype. GQA:
// query head h reads KV head h / (H/KVH). Static causal mask with a query
// offset, static look-back window, logit softcap. Masked scores are the
// finite NEG_INF = -1e30, as in the TPU kernel: a row whose first live tile is
// fully masked takes exp(0) terms that the next tile's correction
// exp(-1e30 - m) wipes out exactly; -inf there would give NaN. Keys past Sk
// in a ragged last tile get -inf (probability 0), rows past Sq are not
// written: any Sq and Sk are taken.
//
// Bound: operations. At the serving shape (B=8, S=2048, H=16, hd=128, causal)
// the live half of QK^T and PV is 137 GFLOP against 192 MiB of q/k/v/o, far
// above the card's ridge point. This first version runs the products as f32
// FMA on the CUDA cores (67 TFLOP/s peak), not on the tensor cores (989
// TFLOP/s bf16), so it sits far above the bound; f32 math throughout keeps
// the 2e-5 agreement of the JAX tests in f32 (no TF32).
//
// Design: one block of 256 threads per (64 query rows, batch*head); the grid's
// q-tile axis runs longest causal tiles first. The q tile is staged once in
// shared memory, transposed and scaled; a loop over 64-key tiles takes the
// place of the TPU grid's sequential KV axis, from the first tile the window
// reaches to the last tile the causal mask reaches (the counterpart of the
// pl.when live test), so fully masked tiles cost nothing. Per tile K is staged
// transposed and V row-major, both as f32. Thread (tx,ty) owns score rows
// 4ty..4ty+3 and columns 4tx..4tx+3 (float4 shared-memory reads), keeps the
// running max m, denominator l and its slice of the output accumulator for
// those rows in registers (f32), reduces the row max across its 16-lane
// half-warp with shuffles, and writes P to shared memory for the PV product.
// q, k, v are read in place through their (batch, seq, head) strides; the
// head dim must be contiguous.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kPad = 4;        // row padding that keeps float4 alignment
constexpr int kQS = kBQ + kPad;  // row stride of the transposed q tile
constexpr int kKS = kBK + kPad;  // row stride of the transposed k tile
constexpr int kPS = kBK + kPad;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KVH;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, seq, head) strides, elements
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  int q_offset;
  float scale;
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
  auto* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x[0], x[1]);
  if constexpr (N == 4) p2[1] = __floats2bfloat162_rn(x[2], x[3]);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * kQS + HD * kKS + kBK * HD + kBQ * kPS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int VEC = HD >= 64 ? 4 : 2;  // output columns per vector
  constexpr int NV = HD / (16 * VEC);    // output vectors per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [HD][kQS]  q * scale, transposed
  float* Kt = Qt + HD * kQS;   // [HD][kKS]  k tile, transposed
  float* Vs = Kt + HD * kKS;   // [kBK][HD]  v tile
  float* Ps = Vs + kBK * HD;   // [kBQ][kPS] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int q_rows = min(kBQ, p.Sq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[2];

  for (int g = tid; g < kBQ * (HD / 4); g += kThreads) {
    const int r = g % kBQ, d = (g / kBQ) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < q_rows) load4(q + (q0 + r) * p.qs[1] + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qt[(d + e) * kQS + r] = x[e] * p.scale;
  }

  // KV tiles that hold a live key for some row of this q tile.
  const int qlo = p.q_offset + q0, qhi = qlo + q_rows - 1;
  const int k_end = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  float m[4], l[4], acc[4][NV * VEC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int j = 0; j < NV * VEC; ++j) acc[r][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int g = tid; g < kBK * (HD / 4); g += kThreads) {
      const int r = g % kBK, d = (g / kBK) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < p.Sk) load4(k + (k0 + r) * p.ks[1] + d, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) Kt[(d + e) * kKS + r] = x[e];
    }
    for (int g = tid; g < kBK * (HD / 4); g += kThreads) {
      const int r = g / (HD / 4), d = (g % (HD / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < p.Sk) load4(v + (k0 + r) * p.vs[1] + d, x);
      *reinterpret_cast<float4*>(&Vs[r * HD + d]) = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kQS + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kKS + tx * 4]);
      qa[0] = qv.x; qa[1] = qv.y; qa[2] = qv.z; qa[3] = qv.w;
      ka[0] = kv.x; ka[1] = kv.y; ka[2] = kv.z; ka[3] = kv.w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qlo + ty * 4 + r;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        float x = s[r][c];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool live = (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || qpos - kpos < p.window);
        x = live ? x : kNegInf;
        if (kpos >= p.Sk) x = -CUDART_INF_F;  // past the end: probability 0
        s[r][c] = x;
        tmax = fmaxf(tmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        psum += s[r][c];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int j = 0; j < NV * VEC; ++j) acc[r][j] *= corr;
      m[r] = m_new;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + r) * kPS + tx * 4]) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t4 = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + r) * kPS + kk]);
        pr[r][0] = t4.x; pr[r][1] = t4.y; pr[r][2] = t4.z; pr[r][3] = t4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float* vrow = &Vs[(kk + e) * HD + j * 16 * VEC + tx * VEC];
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vrow);
            vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
          } else {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow);
            vv[0] = t2.x; vv[1] = t2.y;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[r][j * VEC + c] = fmaf(pr[r][e], vv[c], acc[r][j * VEC + c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = ty * 4 + r;
    if (row < q_rows) {
      T* orow = o + (q0 + row) * p.os[1];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float out[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) out[c] = acc[r][j * VEC + c] / denom;
        store<VEC>(orow + j * 16 * VEC + tx * VEC, out);
      }
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o in turn.
// dtype: 0 = f32, 1 = bf16 (all four tensors).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int KVH, int hd, const long long* strides,
                                   int causal, int window, float softcap,
                                   int q_offset, float scale, int dtype,
                                   void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KVH = KVH;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.q_offset = q_offset; p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(p, hd, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(p, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
