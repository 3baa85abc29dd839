// Flash attention (forward, prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention (body _kernel). For q (B,Sq,H,hd) and k/v (B,Sk,KVH,hd) it
// computes, per query row, softmax(c*tanh(s/c) masked) @ v with
// s = (q . k) * hd^-0.5 in f32, and writes o (B,Sq,H,hd) in q's dtype. GQA:
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
// above the card's ridge point: 0.139 ms at the 989 TFLOP/s bf16 tensor-core
// peak.
//
// bf16 design (Hopper TMA + wgmma, hopper.cuh): one block of three
// warpgroups per (128 query rows, batch*head); the grid's q-tile axis runs
// longest causal tiles first. A loop over key tiles (128 keys; 64 at hd 256,
// whose 128-key ring would not fit in shared memory) takes the place of
// the TPU grid's sequential KV axis, from the first tile the window reaches
// to the last tile the causal mask reaches (the counterpart of the pl.when
// live test). One producer thread (its warpgroup otherwise idle) loads the q
// tile once and K and V tiles into a
// two-stage ring by TMA, through 4-D tensor maps over (hd, head, seq, batch)
// with the tensors' own strides, so the model's strided q/k/v views are read
// in place; a full mbarrier per K and per V stage and an empty one per stage
// guard the ring. Rows are 128-byte swizzle atoms of 64 head-dim columns
// (hd 128: two atoms; hd 256: four; hd 32: one 64-byte atom). Two consumer
// warpgroups each own 64 query rows:
//   S = Q K^T    wgmma m64n128k16 (m64n64k16 at hd 256), both operands from
//                shared memory, K-major;
//                then * hd^-0.5 in f32 (the TPU kernel scales q in f32; a
//                bf16 q * scale would round differently at hd 128), the
//                softcap, and the masks only on tiles that cross the
//                diagonal, the window's edge or Sk;
//   softmax      online, in registers, in the accumulator layout: a row's
//                128 scores lie on the four threads of a quad, reduced with
//                two shuffles; 2^((s - m) log2 e) on the special-function
//                unit. Every pass over a thread's 64 scores is straight-line
//                code (the softcap and mask tests are uniform and sit
//                outside the unrolled loops): with them inside, each score
//                became a basic block of its own and the kernel ran at a
//                third of this speed;
//   O += P V     P rounded to bf16 (as the TPU kernel's p.astype(v.dtype))
//                and fed as wgmma's register A operand, since the
//                accumulator layout of two 8-column blocks is the A fragment
//                of one 16-key step; V is an N-major B (transpose bit);
//                m64n{hd}k16, at hd 256 the largest wgmma.
// The output is O / max(l, 1e-30), rounded to bf16. setmaxnreg gives the
// consumers 232 registers a thread (O: hd/2 and S: BKV/2 f32 registers, P:
// BKV/4 registers of bf16 pairs; at hd 256 128 + 32 + 16); the producer's
// warpgroup keeps 40.
//
// f32 design: the products as f32 FMA on the CUDA cores (no TF32), which
// keeps the 2e-5 agreement of the JAX tests in f32. One block of 256
// threads per (64 query rows, batch*head); at hd 256 its tiles take 222,208
// bytes of shared memory, one block an SM. The q tile is staged once in
// shared memory, transposed and scaled; per 64-key tile K is staged
// transposed and V row-major. Thread (tx,ty) owns score rows 4ty..4ty+3 and
// columns 4tx..4tx+3 (float4 shared-memory reads), keeps the running max m,
// denominator l and its slice of the output accumulator for those rows in
// registers, reduces the row max across its 16-lane half-warp with shuffles,
// and writes P to shared memory for the PV product. q, k, v are read in
// place through their (batch, seq, head) strides; the head dim must be
// contiguous.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "../hopper.cuh"

namespace {

constexpr int kBQ = 64;        // f32: query rows per block
constexpr int kBK = 64;        // f32: keys per KV tile
constexpr int kThreads = 256;  // f32: 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kPad = 4;        // row padding that keeps float4 alignment
constexpr int kQS = kBQ + kPad;  // row stride of the transposed q tile
constexpr int kKS = kBK + kPad;  // row stride of the transposed k tile
constexpr int kPS = kBK + kPad;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * kQS + HD * kKS + kBK * HD + kBQ * kPS);
}

template <int HD>
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

  const float* q = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const float* k = static_cast<const float*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const float* v = static_cast<const float*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  float* o = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[2];

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
      float* orow = o + (q0 + row) * p.os[1];
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


template <int HD>
struct Bf16Tile {
  // hd 256 takes 64-key tiles: 128-key ones would need 328,704 bytes of
  // shared memory for q and the two-stage K/V ring, above the 232,448 a
  // block can have; 64-key ones need 197,632.
  static constexpr int BQ = 128, BKV = HD == 256 ? 64 : 128, kStages = 2;
  static constexpr int kConsumers = 2;                     // warpgroups of 64 rows
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
  static constexpr int ATOM = HD < 64 ? HD : 64;  // head-dim columns per atom
  static constexpr int ROW = 2 * ATOM;            // bytes of an atom row
  static constexpr hopper::Layout LAYOUT = ROW == 128 ? hopper::kB128 : hopper::kB64;
  static constexpr int Q_BYTES = BQ * HD * 2, KV_BYTES = BKV * HD * 2;
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 1024;  // + alignment
};

// 2^x by the special-function unit (relative error ~2^-22, subnormal
// results flushed to 0; 2^-inf = 0). (s - m) is formed exactly first, so a
// fully masked score, s = m = -1e30, gives 2^0 = 1 as in the TPU kernel.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(Bf16Tile<HD>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using T = Bf16Tile<HD>;
  constexpr int ATOMS = HD / T::ATOM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = hopper::align1024(smem_raw);  // [atom][BQ][ROW]
  uint8_t* skv = sq + T::Q_BYTES;  // stage s: K at 2s * KV_BYTES, V after it
  __shared__ __align__(8) uint64_t q_full, k_full[T::kStages], v_full[T::kStages],
      empty[T::kStages];

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;  // longest tiles first
  const int q_rows = min(T::BQ, p.Sq - q0);
  // KV tiles that hold a live key for some row of this q tile
  const int qlo = p.q_offset + q0, qhi = qlo + q_rows - 1;
  const int k_end = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int t_begin = k_begin / T::BKV;
  const int t_end = k_end > k_begin ? (k_end + T::BKV - 1) / T::BKV : t_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], T::kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kConsumers) {
    // producer: one thread loads q once, then K and V two tiles ahead
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 128 * T::kConsumers) {
      hopper::mbar_expect_tx(&q_full, T::Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        hopper::tma_load_4d(sq + a * T::BQ * T::ROW, &qmap, &q_full, a * T::ATOM,
                            h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % T::kStages;
        if (i >= T::kStages) hopper::mbar_wait(&empty[s], (i / T::kStages - 1) & 1);
        uint8_t* sk = skv + 2 * s * T::KV_BYTES;
        uint8_t* sv = sk + T::KV_BYTES;
        hopper::mbar_expect_tx(&k_full[s], T::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          hopper::tma_load_4d(sk + a * T::BKV * T::ROW, &kmap, &k_full[s],
                              a * T::ATOM, kvh, t * T::BKV, b);
        hopper::mbar_expect_tx(&v_full[s], T::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          hopper::tma_load_4d(sv + a * T::BKV * T::ROW, &vmap, &v_full[s],
                              a * T::ATOM, kvh, t * T::BKV, b);
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // rows row0, row0 + 8
    const int pos0 = qlo + row0;                            // absolute positions
    const int r_lo = qlo + wg * 64, r_hi = r_lo + 63;       // this warpgroup's
    float o[HD / 2], s[T::BKV / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share

    hopper::mbar_wait(&q_full, 0);
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, st = i % T::kStages;
      const uint32_t phase = (i / T::kStages) & 1;
      const uint8_t* sk = skv + 2 * st * T::KV_BYTES;
      const uint8_t* sv = sk + T::KV_BYTES;

      hopper::mbar_wait(&k_full[st], phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / T::ATOM, off = (kk * 16 % T::ATOM) * 2;
        hopper::Wgmma<T::BKV>::template ss<0>(
            s,
            hopper::make_desc(sq + (a * T::BQ + wg * 64) * T::ROW + off, 16,
                              8 * T::ROW, T::LAYOUT),
            hopper::make_desc(sk + a * T::BKV * T::ROW + off, 16, 8 * T::ROW,
                              T::LAYOUT),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // Each pass over the 64 scores is straight-line code: the uniform
      // softcap and mask tests stay outside the unrolled loops.
#pragma unroll
      for (int j = 0; j < T::BKV / 2; ++j) s[j] *= p.scale;
      if (p.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < T::BKV / 2; ++j) s[j] = p.softcap * tanhf(s[j] / p.softcap);
      }
      const int k0 = t * T::BKV;
      if (k0 + T::BKV > p.Sk || (p.causal && k0 + T::BKV - 1 > r_lo) ||
          (p.window > 0 && r_hi - k0 >= p.window)) {
#pragma unroll
        for (int j = 0; j < T::BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = pos0 + (e >> 1) * 8;
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const bool live = (!p.causal || kpos <= qpos) &&
                              (p.window <= 0 || qpos - kpos < p.window);
            float& x = s[4 * j + e];
            x = live ? x : kNegInf;
            if (kpos >= p.Sk) x = -CUDART_INF_F;  // past the end: probability 0
          }
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < T::BKV / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = fast_exp2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // P in bf16 pairs, as the A fragments of the BKV / 16 key steps
      uint32_t pa[T::BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < T::BKV / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const float p0 = fast_exp2((s[4 * j] - m[0]) * kLog2e);
          const float p1 = fast_exp2((s[4 * j + 1] - m[0]) * kLog2e);
          const float p2 = fast_exp2((s[4 * j + 2] - m[1]) * kLog2e);
          const float p3 = fast_exp2((s[4 * j + 3] - m[1]) * kLog2e);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pa[kk][2 * half] = hopper::pack_bf16(p0, p1);
          pa[kk][2 * half + 1] = hopper::pack_bf16(p2, p3);
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      hopper::mbar_wait(&v_full[st], phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::BKV / 16; ++kk)
        hopper::Wgmma<HD>::template rs<1>(
            o, pa[kk],
            hopper::make_desc(sv + kk * 16 * T::ROW, T::BKV * T::ROW, 8 * T::ROW,
                              T::LAYOUT),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      if (tid == 0) hopper::mbar_arrive(&empty[st]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float denom = fmaxf(lt, 1e-30f);
      const int row = row0 + 8 * r;
      if (q0 + row < p.Sq) {
        __nv_bfloat16* orow = out + (q0 + row) * p.os[1] + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tile<HD>;
  const void* base[3] = {p.q, p.k, p.v};
  const long long* st[3] = {p.qs, p.ks, p.vs};
  const int heads[3] = {p.H, p.KVH, p.KVH}, seq[3] = {p.Sq, p.Sk, p.Sk};
  const int rows[3] = {T::BQ, T::BKV, T::BKV};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    // (hd, head, seq, batch), the strides of the last three in bytes
    const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads[i]),
                                static_cast<cuuint64_t>(seq[i]),
                                static_cast<cuuint64_t>(p.B)};
    const cuuint64_t strides[3] = {2ull * st[i][2], 2ull * st[i][1],
                                   2ull * st[i][0]};
    const cuuint32_t box[4] = {T::ATOM, 1, static_cast<cuuint32_t>(rows[i]), 1};
    const int err = hopper::make_bf16_map(
        &maps[i], base[i], 4, dims, strides, box,
        T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + T::BQ - 1) / T::BQ, p.B * p.H);
  flash_bf16_kernel<HD><<<grid, T::kThreads, T::SMEM, stream>>>(maps[0], maps[1],
                                                                 maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int hd, int bf16, cudaStream_t stream) {
  switch (hd) {
    case 32: return bf16 ? launch_bf16<32>(p, stream) : launch_f32<32>(p, stream);
    case 64: return bf16 ? launch_bf16<64>(p, stream) : launch_f32<64>(p, stream);
    case 128: return bf16 ? launch_bf16<128>(p, stream) : launch_f32<128>(p, stream);
    case 256: return bf16 ? launch_bf16<256>(p, stream) : launch_f32<256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o in turn.
// dtype: 0 = f32, 1 = bf16 (all four tensors). bf16 takes strides that are
// multiples of 8 elements and 16-byte aligned bases (TMA).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int KVH, int hd, const long long* strides,
                                   int causal, int window, float softcap,
                                   int q_offset, float scale, int dtype,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  return dispatch(p, hd, dtype, static_cast<cudaStream_t>(stream));
}
