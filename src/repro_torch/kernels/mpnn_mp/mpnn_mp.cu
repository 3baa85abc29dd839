// Dense-adjacency MPNN message step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mpnn_mp/mpnn_mp.py::message_pass_pallas
// (_kernel). Computes, for h (B,N,Hd), edge (B,N,N,Hd,Hd), adj (B,N,N):
//
//     m[b,i,k] = sum_j adj[b,i,j] * sum_l edge[b,i,j,k,l] * h[b,j,l]
//
// in f32, written in h's dtype (f32 or bf16). N <= 32 and Hd <= 128, the
// limits the TPU kernel names.
//
// Bound: device-memory bytes. Every edge element is read once and used in one
// multiply-add, so the kernel does 2 flops per edge element (0.5 flop/byte in
// f32), far below the card's ridge point; the edge tensor is all but the whole
// of the traffic (4 MiB per molecule at N=16, Hd=64, f32).
//
// Design: one block per (molecule b, target atom i). The block first stages
// adj[b,i,j] * h[b,j,:] for all j in shared memory as f32. Each warp then owns
// output channels k = warp, warp + 8, ...; for each k its lanes walk the
// contiguous rows edge[b,i,j,k,:] (coalesced, each element read once), multiply
// by the staged row and accumulate in f32, and a shuffle reduction gives
// m[b,i,k]. All zero-adjacency pairs are still read, as the TPU kernel reads
// them. Offsets into edge are 64-bit: one chunk of the surrogate
// (16 members x 128 molecules) holds exactly 2^31 edge elements.
//
// Plain C interface, loaded with ctypes; the launch goes to the caller's
// stream and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxAtoms = 32;
constexpr int kMaxHidden = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
message_pass_kernel(const T* __restrict__ h, const T* __restrict__ edge,
                    const float* __restrict__ adj, T* __restrict__ out,
                    int n_atoms, int hidden) {
  extern __shared__ float hs[];  // (N, Hd): adj[b,i,j] * h[b,j,l]
  const int64_t bi = blockIdx.x;  // b * N + i
  const int64_t b = bi / n_atoms;
  const int nh = n_atoms * hidden;

  const T* hb = h + b * nh;
  const float* arow = adj + bi * n_atoms;
  for (int t = threadIdx.x; t < nh; t += blockDim.x) {
    hs[t] = arow[t / hidden] * to_f32(hb[t]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t row_stride = static_cast<int64_t>(hidden) * hidden;  // j -> j+1
  const T* e = edge + bi * (n_atoms * row_stride);

  for (int k = warp; k < hidden; k += n_warps) {
    const T* ek = e + static_cast<int64_t>(k) * hidden;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_atoms; ++j) {
      const T* row = ek + j * row_stride;
      const float* hj = hs + j * hidden;
      for (int l = lane; l < hidden; l += 32) {
        acc = fmaf(to_f32(row[l]), hj[l], acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) store(out + bi * hidden + k, acc);
  }
}

template <typename T>
void launch(const void* h, const void* edge, const void* adj, void* out,
            int64_t grid, int n_atoms, int hidden, cudaStream_t stream) {
  const size_t smem = sizeof(float) * n_atoms * hidden;
  message_pass_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(edge),
      static_cast<const float*>(adj), static_cast<T*>(out), n_atoms, hidden);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, edge and out); adj is always float32.
extern "C" int mpnn_message_pass(const void* h, const void* edge, const void* adj,
                                 void* out, long long batch, int n_atoms,
                                 int hidden, int dtype, void* stream) {
  if (batch < 1 || n_atoms < 1 || n_atoms > kMaxAtoms || hidden < 1 ||
      hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = static_cast<int64_t>(batch) * n_atoms;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(h, edge, adj, out, grid, n_atoms, hidden, s); break;
    case 1: launch<__nv_bfloat16>(h, edge, adj, out, grid, n_atoms, hidden, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
