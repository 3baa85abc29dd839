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
//
// A second entry, message_pass_typed_kernel, computes the same step without the
// edge tensor. The model's edge tensor holds edge_w[e, bonds[b,i,j]] at every
// pair: only nb (<= 4) distinct Hd x Hd matrices per member. For h (E,B,N,Hd),
// bonds (B,N,N) int32, edge_w (E,nb,Hd*Hd) and adj (B,N,N) (bonds and adj may
// carry a leading (E,) axis, one batch per member) it computes
//
//     m[e,b,i,k] = sum_t sum_j adj[b,i,j] [bonds[b,i,j] == t] X_t[e,b,j,k],
//     X_t[e,b,j,k] = sum_l edge_w[e,t,k*Hd+l] h[e,b,j,l],
//
// in f32 FMA (no tensor cores), written in h's dtype. Pairs with adj = 0
// contribute an exact 0 in the dense form and are skipped; a bond type outside
// [0, nb) contributes nothing. It replaces no TPU kernel: the JAX package
// always builds the edge tensor, whose write and three reads were nearly all
// of the surrogate's re-score on this card.
//
// Bound: operations. Its inputs are a few bytes a pair, and the step's work
// is 2 Hd^2 a member for each adjacent pair; this design does 2 Hd^2 a member
// for each atom row and bond type present instead (about 1.8x at the
// surrogate's density, 0.106), as dense register-tiled products.
//
// Design: one 128-thread block per (member, tile of molecules, 64 output
// channels). The block's 64-channel slice of every type's matrix is copied
// to shared memory once (cp.async) and reused over its tile, which it walks
// in sub-tiles of whole molecules, at most 64 atom rows. For each sub-tile
// it copies h and the pairs' adj and bonds to shared memory, builds each
// row's list of nonzero pairs grouped by type (a lane a pair, places from
// warp ballots), and for each type present: X_t = h W_t^T, 8 rows x 4
// channels a thread, both operands read as float4 along l from rows padded
// to a stride of 4 mod 8 floats (no bank conflicts), skipped by warps whose
// rows no pair reads under t; then each thread adds adj * X_t[j] over its
// rows' pairs of type t into its 8 x 4 sums. The grid is sized to one wave
// of resident blocks (two an SM at N = 16, Hd = 64), so a block's tile, and
// the reuse of its staged matrices, grows with the batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

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


constexpr int kTypedThreads = 128;
constexpr int kTypedRows = 64;      // atom rows of a sub-tile
constexpr int kTypedCols = 64;      // output channels of a block
constexpr int kMaxBondTypes = 4;

// Row stride of the staged (rows x Hd) tiles, in floats: a multiple of 4 (for
// float4 loads) that is 4 mod 8, so that 8 threads reading float4s from 8
// consecutive rows hit 32 distinct banks.
__host__ __device__ inline int typed_stride(int hidden) {
  return (hidden + 7) / 8 * 8 + 4;
}

// Row stride of X_t (rows x the block's 64 channels), 4 mod 8 as above.
constexpr int kTypedXStride = kTypedCols + 4;

// Floats of the region that holds a sub-tile's adj and bonds until its
// neighbour lists are built, then X_t.
__host__ __device__ inline int typed_pair_region(int n_atoms) {
  const int x = kTypedRows * kTypedXStride;
  const int pairs = 2 * kTypedRows * n_atoms;
  return x > pairs ? x : pairs;
}

__host__ inline size_t typed_smem_bytes(int n_atoms, int hidden, int n_types) {
  const size_t ld = typed_stride(hidden);
  return sizeof(float) * (ld * (static_cast<size_t>(n_types) * kTypedCols  // W
                                + kTypedRows)                              // h
                          + typed_pair_region(n_atoms))            // X
         + (sizeof(int) + sizeof(float)) * kTypedRows * n_atoms      // lists
         + sizeof(int) * ((kMaxBondTypes + 2) * kTypedRows + 1);  // starts,
                                                   // referenced types, mask
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies from device to shared memory (sm_80 and later): many
// in flight a thread, no registers held while they land.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_address(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// vec_rows: T is float, Hd % 4 == 0 and h, edge_w are 16-byte aligned, so
// rows of h and edge_w are copied 16 bytes at a time (and no column past Hd
// is read). vec_pairs: N is even and adj, bonds are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kTypedThreads)
message_pass_typed_kernel(const T* __restrict__ h, const int* __restrict__ bonds,
                          const T* __restrict__ edge_w,
                          const float* __restrict__ adj, T* __restrict__ out,
                          int batch, int n_atoms, int hidden, int n_types,
                          int mols_per_block, int64_t bonds_member_stride,
                          int64_t adj_member_stride, int vec_rows,
                          int vec_pairs) {
  extern __shared__ float4 smem4[];
  const int ld = typed_stride(hidden);
  const int lp = (hidden + 3) / 4 * 4;        // l extent of the products
  float* ws = reinterpret_cast<float*>(smem4);          // [type][col][ld]
  float* hs = ws + n_types * kTypedCols * ld;           // [row][ld]: h
  float* xs = hs + kTypedRows * ld;          // [row][kTypedXStride]: X_t
  float* adj_s = xs;                                    // [row][N], then xs
  int* bond_s = reinterpret_cast<int*>(xs + kTypedRows * n_atoms);
  int* nbr_row = reinterpret_cast<int*>(xs + typed_pair_region(n_atoms));
  float* nbr_adj = reinterpret_cast<float*>(nbr_row + kTypedRows * n_atoms);
  // nbr_start[t][r]: row r's pairs of type t are its entries
  // [nbr_start[t][r], nbr_start[t + 1][r])
  int* nbr_start = reinterpret_cast<int*>(nbr_adj + kTypedRows * n_atoms);
  int* ref_types = nbr_start + (kMaxBondTypes + 1) * kTypedRows;
  int* present = ref_types + kTypedRows;      // bond types of the sub-tile

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15;                    // channels tx + 16 q
  const int ty = tid >> 4;                    // rows 8 ty + i
  const int e = blockIdx.y;
  const int k0 = blockIdx.z * kTypedCols;
  const int kc = min(kTypedCols, hidden - k0);
  const int mol0 = blockIdx.x * mols_per_block;
  const int mol1 = min(batch, mol0 + mols_per_block);
  const int mols_sub = kTypedRows / n_atoms;
  const int* bonds_e = bonds + e * bonds_member_stride;
  const float* adj_e = adj + e * adj_member_stride;
  const T* w_e = edge_w + static_cast<int64_t>(e) * n_types * hidden * hidden;
  // list building: a row's pairs on `span` lanes (N rounded up to a power
  // of 2), 32 / span rows a warp
  int span = 1;
  while (span < n_atoms) span *= 2;
  const int seg = lane & ~(span - 1);         // first lane of this row
  const unsigned seg_mask =
      span == 32 ? 0xffffffffu : ((1u << span) - 1u) << seg;
  const unsigned below = (1u << lane) - 1u;

  // The block's slice of every type's matrix, ws[t][c][l] =
  // edge_w[e, t, (k0 + c) * Hd + l], lands with the first sub-tile. Columns
  // past kc are left as they are: their sums are never stored.
  if (vec_rows) {
    const int q = hidden / 4;
    for (int idx = tid; idx < n_types * kc * q; idx += kTypedThreads) {
      const int tc = idx / q, l4 = idx - tc * q;
      const int t = tc / kc, c = tc - t * kc;
      cp_async16(ws + (t * kTypedCols + c) * ld + 4 * l4,
                 w_e + (static_cast<int64_t>(t) * hidden + k0 + c) * hidden +
                     4 * l4);
    }
  } else {
    for (int idx = tid; idx < n_types * kTypedCols * lp; idx += kTypedThreads) {
      const int tc = idx / lp, l = idx - tc * lp;
      const int t = tc / kTypedCols, c = tc - t * kTypedCols;
      ws[tc * ld + l] =
          (c < kc && l < hidden)
              ? to_f32(w_e[(static_cast<int64_t>(t) * hidden + k0 + c) * hidden + l])
              : 0.f;
    }
  }

  for (int mol_s = mol0; mol_s < mol1; mol_s += mols_sub) {
    const int n_rows = min(mols_sub, mol1 - mol_s) * n_atoms;
    const int64_t row0 = (static_cast<int64_t>(e) * batch + mol_s) * n_atoms;
    const int64_t pair0 = static_cast<int64_t>(mol_s) * n_atoms * n_atoms;
    __syncthreads();    // the previous sub-tile is done with hs, xs, lists
    if (tid == 0) *present = 0;
    if (tid < kTypedRows) ref_types[tid] = 0;

    if (vec_rows) {
      const int q = hidden / 4;
      for (int idx = tid; idx < n_rows * q; idx += kTypedThreads) {
        const int r = idx / q, l4 = idx - r * q;
        cp_async16(hs + r * ld + 4 * l4, h + (row0 + r) * hidden + 4 * l4);
      }
    } else {
      for (int idx = tid; idx < n_rows * lp; idx += kTypedThreads) {
        const int r = idx / lp, l = idx - r * lp;
        hs[r * ld + l] = l < hidden ? to_f32(h[(row0 + r) * hidden + l]) : 0.f;
      }
    }
    const int n_pairs = n_rows * n_atoms;
    if (vec_pairs) {
      for (int idx = 4 * tid; idx < n_pairs; idx += 4 * kTypedThreads) {
        cp_async16(adj_s + idx, adj_e + pair0 + idx);
        cp_async16(bond_s + idx, bonds_e + pair0 + idx);
      }
    } else {
      for (int idx = tid; idx < n_pairs; idx += kTypedThreads) {
        cp_async4(adj_s + idx, adj_e + pair0 + idx);
        cp_async4(bond_s + idx, bonds_e + pair0 + idx);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // Each row's pairs with adj != 0 and a type in [0, nb), grouped by type
    // in order of j, as (row of j in the sub-tile, adj): a lane a pair, the
    // places from ballots. ref_types[j]: the types under which row j is
    // some row's neighbour, i.e. the X_t rows that are read.
    for (int r0 = warp * (32 / span); r0 < kTypedRows;
         r0 += (kTypedThreads / span)) {
      const int r = r0 + lane / span;
      const int j = lane - seg;
      const bool live = j < n_atoms && r < n_rows;
      const float a = live ? adj_s[r * n_atoms + j] : 0.f;
      const int t = live ? bond_s[r * n_atoms + j] : -1;
      const bool ok = a != 0.f && t >= 0 && t < n_types;
      int at = 0, place = 0;
      unsigned types = 0;
#pragma unroll
      for (int u = 0; u < kMaxBondTypes; ++u) {
        const unsigned of_u = __ballot_sync(0xffffffffu, ok && t == u) & seg_mask;
        if (j == 0) nbr_start[u * kTypedRows + r] = at;
        if (ok && t == u) place = at + __popc(of_u & below);
        at += __popc(of_u);
        types |= (of_u ? 1u : 0u) << u;
      }
      if (j == 0) nbr_start[kMaxBondTypes * kTypedRows + r] = at;
      if (ok) {
        const int jr = r - r % n_atoms + j;     // row of atom j
        nbr_row[r * n_atoms + place] = jr;
        nbr_adj[r * n_atoms + place] = a;
        atomicOr(ref_types + jr, 1 << t);
      }
      if (j == 0 && types) atomicOr(present, static_cast<int>(types));
    }
    __syncthreads();    // lists complete; adj_s and bond_s may be overwritten

    const unsigned types = static_cast<unsigned>(*present);
    unsigned mine = 0;                 // types under which my rows are read
#pragma unroll
    for (int i = 0; i < 8; ++i) mine |= static_cast<unsigned>(ref_types[8 * ty + i]);

    float acc[8][4];                   // m: rows 8 ty + i, channels tx + 16 q
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    }

    for (int t = 0; t < n_types; ++t) {
      if (!(types >> t & 1u)) continue;
      // X_t = h W_t^T on the rows that some row reads under type t (a warp
      // whose 16 rows none reads skips it).
      if (__any_sync(0xffffffffu, mine >> t & 1u)) {
        float x[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) x[i][q] = 0.f;
        }
        const float* wt = ws + t * kTypedCols * ld;
#pragma unroll 2
        for (int l = 0; l < lp; l += 4) {
          float4 b[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            b[q] = *reinterpret_cast<const float4*>(wt + (tx + 16 * q) * ld + l);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a =
                *reinterpret_cast<const float4*>(hs + (8 * ty + i) * ld + l);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              x[i][q] = fmaf(a.x, b[q].x, x[i][q]);
              x[i][q] = fmaf(a.y, b[q].y, x[i][q]);
              x[i][q] = fmaf(a.z, b[q].z, x[i][q]);
              x[i][q] = fmaf(a.w, b[q].w, x[i][q]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            xs[(8 * ty + i) * kTypedXStride + tx + 16 * q] = x[i][q];
          }
        }
      }
      __syncthreads();

      // m[r] += adj * X_t[j] over r's pairs of type t
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * ty + i;
        const int p1 = nbr_start[(t + 1) * kTypedRows + r];
        for (int p = nbr_start[t * kTypedRows + r]; p < p1; ++p) {
          const float a = nbr_adj[r * n_atoms + p];
          const float* xj = xs + nbr_row[r * n_atoms + p] * kTypedXStride + tx;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a, xj[16 * q], acc[i][q]);
        }
      }
      __syncthreads();  // before the next type overwrites xs
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * ty + i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tx + 16 * q;
        if (c < kc) store(out + (row0 + r) * hidden + k0 + c, acc[i][q]);
      }
    }
  }
}

template <typename T>
int launch_typed(const void* h, const void* bonds, const void* edge_w,
                 const void* adj, void* out, int members, int batch,
                 int n_atoms, int hidden, int n_types,
                 int64_t bonds_member_stride, int64_t adj_member_stride,
                 cudaStream_t stream) {
  // Once per device: more than 48 KB of dynamic shared memory and all of
  // the SM's unified L1/shared memory as shared memory; the SM count; the
  // blocks resident an SM at the last size of shared memory asked for
  // (threads that race here at most size a grid for another size: any grid
  // gives the same result).
  struct DeviceState {
    bool ready = false;
    int sms = 0;
    size_t smem = 0;
    int resident = 1;
  };
  static DeviceState states[64];
  DeviceState local;
  int device = 0;
  cudaGetDevice(&device);
  DeviceState& st = device < 64 ? states[device] : local;
  const size_t smem = typed_smem_bytes(n_atoms, hidden, n_types);
  auto kernel = message_pass_typed_kernel<T>;
  if (!st.ready) {
    int max_smem = 0;
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    st.ready = true;
  }
  if (st.smem != smem) {
    int resident = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                  kTypedThreads, smem);
    st.smem = smem;
    st.resident = std::max(resident, 1);
  }
  // One wave of resident blocks, each over a whole number of sub-tiles.
  const int sms = st.sms, resident = st.resident;
  const int mols_sub = kTypedRows / n_atoms;
  const int64_t units = (batch + mols_sub - 1) / mols_sub;
  const int col_tiles = (hidden + kTypedCols - 1) / kTypedCols;
  const int64_t slots = static_cast<int64_t>(resident) * sms;
  const int64_t per_block =
      std::max<int64_t>(1, (members * col_tiles * units + slots - 1) / slots);
  const int mols_per_block = static_cast<int>(per_block * mols_sub);
  const dim3 grid(static_cast<unsigned>((batch + mols_per_block - 1) /
                                        mols_per_block),
                  static_cast<unsigned>(members),
                  static_cast<unsigned>(col_tiles));
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_rows = std::is_same<T, float>::value && hidden % 4 == 0 &&
                       aligned(h) && aligned(edge_w);
  const int vec_pairs = n_atoms % 2 == 0 && aligned(adj) && aligned(bonds);
  kernel<<<grid, kTypedThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const int*>(bonds),
      static_cast<const T*>(edge_w), static_cast<const float*>(adj),
      static_cast<T*>(out), batch, n_atoms, hidden, n_types, mols_per_block,
      bonds_member_stride, adj_member_stride, vec_rows, vec_pairs);
  return 0;
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

// h, edge_w and out: dtype 0 = float32, 1 = bfloat16; bonds int32; adj
// float32. bonds_member_stride and adj_member_stride are 0 for one batch that
// every member scores, or B*N*N for one batch per member. The launch goes to
// `stream` of `device`, which is made current for it and then restored.
extern "C" int mpnn_message_pass_typed(const void* h, const void* bonds,
                                       const void* edge_w, const void* adj,
                                       void* out, int members, long long batch,
                                       int n_atoms, int hidden, int n_types,
                                       long long bonds_member_stride,
                                       long long adj_member_stride, int dtype,
                                       int device, void* stream) {
  if (members < 1 || members > 65535 || batch < 1 || batch > 0x7fffffffLL ||
      n_atoms < 1 || n_atoms > kMaxAtoms || hidden < 1 ||
      hidden > kMaxHidden || n_types < 1 || n_types > kMaxBondTypes ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int previous = 0;
  cudaError_t set = cudaGetDevice(&previous);
  if (set == cudaSuccess && previous != device) set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = dtype == 0
      ? launch_typed<float>(h, bonds, edge_w, adj, out, members,
                            static_cast<int>(batch), n_atoms, hidden, n_types,
                            bonds_member_stride, adj_member_stride, s)
      : launch_typed<__nv_bfloat16>(h, bonds, edge_w, adj, out, members,
                                    static_cast<int>(batch), n_atoms, hidden,
                                    n_types, bonds_member_stride,
                                    adj_member_stride, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return err;
}
