// What every kernel of the package shares: the element types, the
// vertex's structure (load_vertex, load_adjacency) and kernel 2 of the two
// backward kernels (sum_partial_rows).  The stream of a vertex's slots, its
// reductions and the products with K are in risi18_level_common.cuh and
// the blocks built on it (risi18_forward_block.cuh for K1, K4 and K6,
// risi18_backward_block.cuh for K2 and K5).
//
// Per vertex v, with Ap = max(A[v], 0) (the adj>0 guard), R[d] =
// sum_e Ap[d,e], S = sum Ap and trA = tr Ap, the slots T[a,b,c,f] are
//   gathered     (K1, K2): state[nbr[v,a], pos[v,a,b], pos[v,a,c], f], zero
//                when the id is outside [0, N) or a position outside [0, P)
//                (load_vertex marks both -1), or
//   materialised (K4, K5, K6): T[v,a,b,c,f], read as stored; the
//                take-gather that built T already wrote zeros where a slot
//                is absent.
// One channel chunk yields the shared reductions of
// graphflow_tpu/ops/fused.py:54-67 and :87-93 (risi18_level_common.cuh
// names them); every sum is in float32, a bfloat16 value is converted once,
// on load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace risi18 {

constexpr int kCases = 18;
constexpr int kThreads = 256;                    // sum_partial_rows' blocks
constexpr size_t kMaxSmemBytes = 232448;         // per block on sm_90

// -- element types ----------------------------------------------------------

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store_value(float* p, float x) { *p = x; }
__device__ inline void store_value(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// -- the vertex's structure -------------------------------------------------

// Loads vertex v's guarded adjacency Ap (row stride ALD), then R, and S, trA
// into scal[0], scal[1].  Ends with a barrier.
__device__ inline void load_adjacency(const float* __restrict__ radj,
                                      size_t v, int P, int ALD, float* Ap,
                                      float* R, float* scal) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  for (int i = tid; i < PP; i += nth) {
    const float a = radj[v * PP + i];
    Ap[(i / P) * ALD + (i % P)] = a > 0.f ? a : 0.f;
  }
  __syncthreads();
  for (int d = tid; d < P; d += nth) {
    float s = 0.f;
    for (int e = 0; e < P; ++e) s += Ap[d * ALD + e];
    R[d] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, tr = 0.f;
    for (int d = 0; d < P; ++d) { s += R[d]; tr += Ap[d * ALD + d]; }
    scal[0] = s;
    scal[1] = tr;
  }
  __syncthreads();
}

// load_adjacency, after loading vertex v's neighbour ids and positions (-1
// marks an absent slot or position; nothing out of range is read).
__device__ inline void load_vertex(const int* __restrict__ nbr,
                                   const int* __restrict__ pos,
                                   const float* __restrict__ radj, size_t v,
                                   int N, int P, int ALD, float* Ap, float* R,
                                   float* scal, int* snbr, int* spos) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  for (int i = tid; i < PP; i += nth) {
    const int p = pos[v * PP + i];
    spos[i] = (p >= 0 && p < P) ? p : -1;
  }
  for (int i = tid; i < P; i += nth) {
    const int n = nbr[v * P + i];
    snbr[i] = (n >= 0 && n < N) ? n : -1;
  }
  load_adjacency(radj, v, P, ALD, Ap, R, scal);
}

// out[i] (i < nK) or db[i - nK] = the sum of column i over the nparts
// partial rows of width W (db may be null when W == nK).
__global__ void __launch_bounds__(kThreads)
sum_partial_rows(const float* __restrict__ partial, int nparts, int W,
                 int nK, float* __restrict__ out, float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * W + i];
  if (i < nK) out[i] = s; else db[i - nK] = s;
}

// Launches sum_partial_rows over W columns; returns a cudaError_t.
inline int launch_sum_partial_rows(const float* partial, int nparts, int W,
                                   int nK, float* out, float* db,
                                   cudaStream_t stream) {
  const int grid = (W + kThreads - 1) / kThreads;
  sum_partial_rows<<<grid, kThreads, 0, stream>>>(partial, nparts, W, nK,
                                                  out, db);
  return cudaGetLastError();
}

}  // namespace risi18
