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

// -- kernel 2: the sum of the partial rows ----------------------------------
//
// out[i] (i < nK) or db[i - nK] = the sum of column i over the nparts
// partial rows of width W (db may be null when W == nK).  The rows are
// kernel 1's, written just before and read from L2 (9.7 MB at N = 256,
// C = Cout = 32: 132 rows of 18464 columns).  A block takes 64 columns,
// two a lane with 8-byte loads; its kSumWarps warps take the rows in
// contiguous shares (warp w the rows [w * per, (w + 1) * per)), each lane
// adding its share into kSumAcc accumulators in turn, so that kSumAcc
// loads of a thread are in flight; then the first warp adds the shares of
// each column in warp order from shared memory.  One launch, no atomics:
// the sums are the same from run to run.  (It was one thread a column
// summing every row in turn: 37 blocks on 132 SMs, each thread a chain of
// 132 dependent loads.)  Of the geometries timed on an H100 (two or four
// columns a lane, 2 to 32 warps, 4 or 8 accumulators) this one was the
// fastest at every width; what remains is mostly the launch (a block
// that reads almost nothing takes 0.0058 ms so timed).
constexpr int kSumWarps = 16;   // warps of a block, a share of the rows each
constexpr int kSumAcc = 4;      // accumulators (loads in flight) a thread
constexpr int kSumCols = 64;    // columns of a block, two a lane

__global__ void __launch_bounds__(32 * kSumWarps)
sum_partial_rows(const float* __restrict__ partial, int nparts, int W,
                 int nK, float* __restrict__ out, float* __restrict__ db) {
  __shared__ float2 share[kSumWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * kSumCols + 2 * lane;
  const int per = (nparts + kSumWarps - 1) / kSumWarps;
  const int p0 = warp * per, p1 = min(nparts, p0 + per);
  auto add = [](float2& a, const float2& x) { a.x += x.x; a.y += x.y; };
  float2 acc[kSumAcc];
#pragma unroll
  for (int k = 0; k < kSumAcc; ++k) acc[k] = make_float2(0.f, 0.f);
  if (col < W) {
    const float* at = partial + col;
    const bool vec = W % 2 == 0;   // rows 8-byte aligned: one load a row
    auto load = [&](int p) {
      const float* row = at + (size_t)p * W;
      if (vec) return __ldg(reinterpret_cast<const float2*>(row));
      return make_float2(__ldg(row), col + 1 < W ? __ldg(row + 1) : 0.f);
    };
    int p = p0;
    for (; p + kSumAcc <= p1; p += kSumAcc) {
      float2 x[kSumAcc];
#pragma unroll
      for (int k = 0; k < kSumAcc; ++k) x[k] = load(p + k);
#pragma unroll
      for (int k = 0; k < kSumAcc; ++k) add(acc[k], x[k]);
    }
#pragma unroll
    for (int k = 0; k < kSumAcc; ++k)
      if (p + k < p1) add(acc[k], load(p + k));
  }
#pragma unroll
  for (int m = kSumAcc / 2; m > 0; m /= 2)
#pragma unroll
    for (int k = 0; k < m; ++k) add(acc[k], acc[k + m]);
  share[warp][lane] = acc[0];
  __syncthreads();
  if (warp == 0 && col < W) {
    float2 t = share[0][lane];
    for (int w = 1; w < kSumWarps; ++w) add(t, share[w][lane]);
    if (col + 1 < nK) {
      *reinterpret_cast<float2*>(out + col) = t;   // nK is even: 18 C Cout
    } else {
      for (int i = 0; i < 2 && col + i < W; ++i) {
        const float v = i ? t.y : t.x;
        if (col + i < nK) out[col + i] = v; else db[col + i - nK] = v;
      }
    }
  }
}

// Launches sum_partial_rows over W columns; returns a cudaError_t.
inline int launch_sum_partial_rows(const float* partial, int nparts, int W,
                                   int nK, float* out, float* db,
                                   cudaStream_t stream) {
  const int grid = (W + kSumCols - 1) / kSumCols;
  sum_partial_rows<<<grid, 32 * kSumWarps, 0, stream>>>(partial, nparts, W,
                                                        nK, out, db);
  return cudaGetLastError();
}

}  // namespace risi18
