// The adjoint of the bank (risi18_bank.cu, K4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// graphflow_tpu/ops/risi_pallas.py (run by risi18_matmul_pallas_bwd, the
// backward of risi18_bank_train).  Given the bank's inputs T [N,P,P,P,C],
// A [N,P,P] (float32) and K [18C,Cout], and the cotangent g [N,P*P,Cout] of
// its output Z, it computes
//   dT [N,P,P,P,C]  in T's type, and
//   dK [18C,Cout]   summed over every vertex, in float32 (the caller casts
//                   it to K's type, as the JAX package does).
// A gets no gradient: the graph structure is not differentiated.  T, K and
// g are float32 or bfloat16, all of one type.
//
// The algebra is the level backward's (risi18_level_bwd.cu, K2; device code
// in risi18_common.cuh) on the cotangent g itself: the bank has no bias and
// no LeakyReLU, so there is no geff and no db.  Per vertex, with G = g[v] as
// [P,P,Cout], GAp = G Ap, GR = G R and GA = sum Ap * G, dK per case is one
// short dot product of a reduction of T with G, GAp or GR, or a scalar times
// GA; and with the reductions' cotangents dTab, dTbc, dM6, dM10, dDbc, dDac,
//   dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
//             + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].
// Unlike K2's dstate, each vertex owns its block of dT, so it is written
// once, without atomics.
//
// Design.  Kernel 1 walks vertices (grid-stride, at most 264 blocks, two per
// SM) and, per vertex, channel chunks of Cc, all in shared memory: G, GAp,
// GR, GA once per vertex; per chunk, K's chunk rows, T's reductions (read
// straight from T), the dK chunk (added into the block's own partial row in
// global memory: no atomics, so dK is the same from run to run), the
// reductions' cotangents, and the chunk's channels of dT.  Kernel 2 sums the
// partial rows into dK.  All sums are in float32; bfloat16 is converted once
// on load and rounded once on store.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32) the
// dK and the cotangent products are ~0.6 G FMAs each, fed from shared
// memory; T is read once and dT written once (134 MB each in float32, 67 MB
// in bfloat16).  T does not fit in L2, and phase 1 of the reductions keeps
// only P*Cc threads busy, each waiting on device memory (see risi18_bank.cu).
// Staging T in shared memory, tensor cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_common.cuh"

namespace {

using risi18::BackwardLayout;
using risi18::kCases;
using risi18::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
risi18_bank_bwd_kernel(const E* __restrict__ T, const float* __restrict__ A,
                       const E* __restrict__ K, const E* __restrict__ gout,
                       E* __restrict__ dT, float* __restrict__ partial,
                       int N, BackwardLayout L) {
  extern __shared__ float smem[];
  const int P = L.P, C = L.C, Cout = L.Cout, Cc = L.Cc;
  const int LD = L.LD, ALD = L.ALD, GLD = L.GLD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  float* G = smem + L.g;
  float* GAp = smem + L.gap;
  float* GR = smem + L.gr;
  float* GA = smem + L.ga;
  const risi18::ChunkMaps m = risi18::chunk_maps(smem, L.maps, P, Cc, LD);
  float* Ks = smem + L.ks;

  // This block's partial sums of dK, rows case*C + f.
  float* part = partial + blockIdx.x * (size_t)kCases * C * Cout;

  for (size_t v = blockIdx.x; v < (size_t)N; v += gridDim.x) {
    const bool first = v == blockIdx.x;
    const E* gv = gout + v * PP * Cout;
    for (int i = tid; i < PP * Cout; i += nth)
      G[(i / Cout) * GLD + (i % Cout)] = risi18::to_float(gv[i]);
    risi18::load_adjacency(A, v, P, ALD, Ap, R, smem + L.scal);
    const float S = smem[L.scal], trA = smem[L.scal + 1];
    risi18::adjacency_products(G, Ap, R, GAp, GR, GA, P, Cout, ALD, GLD,
                               nullptr, first);
    const size_t block = v * PP * P * C;
    const risi18::BankSlots<E> slots{T + block, P, C};
    E* dTv = dT + block;

    for (int c0 = 0; c0 < C; c0 += Cc) {
      const int nc = min(Cc, C - c0);
      risi18::stage_K(K, Ks, C, c0, nc, Cc, Cout, GLD);
      risi18::chunk_reductions(slots, R, P, c0, nc, LD, m);
      risi18::dk_chunk(m, G, GAp, GR, GA, S, trA, part, first, P, C, c0, nc,
                       Cout, LD, GLD);
      risi18::reduction_cotangents(m, G, GAp, GR, GA, Ks, S, trA, P, Cc, nc,
                                   Cout, LD, GLD);

      // dT of this chunk, item (a, b, f): row b of slot a, channel c0 + f.
      // Every entry is written once, so the items need no order.
      for (int item = tid; item < PP * nc; item += nth) {
        const int f = item % nc, ab0 = item / nc;
        const int a = ab0 / P, b = ab0 % P, ab = f * LD + ab0;
        const float dtab = m.tab[ab], dm6 = m.m6[ab];
        const float ddbc = m.dbc[ab], ddac = m.dac[ab], ra = R[a];
        const float* dtbc = m.tbc + f * LD + b * P;
        const float* dm10 = m.m10 + f * LD + b * P;
        E* row = dTv + ((size_t)ab0 * P) * C + c0 + f;
        for (int c = 0; c < P; ++c) {
          float val = dtab + dtbc[c] + dm6 * R[c] + ra * dm10[c];
          if (c == b) val += ddbc;
          if (c == a) val += ddac;
          risi18::store_value(row + (size_t)c * C, val);
        }
      }
      __syncthreads();
    }
  }
}

template <typename E>
int launch(const void* T, const void* A, const void* K, const void* g,
           void* dT, void* partial, int N, int P, int C, int Cout,
           int nblocks, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (nblocks != risi18::partial_blocks(N)) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  auto make = [&](int Cc) {
    return risi18::make_backward_layout(P, C, Cout, Cc, false);
  };
  const int Cc = risi18::choose_chunk(C, make);
  if (Cc == 0) return cudaErrorInvalidValue;
  const BackwardLayout L = make(Cc);
  const size_t bytes = risi18::smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      risi18_bank_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  risi18_bank_bwd_kernel<E><<<nblocks, kThreads, bytes,
                              (cudaStream_t)stream>>>(
      (const E*)T, (const float*)A, (const E*)K, (const E*)g, (E*)dT,
      (float*)partial, N, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of partial rows (blocks of kernel 1) for N vertices.
int risi18_bank_backward_blocks(int N) { return risi18::partial_blocks(N); }

// Kernel 1 on `stream`; returns a cudaError_t (0 on success).
// T [N,P,P,P,C], A [N,P,P] f32, K [18C,Cout], g [N,P*P,Cout] -> dT
// [N,P,P,P,C] (every element written) and partial [nblocks, 18C*Cout] f32,
// all contiguous; T, K, g and dT are f32 (_f32) or bf16 (_bf16);
// nblocks = risi18_bank_backward_blocks(N).
int risi18_bank_backward_f32(const void* T, const void* A, const void* K,
                             const void* g, void* dT, void* partial, int N,
                             int P, int C, int Cout, int nblocks,
                             void* stream) {
  return launch<float>(T, A, K, g, dT, partial, N, P, C, Cout, nblocks,
                       stream);
}

int risi18_bank_backward_bf16(const void* T, const void* A, const void* K,
                              const void* g, void* dT, void* partial, int N,
                              int P, int C, int Cout, int nblocks,
                              void* stream) {
  return launch<__nv_bfloat16>(T, A, K, g, dT, partial, N, P, C, Cout,
                               nblocks, stream);
}

// Kernel 2 on `stream`: partial [nblocks, 18C*Cout] -> dK [18C,Cout] f32
// (written, zero when nblocks is 0).
int risi18_bank_backward_reduce(const void* partial, void* dK, int nblocks,
                                int C, int Cout, void* stream) {
  if (C <= 0 || Cout <= 0 || nblocks < 0) return cudaErrorInvalidValue;
  const int nK = kCases * C * Cout;
  return risi18::launch_sum_partial_rows((const float*)partial, nblocks, nK,
                                         nK, (float*)dK, nullptr,
                                         (cudaStream_t)stream);
}

const char* risi18_bank_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
