// The 18-case bank and its product with K over materialised slots, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of graphflow_tpu/ops/risi_pallas.py
// (run by risi18_matmul_pallas, the forward of risi18_bank_train).  Per
// vertex v, with Ap = max(A[v], 0) (the adj>0 guard, risi_pallas.py:200):
//   Z[v] = RisiContraction_18(T[v], Ap).reshape(P*P, 18C) @ K   [P*P, Cout]
// with K's rows in the order case*C + f.  T [N,P,P,P,C] and K are float32
// or bfloat16, A is float32; Z has T's type.  No bias and no LeakyReLU: the
// caller adds them, as the JAX package does around the Pallas call.
//
// Design.  This is the level forward risi18_level.cu (K1) without its
// gather: one block per vertex walks the channels in chunks of Cc, reads the
// vertex's slots straight from T in global memory (BankSlots), accumulates
// the shared reductions in shared memory, and multiplies the 18 cases into
// the chunk's rows of K (staged in shared memory as float32), keeping Z in
// shared memory across chunks.  All of that device code is K1's
// (risi18_common.cuh).  Every sum is in float32; a bfloat16 value is
// converted once, on load, and Z is rounded to T's type once, when written.
// (Loading bfloat16 channel pairs as __nv_bfloat162 halves the threads that
// stream the slots, and measured slower on an H100.)  The TPU kernel's
// selector constants, masks and K regrouping do not carry over.  T is
// already zero where a slot or position is absent, so nothing is guarded;
// an empty vertex gives Z = 0.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32) the
// products with K are ~2.4 GFLOP of float32 FMAs fed from shared memory, as
// in K1; T is 134 MB in float32 (67 MB in bfloat16), read once from device
// memory, which it does not fit in L2 as K1's gathered state does.  The slot
// stream (phase 1 of the reductions) keeps only P*Cc threads of a block busy,
// each waiting on device memory: that latency and the arithmetic bound it.
// Cc is chosen so that two blocks fit on one SM.  Staging T's chunk in
// shared memory (TMA), more busy threads and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_common.cuh"

namespace {

using risi18::ForwardLayout;
using risi18::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
risi18_bank_kernel(const E* __restrict__ T, const float* __restrict__ A,
                   const E* __restrict__ K, E* __restrict__ Z,
                   ForwardLayout L) {
  extern __shared__ float smem[];
  const int P = L.P, C = L.C, Cout = L.Cout, Cc = L.Cc;
  const int LD = L.LD, ALD = L.ALD, ZLD = L.ZLD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  const risi18::ChunkMaps m = risi18::chunk_maps(smem, L.maps, P, Cc, LD);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;

  for (int i = tid; i < Cout * ZLD; i += nth) Zs[i] = 0.f;
  risi18::load_adjacency(A, v, P, ALD, Ap, R, smem + L.scal);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  const risi18::BankSlots<E> slots{T + v * PP * P * C, P, C};

  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int nc = min(Cc, C - c0);
    risi18::stage_K(K, Ks, C, c0, nc, Cc, Cout, Cout);
    risi18::chunk_reductions(slots, R, P, c0, nc, LD, m);
    risi18::accumulate_products(m, Ap, ALD, R, S, trA, Ks, Zs, ZLD, P, Cc,
                                nc, Cout, LD);
  }

  E* zv = Z + v * PP * Cout;
  for (int i = tid; i < PP * Cout; i += nth)
    risi18::store_value(zv + i, Zs[(i % Cout) * ZLD + i / Cout]);
}

template <typename E>
int launch(const void* T, const void* A, const void* K, void* Z, int N,
           int P, int C, int Cout, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  auto make = [&](int Cc) {
    return risi18::make_forward_layout(P, C, Cout, Cc, false);
  };
  const int Cc = risi18::choose_chunk(C, make);
  if (Cc == 0) return cudaErrorInvalidValue;
  const ForwardLayout L = make(Cc);
  const size_t bytes = risi18::smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      risi18_bank_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  risi18_bank_kernel<E><<<N, kThreads, bytes, (cudaStream_t)stream>>>(
      (const E*)T, (const float*)A, (const E*)K, (E*)Z, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the bank on `stream`; returns a cudaError_t (0 on success).
// T [N,P,P,P,C], A [N,P,P] f32, K [18C,Cout] -> Z [N,P*P,Cout], all
// contiguous; T, K and Z are f32 (_f32) or bf16 (_bf16).
int risi18_bank_forward_f32(const void* T, const void* A, const void* K,
                            void* Z, int N, int P, int C, int Cout,
                            void* stream) {
  return launch<float>(T, A, K, Z, N, P, C, Cout, stream);
}

int risi18_bank_forward_bf16(const void* T, const void* A, const void* K,
                             void* Z, int N, int P, int C, int Cout,
                             void* stream) {
  return launch<__nv_bfloat16>(T, A, K, Z, N, P, C, Cout, stream);
}

const char* risi18_bank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
