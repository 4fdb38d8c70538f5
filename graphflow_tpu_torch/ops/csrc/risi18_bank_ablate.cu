// Ablation variants of the bank kernel (risi18_bank.cu, K4), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of tools/ablate_bank.py (run by
// variant), which times stripped-down copies of the Pallas bank to attribute
// its cost to its stages.  Each variant here is K4's own block
// (risi18::bank_block of risi18_common.cuh: the BankSlots loader,
// chunk_reductions, accumulate_products) at K4's own block shape and channel
// chunk, instantiated with one stage left out, so the differences between
// the variants' times are what K4 itself spends.  T [N,P,P,P,C] and K [18C,Cout] are float32 or bfloat16,
// A [N,P,P] float32; Z [N,P*P,Cout] has T's type.  Per vertex v:
//   full      Z = RisiContraction_18(T[v], max(A[v], 0)) @ K: the same
//             instantiation as K4's kernel; the reference point.
//   dma       Z[r, o] = T[v] viewed as [P*P, P*C], its first Cout columns
//             (needs Cout <= P*C).  Every element of T goes through the slot
//             loader in the order of the reductions' stream, with no
//             arithmetic but one running sum per thread, which lands in
//             sink[v] so that the loads cannot be dropped.  A is not read.
//   reduce    the stream and the shared reductions (without M6 and M10,
//             which belong to group D), then two products instead of
//             eighteen (risi18::kTwoProducts):
//             Z = (T_ab + T_bc + W17) @ K[0:C] + (D_bc + D_ac) @ K[C:2C],
//             W17[x,y] = T[y,x,y] = D_ac[y,x].
//   nogroupd  full without the adjacency-weighted cases 6, 9, 10, 12, 13, 16,
//             17 (risi18::kNoGroupD).
//   novpu     full with every diagonal extraction replaced by the full sum
//             (risi18::kNoSelect); wrong as a contraction by design.  On the
//             TPU the extractions are mask multiplies on the vector unit; here
//             they are two predicated moves per loaded element and a few
//             indexed reads, so the variant measures those.
// The TPU kernel's selector constants do not carry over: each variant is the
// function tools/ablate_bank.py:variant returns for its mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_common.cuh"

namespace {

using risi18::ForwardLayout;
using risi18::kThreads;

enum Mode { kModeFull = 0, kModeDma = 1, kModeReduce = 2, kModeNoGroupD = 3,
            kModeNoVpu = 4, kModes = 5 };

__host__ __device__ constexpr risi18::BankPart part_of(int mode) {
  return mode == kModeNoGroupD ? risi18::kNoGroupD
         : mode == kModeNoVpu  ? risi18::kNoSelect
         : mode == kModeReduce ? risi18::kTwoProducts
                               : risi18::kFull;
}

// Mode dma for one vertex: the slot stream of chunk_reductions (item (b, f):
// row b of every slot a, channel c0 + f, chunk after chunk) with the loads
// alone, summed into sink[v]; then the copy.
template <typename E>
__device__ inline void dma_block(const E* __restrict__ T, E* __restrict__ Z,
                                 float* __restrict__ sink,
                                 const ForwardLayout& L) {
  extern __shared__ float smem[];
  const int P = L.P, C = L.C, Cout = L.Cout, Cc = L.Cc, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;
  const E* Tv = T + v * PP * P * C;
  const risi18::BankSlots<E> slots{Tv, P, C};

  float* total = smem + L.scal;
  if (tid == 0) *total = 0.f;
  __syncthreads();
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int nc = min(Cc, C - c0);
    for (int item = tid; item < P * nc; item += nth) {
      const int f = item % nc, b = item / nc;
      for (int a = 0; a < P; ++a) {
        typename risi18::BankSlots<E>::Row row;
        if (slots.row(a, b, c0 + f, row))
          for (int c = 0; c < P; ++c) acc += slots.load(row, a, c);
      }
    }
  }
  atomicAdd(total, acc);
  __syncthreads();
  if (tid == 0) sink[v] = *total;

  E* zv = Z + v * PP * Cout;
  const int PC = P * C;
  for (int i = tid; i < PP * Cout; i += nth)
    zv[i] = Tv[(size_t)(i / Cout) * PC + i % Cout];
}

template <typename E, int kMode>
__global__ void __launch_bounds__(kThreads)
risi18_bank_ablate_kernel(const E* __restrict__ T, const float* __restrict__ A,
                          const E* __restrict__ K, E* __restrict__ Z,
                          float* __restrict__ sink, ForwardLayout L) {
  if constexpr (kMode == kModeDma)
    dma_block<E>(T, Z, sink, L);
  else
    risi18::bank_block<E, part_of(kMode)>(T, A, K, Z, L);
}

template <typename E, int kMode>
int launch_mode(const E* T, const float* A, const E* K, E* Z, float* sink,
                int N, const ForwardLayout& L, cudaStream_t stream) {
  const size_t bytes = risi18::smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      risi18_bank_ablate_kernel<E, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  risi18_bank_ablate_kernel<E, kMode><<<N, kThreads, bytes, stream>>>(
      T, A, K, Z, sink, L);
  return cudaGetLastError();
}

template <typename E>
int launch(const void* T, const void* A, const void* K, void* Z, void* sink,
           int N, int P, int C, int Cout, int mode, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (mode < 0 || mode >= kModes) return cudaErrorInvalidValue;
  if (mode == kModeDma && (Cout > P * C || sink == nullptr))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  // K4's layout and chunk (risi18_bank.cu), whatever the mode.
  auto make = [&](int Cc) {
    return risi18::make_forward_layout(P, C, Cout, Cc, false);
  };
  const int Cc = risi18::choose_chunk(C, make);
  if (Cc == 0) return cudaErrorInvalidValue;
  const ForwardLayout L = make(Cc);
  const E* t = (const E*)T;
  const float* a = (const float*)A;
  const E* k = (const E*)K;
  E* z = (E*)Z;
  float* s = (float*)sink;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kModeFull: return launch_mode<E, kModeFull>(t, a, k, z, s, N, L, st);
    case kModeDma: return launch_mode<E, kModeDma>(t, a, k, z, s, N, L, st);
    case kModeReduce:
      return launch_mode<E, kModeReduce>(t, a, k, z, s, N, L, st);
    case kModeNoGroupD:
      return launch_mode<E, kModeNoGroupD>(t, a, k, z, s, N, L, st);
    default: return launch_mode<E, kModeNoVpu>(t, a, k, z, s, N, L, st);
  }
}

}  // namespace

extern "C" {

// Launches variant `mode` (0 full, 1 dma, 2 reduce, 3 nogroupd, 4 novpu) on
// `stream`; returns a cudaError_t (0 on success).  T [N,P,P,P,C], A [N,P,P]
// f32, K [18C,Cout] -> Z [N,P*P,Cout], all contiguous; T, K and Z are f32
// (_f32) or bf16 (_bf16).  sink [N] f32 receives each vertex's sum of T in
// mode dma and is not touched otherwise (it may then be null).
int risi18_bank_ablate_f32(const void* T, const void* A, const void* K,
                           void* Z, void* sink, int N, int P, int C, int Cout,
                           int mode, void* stream) {
  return launch<float>(T, A, K, Z, sink, N, P, C, Cout, mode, stream);
}

int risi18_bank_ablate_bf16(const void* T, const void* A, const void* K,
                            void* Z, void* sink, int N, int P, int C,
                            int Cout, int mode, void* stream) {
  return launch<__nv_bfloat16>(T, A, K, Z, sink, N, P, C, Cout, mode, stream);
}

// The least shared memory one block needs at a channel chunk of one.
long long risi18_bank_ablate_min_smem_bytes(int P, int Cout) {
  return risi18::min_forward_smem_bytes(P, Cout, false);
}

const char* risi18_bank_ablate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
