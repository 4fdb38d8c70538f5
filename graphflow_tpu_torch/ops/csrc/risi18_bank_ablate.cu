// Ablation variants of the bank kernel (risi18_bank.cu, K4), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of tools/ablate_bank.py (run by
// variant), which times stripped-down copies of the Pallas bank to attribute
// its cost to its stages.  Each variant here is K4's own block
// (risi18::level::forward_block of risi18_forward_block.cuh: the cp.async
// ring over T, the stream's reductions, the 9 map slabs on the tensor cores,
// the adjacency applied once in the epilogue) on K4's own plan, instantiated
// with one part left out, so the differences between the variants' times
// are what K4 itself spends.  T [N,P,P,P,C] and K [18C,Cout] are float32 or
// bfloat16, A [N,P,P] float32; Z [N,P*P,Cout] has T's type.  Per vertex v:
//   full      Z = RisiContraction_18(T[v], max(A[v], 0)) @ K: the same
//             instantiation as K4's kernel; the reference point.
//   dma       Z[r, o] = T[v] viewed as [P*P, P*C], its first Cout columns
//             (needs Cout <= P*C).  Every element of T goes through K4's
//             ring, chunk after chunk, with no arithmetic but one running
//             sum per thread, which lands in sink[v] so that the loads
//             cannot be dropped (stream_loads).  A is not read.
//   reduce    the stream and its reductions without M6 and M10, then two
//             products instead of nine map slabs and no U, s or W
//             (ForwardPart kTwoProducts):
//             Z = (T_ab + T_bc + W17) @ K[0:C] + (D_bc + D_ac) @ K[C:2C],
//             W17[x,y] = T[y,x,y] = D_ac[y,x], which the stream writes as
//             dacT.
//   nogroupd  full without the adjacency-weighted cases 6, 9, 10, 12, 13, 16,
//             17 (K's blocks 5, 8, 9, 11, 12, 15, 16): no M6 and M10 in the
//             stream, no W and no adjacency in the epilogue (kNoGroupD).
//   novpu     full with every pick of a diagonal replaced by the full sum
//             (kNoSelect; risi18_level_common.cuh:picks_as_sums); wrong as a
//             contraction by design.  On the TPU the picks are mask
//             multiplies on the vector unit; here they are two predicated
//             stores per staged cell, so the variant measures those (and
//             pays a pass that writes the sums in their place).
// The TPU kernel's selector constants do not carry over: each variant is the
// function tools/ablate_bank.py:variant returns for its mode.  Every variant
// takes every plan K4 takes where one block holds the field, a wide stream
// (fields of 33 to 35 rows at Cout = 32) included; beyond (from 36 rows),
// where K4 spreads a vertex's row tiles over a cluster of blocks, the
// variants keep the row-tiled block of one block a vertex, so there they
// attribute that block, not K4 (tools/ablate_bank.py says so).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_forward_block.cuh"

namespace {

using risi18::level::ForwardPlan;
using risi18::level::kThreads;
namespace lv = risi18::level;

enum Mode { kModeFull = 0, kModeDma = 1, kModeReduce = 2, kModeNoGroupD = 3,
            kModeNoVpu = 4, kModes = 5 };

__host__ __device__ constexpr int part_of(int mode) {
  return mode == kModeNoGroupD ? lv::kNoGroupD
         : mode == kModeNoVpu  ? lv::kNoSelect
         : mode == kModeReduce ? lv::kTwoProducts
                               : lv::kBank;
}

// kTiled: the plan is row-tiled (forward_block_tiled, dma_block_tiled).
template <typename E, int kMode, bool kMma, bool kWide, bool kTiled>
__global__ void __launch_bounds__(kThreads, 1)
risi18_bank_ablate_kernel(const E* __restrict__ T, const float* __restrict__ A,
                          const E* __restrict__ K, E* __restrict__ Z,
                          float* __restrict__ sink, int N, ForwardPlan L) {
  if constexpr (kMode == kModeDma && kTiled)
    lv::dma_block_tiled<E>(T, Z, sink, L);
  else if constexpr (kMode == kModeDma)
    lv::dma_block<E>(T, Z, sink, L);
  else if constexpr (kTiled)
    lv::forward_block_tiled<E, part_of(kMode)>(T, A, K, Z, L);
  else
    lv::forward_block<E, kMma, kWide, part_of(kMode)>(
        T, nullptr, nullptr, A, K, nullptr, Z, N, L, 0.f);
}

template <typename E, int kMode, bool kMma, bool kWide, bool kTiled>
int launch_kernel(const E* T, const float* A, const E* K, E* Z, float* sink,
                  int N, const ForwardPlan& L, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)L.words;
  auto kernel = risi18_bank_ablate_kernel<E, kMode, kMma, kWide, kTiled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, kMode == kModeDma ? 1 : (L.Cout + L.Co - 1) / L.Co);
  kernel<<<grid, kThreads, bytes, stream>>>(T, A, K, Z, sink, N, L);
  return cudaGetLastError();
}

// Variant kMode on K4's plan L, with K4's kernel choice: a row-tiled
// block, a wide stream, the tensor cores or the CUDA cores (dma: the
// tiled or the whole-slot ring).
template <typename E, int kMode>
int launch_mode(const E* T, const float* A, const E* K, E* Z, float* sink,
                int N, const ForwardPlan& L, cudaStream_t stream) {
  if (L.tiled)
    return launch_kernel<E, kMode, false, false, true>(T, A, K, Z, sink, N,
                                                       L, stream);
  if constexpr (kMode == kModeDma) {
    return launch_kernel<E, kMode, false, false, false>(T, A, K, Z, sink, N,
                                                        L, stream);
  } else {
    if (L.sp.wide)
      return launch_kernel<E, kMode, false, true, false>(T, A, K, Z, sink,
                                                         N, L, stream);
    return L.mma ? launch_kernel<E, kMode, true, false, false>(
                       T, A, K, Z, sink, N, L, stream)
                 : launch_kernel<E, kMode, false, false, false>(
                       T, A, K, Z, sink, N, L, stream);
  }
}

template <typename E>
int launch(const void* T, const void* A, const void* K, void* Z, void* sink,
           int N, int P, int C, int Cout, int mode, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (mode < 0 || mode >= kModes) return cudaErrorInvalidValue;
  if (mode == kModeDma && (Cout > P * C || sink == nullptr))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  // One plan whatever the mode: K4's where one block holds the field
  // (risi18_bank.cu); beyond, the row-tiled plan of one block a vertex
  // (no cluster), where K4 itself runs a cluster plan, so that `full` is
  // K4 only where one block holds the field.
  const ForwardPlan L = lv::choose_forward_plan(
      P, C, Cout, (int)sizeof(E), lv::alignment_of(T), false);
  if (L.words == 0) return cudaErrorInvalidValue;
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
// (_f32) or bf16 (_bf16).  sink [N] f32 receives, in mode dma, the sum of
// what each vertex's block loaded, and is not touched otherwise (it may then
// be null).
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

// The least shared memory one block needs: K4's (risi18_bank.cu), in row
// tiles of one row.
long long risi18_bank_ablate_min_smem_bytes(int P, int Cout) {
  return lv::min_forward_smem_bytes(P, Cout, false);
}

const char* risi18_bank_ablate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
