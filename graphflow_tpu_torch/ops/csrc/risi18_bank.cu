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
// Design.  This is the level forward's block (risi18_level.cu, K1; device
// code in risi18_forward_block.cuh) with its slots streamed from T instead
// of gathered from the state, and without the bias and the LeakyReLU: one
// block of 512 threads per vertex (and output panel), one block an SM, that
// walks the channels in chunks of up to 16 and per chunk
//   1. streams the vertex's P slots, T[v,a,:,:,c0:c0+nc] (runs of nc
//      elements at stride C), through a ring of cp.async buffers that each
//      warp fills and reduces for its own rows, into the maps T_ab, T_bc,
//      D_bc, D_ac, M6, M10, their row sums and the scalars
//      (risi18_level_common.cuh, StoredSlots);
//   2. multiplies the 9 map slabs into K on the tensor cores (three TF32
//      passes of mma.sync.m16n8k8, the float32 product to 2^-19) where P*P
//      is a multiple of 16, else in register tiles on the CUDA cores; W, U
//      and s accumulate over the chunks, and the adjacency is applied once
//      per vertex, in the epilogue.
// A field whose maps do not fit one block takes K1's row-tiled block
// (forward_block_tiled, risi18_level.cu), streaming T's rows a piece at a
// time.  Z is rounded to T's type once.  T is already zero where a slot or
// a position is absent, so nothing is listed or zero-filled: every slot is
// streamed, and an empty vertex gives Z = 0.  The ablation variants
// (risi18_bank_ablate.cu) instantiate the same block with a part left out.
// ops/risi_bank.py:risi18_bank_factored_reference is this algebra in plain
// PyTorch.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32) the
// factored products are 0.6 G multiply-adds, three tensor-core passes each;
// T is 134 MB in float32 (67 MB in bfloat16), read once from device memory,
// which it does not fit in L2 as K1's gathered state does: the ring is fed
// from HBM.  Its byte floor (0.040 ms in float32, 0.020 in bfloat16) lies
// below the time K1's stream takes in instructions, and on an H100 the
// block's own clock (tools/stage_clock.py) shows the stream from T taking
// no more cycles than K1's gather from L2 (63 k against 69 k of a vertex's
// ~130 k in float32; 59 k in bfloat16): its instructions set the pace, as
// in K1, and K4 takes 0.14 ms in either type.  A deeper ring (4) and a
// narrower chunk (8 channels) were measured and not taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_forward_block.cuh"

namespace {

using risi18::level::ForwardPlan;
using risi18::level::kThreads;
namespace lv = risi18::level;

// E is the type of T, K and Z.  kMma: the plan's `mma`; kWide: its stream
// is wide (fields of more than 32 rows).
template <typename E, bool kMma, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
risi18_bank_kernel(const E* __restrict__ T, const float* __restrict__ A,
                   const E* __restrict__ K, E* __restrict__ Z, int N,
                   ForwardPlan L) {
  lv::forward_block<E, kMma, kWide, lv::kBank>(T, nullptr, nullptr, A, K,
                                               nullptr, Z, N, L, 0.f);
}

// The bank on a row-tiled plan (fields from 36 rows at Cout = 32).
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
risi18_bank_tiled_kernel(const E* __restrict__ T, const float* __restrict__ A,
                         const E* __restrict__ K, E* __restrict__ Z, int N,
                         ForwardPlan L) {
  lv::forward_block_tiled<E, lv::kBank>(T, A, K, Z, L);
}

template <typename E>
int launch(const void* T, const void* A, const void* K, void* Z, int N,
           int P, int C, int Cout, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const ForwardPlan L = lv::choose_forward_plan(
      P, C, Cout, (int)sizeof(E), lv::alignment_of(T), false);
  if (L.words == 0) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  auto kernel = L.tiled   ? risi18_bank_tiled_kernel<E>
                : L.sp.wide ? risi18_bank_kernel<E, false, true>
                : L.mma     ? risi18_bank_kernel<E, true, false>
                            : risi18_bank_kernel<E, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, (Cout + L.Co - 1) / L.Co);
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const E*)T, (const float*)A, (const E*)K, (E*)Z, N, L);
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

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs) in
// row tiles of one row.
long long risi18_bank_min_smem_bytes(int P, int Cout) {
  return lv::min_forward_smem_bytes(P, Cout, false);
}

// The plan the launcher takes (as risi18_level_plan of risi18_level.cu).
int risi18_bank_plan(int P, int C, int Cout, int bf16, int* plan) {
  const lv::ForwardPlan L = lv::choose_forward_plan(
      P, C, Cout, bf16 ? 2 : 4, 16, false);
  plan[0] = L.sp.rows; plan[1] = L.Co; plan[2] = L.sp.Cc; plan[3] = L.sp.D;
  plan[4] = (int)(sizeof(float) * L.words); plan[5] = L.tiled;
  plan[6] = L.words ? lv::pieces(L.sp) : 0;   // (none fits: no ring)
  return L.words == 0;
}

#ifdef RISI18_STAGE_CLOCK
// The stage clock's 16 sums of cycles, zeroed after the copy.
int risi18_bank_stage_cycles(long long* host) {
  return risi18::level::read_stage_cycles(host);
}
#endif

const char* risi18_bank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
