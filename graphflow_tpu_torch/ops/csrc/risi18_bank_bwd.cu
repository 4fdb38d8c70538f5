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
// The algebra is the level backward's (risi18_level_bwd.cu, K2) on the
// cotangent g itself: the bank has no bias and no LeakyReLU, so there is no
// geff and no db.  Per vertex, with G = g[v] as [P,P,Cout], GAp = G Ap,
// GR = G R and GA = sum Ap * G, dK's cases are ten map slabs against G or
// GAp, four vectors against GR and four scalars times GA; the reductions'
// cotangents are G and GAp times K's ten slabs, GR and GA times its vector
// and scalar slabs; and
//   dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
//             + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].
// (ops/risi_bank.py:risi18_bank_backward_factored_reference is this algebra
// in plain PyTorch.)
//
// Design.  Kernel 1 is K2's kernel 1 (device code in
// risi18_backward_block.cuh) with its slots streamed from T through the
// cp.async ring (StoredSlots) instead of gathered: one block of 512 threads
// per (channel chunk, vertex group), one block an SM, 132 groups, the
// chunks of a group started side by side; per vertex
// the block loads G, forms GAp, GR and GA, streams its chunk of T[v] into
// the maps, adds dK's ten map slabs against [G | GAp] into registers kept
// across the group's vertices (dk_maps_mma), forms the maps' cotangents from
// K's ten slabs (cotangent_maps_mma), both on the tensor cores in three
// TF32 passes where P*P is a multiple of 16, else on the CUDA cores.  The
// difference is dT: each vertex owns dT[v], so the block writes its chunk
// of it once per element, four channels a store, with no atomics.  A block
// holds every output channel (one panel), since a chunk's dT needs all of
// their cotangents.  The partial rows of dK are summed in a fixed order, and
// every dT element has one writer: dT and dK are the same from run to run.
// A field whose G and maps do not fit one block (from P = 33 at Cout = 32)
// takes K2's cluster plan (backward_block_cluster): a vertex's row tiles
// over a thread-block cluster, sized for N by the rule K1, K2, K4 and K5
// share (cluster_shape), dK's map cases on the tensor cores where the plan
// has mma, and dT[a, b, :] for every a written by the block that owns row
// b's tile, each element once, in a fixed order, without atomics, one pass
// a row tile (the tile's maps on the tensor cores: dT_maps, dT_assemble);
// each cluster writes one partial row of dK (its blocks' parts added in
// rank order through distributed shared memory), so kernel 2 is unchanged.
// Where that plan would be one block with dK on the CUDA cores (a grid that
// fills the card, chunks of 4 channels), a cluster plan in smaller tiles
// with dK on the tensor cores is taken where one fits (P = 40, C = 32,
// Cout = 16: tiles of 8 rows in chunks of 8; risi18_backward_block.cuh:
// choose_backward_plan).  It reads kernel 0 (backward_sums_kernel: GAp and
// the row sums of g once a vertex, float32 scratch), launched before it.
// Kernel 2 (sum_partial_rows) sums the groups' partial rows into dK.  All
// sums are in float32; bfloat16 is converted once on load and rounded once
// on store.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32) the
// dK and the cotangent products are 0.67 G multiply-adds each (10 slabs),
// three tensor-core passes each; T is read once and dT written once (134 MB
// each in float32, 67 MB in bfloat16), neither of which fits in L2: 0.080
// ms of bytes in float32, 0.040 in bfloat16, below what K2's kernel 1
// spends in instructions (about 0.40 ms on an H100), so those set the pace
// once dT's stores stream past L2 (store4) and a group's chunk-blocks read
// T's rows side by side; before either, dT's write took a third of a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_backward_block.cuh"

namespace {

using risi18::kCases;
using risi18::level::BackwardPlan;
using risi18::level::kThreads;
namespace lv = risi18::level;

// E is the type of T, K, g and dT.  kMma: the plan's `mma`.
template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1)
risi18_bank_bwd_kernel(const E* __restrict__ T, const float* __restrict__ A,
                       const E* __restrict__ K, const E* __restrict__ gout,
                       E* __restrict__ dT, float* __restrict__ partial,
                       int N, BackwardPlan L) {
  lv::backward_block<E, kMma, false>(T, nullptr, nullptr, A, K, gout,
                                     nullptr, dT, partial, N, L, 0.f);
}

// Kernel 1 on a cluster plan (fields from 33 rows at Cout = 32): a
// vertex's row tiles over a cluster of blocks (backward_block_cluster).
template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1)
risi18_bank_bwd_cluster_kernel(const E* __restrict__ T,
                               const float* __restrict__ A,
                               const E* __restrict__ K,
                               const E* __restrict__ gout,
                               const float* __restrict__ gap,
                               const float* __restrict__ sums,
                               E* __restrict__ dT,
                               float* __restrict__ partial, int N,
                               BackwardPlan L) {
  lv::backward_block_cluster<E, kMma, false>(T, nullptr, nullptr, A, K,
                                             gout, nullptr, gap, sums, dT,
                                             partial, N, L, 0.f);
}

template <typename E>
int launch(const void* T, const void* A, const void* K, const void* g,
           const void* gap, const void* sums, void* dT, void* partial,
           int N, int P, int C, int Cout, int nblocks, void* stream) {
  if (P <= 0 || C <= 0 || Cout <= 0 || N < 0) return cudaErrorInvalidValue;
  if (nblocks != lv::vertex_groups(N)) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  BackwardPlan L = lv::choose_backward_plan(
      P, C, Cout, (int)sizeof(E), lv::alignment_of(T), false, N);
  if (L.words == 0) return cudaErrorInvalidValue;
  // A cluster plan reads kernel 0's sums.
  if (L.cluster && (gap == nullptr || sums == nullptr))
    return cudaErrorInvalidValue;
  L.wide_g = lv::alignment_of(g) == 16 && lv::alignment_of(dT) == 16;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  if (L.cluster)
    // Grid (vertex groups * L.cluster, chunks), clusters along x: each
    // cluster walks the vertices of its group and writes its partial row.
    return lv::launch_clusters(
        L.mma ? risi18_bank_bwd_cluster_kernel<E, true>
              : risi18_bank_bwd_cluster_kernel<E, false>,
        dim3(nblocks * L.cluster, (C + L.sp.Cc - 1) / L.sp.Cc, 1),
        L.cluster, bytes, (cudaStream_t)stream, (const E*)T,
        (const float*)A, (const E*)K, (const E*)g, (const float*)gap,
        (const float*)sums, (E*)dT, (float*)partial, N, L);
  // Chunks along x: the blocks of one vertex group start side by side
  // (backward_block).
  const dim3 grid((C + L.sp.Cc - 1) / L.sp.Cc, nblocks, 1);
  auto kernel = L.mma ? risi18_bank_bwd_kernel<E, true>
                        : risi18_bank_bwd_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const E*)T, (const float*)A, (const E*)K, (const E*)g, (E*)dT,
      (float*)partial, N, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of partial rows (vertex groups of kernel 1) for N vertices.
int risi18_bank_backward_blocks(int N) { return lv::vertex_groups(N); }

// Kernel 0 on `stream` (the cluster plans' sums of g once a vertex,
// risi18_backward_block.cuh:backward_sums_kernel); returns a cudaError_t.
// A [N,P,P] f32, g [N,P*P,Cout] (f32 or bf16) -> gap [N,P,P,Cout] f32 and
// sums [N,3,P,Cout] f32 (GR, GAx, GSx), all contiguous.
int risi18_bank_backward_sums_f32(const void* A, const void* g, void* gap,
                                  void* sums, int N, int P, int Cout,
                                  void* stream) {
  return lv::launch_backward_sums<float, false>(
      (const float*)A, (const float*)g, nullptr, (float*)gap, (float*)sums,
      N, P, Cout, 0.f, (cudaStream_t)stream);
}

int risi18_bank_backward_sums_bf16(const void* A, const void* g, void* gap,
                                   void* sums, int N, int P, int Cout,
                                   void* stream) {
  return lv::launch_backward_sums<__nv_bfloat16, false>(
      (const float*)A, (const __nv_bfloat16*)g, nullptr, (float*)gap,
      (float*)sums, N, P, Cout, 0.f, (cudaStream_t)stream);
}

// Kernel 1 on `stream`; returns a cudaError_t (0 on success).
// T [N,P,P,P,C], A [N,P,P] f32, K [18C,Cout], g [N,P*P,Cout], and on a
// cluster plan kernel 0's gap and sums (else they may be null) -> dT
// [N,P,P,P,C] (every element written) and partial [nblocks, 18C*Cout] f32,
// all contiguous; T, K, g and dT are f32 (_f32) or bf16 (_bf16);
// nblocks = risi18_bank_backward_blocks(N).
int risi18_bank_backward_f32(const void* T, const void* A, const void* K,
                             const void* g, const void* gap,
                             const void* sums, void* dT, void* partial,
                             int N, int P, int C, int Cout, int nblocks,
                             void* stream) {
  return launch<float>(T, A, K, g, gap, sums, dT, partial, N, P, C, Cout,
                       nblocks, stream);
}

int risi18_bank_backward_bf16(const void* T, const void* A, const void* K,
                              const void* g, const void* gap,
                              const void* sums, void* dT, void* partial,
                              int N, int P, int C, int Cout, int nblocks,
                              void* stream) {
  return launch<__nv_bfloat16>(T, A, K, g, gap, sums, dT, partial, N, P, C,
                               Cout, nblocks, stream);
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

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, all of Cout in one panel) in row
// tiles of one row.
long long risi18_bank_backward_min_smem_bytes(int P, int Cout) {
  return lv::min_backward_smem_bytes(P, Cout, false);
}

// The plan kernel 1 takes for N vertices of a T whose base address is a
// multiple of `aligned` bytes (as risi18_level_backward_plan of
// risi18_level_bwd.cu, its fourteen fields; the stream of stored slots is
// always cp.async's, and dT is written, not scattered: plan[13] is
// kScatterStore).
int risi18_bank_backward_plan(int N, int P, int C, int Cout, int bf16,
                              int aligned, int* plan) {
  const BackwardPlan L = lv::choose_backward_plan(P, C, Cout, bf16 ? 2 : 4,
                                                  aligned, false, N);
  lv::report_backward_plan(L, P, Cout, plan);
  return L.words == 0;
}

#ifdef RISI18_STAGE_CLOCK
// The stage clock's 16 sums of cycles, zeroed after the copy.
int risi18_bank_backward_stage_cycles(long long* host) {
  return risi18::level::read_stage_cycles(host);
}
#endif

const char* risi18_bank_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
