// Fused second-order SMP level backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_v3t_bwd of
// graphflow_tpu/ops/risi_fused_pallas.py (run by risi18_level_v3t_bwd_raw
// and _v3t_bwd), together with the XLA one-hot scatter that follows it.
// It is the adjoint of risi18_level.cu: given the level's input state,
// structure (nbr, pos, radj), K, its output `out` and the cotangent g of
// out, it computes, for geff = g * (out > 0 ? 1 : negslope),
//   dstate [N,P,P,C]  the gradient of the state (zero for absent slots),
//   dK     [18C,Cout] summed over every vertex,
//   db     [Cout]     geff summed over rows.
// The sentinels are the forward's: an id outside [0, N) or a position
// outside [0, P) is absent.
//
// The algebra.  Every one of the 18 cases is linear in T given Ap, and each
// is a broadcast of one of the forward's shared reductions (see
// risi18_common.cuh).  Per vertex, with G = geff[v] as [P,P,Cout],
//   GAp[x,e,o] = sum_y G[x,y,o] Ap[y,e],  GR[x,o] = sum_y G[x,y,o] R[y],
//   GA[o] = sum_{x,y} Ap[x,y] G[x,y,o],
// both gradients become products of those with K or with the reductions:
// * dK needs T.  dK_k = sum_{x,y} Y_k[x,y,:]^T G[x,y,:]; in terms of the
//   reductions each case is one [P*P]- or [P]-long dot product against G,
//   GAp or GR, or a scalar times GA (cases 9, 12, 13, 16, 17 through GAp).
//   So the kernel re-gathers the slots from the saved input state (8 MB at
//   the production shape, L2-resident) with the forward's device code; the
//   TPU kernel's T2all residual (134 MB per level there) is not needed.
// * dstate needs no T.  The cotangent of each reduction is a product of G,
//   GAp (or its transpose), GR or GA with one of K's case slabs, and
//     dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
//               + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b],
//   which is scattered to state[nbr[a], pos[a,b], pos[a,c]] with float32
//   atomicAdd: a state slot receives from every receptive field that holds
//   it (up to P of them).
//
// Design.  Kernel 1 has one block of 512 threads per (vertex group, channel
// chunk, panel of output channels), one block an SM.  dK's rows and dstate's
// channels of different chunks are independent, and both gradients are
// linear in G, so blocks share nothing; only G, GAp, GR and GA are formed
// again per chunk.  At N=256, C=32 that is 132 groups x 4 chunks, each
// block walking about two vertices.  Per vertex a block
//   1. loads geff and forms GAp, GR, GA (and db's column sums);
//   2. streams the non-empty slots of its chunk from the saved state
//      through the cp.async ring and reduces them with all threads, as the
//      forward does (risi18_level_common.cuh);
//   3. adds dK's map cases as the product maps^T [10 nc x P*P] times
//      [G | GAp] and keeps the sums in registers across the vertices it
//      walks; the k-parts are summed once, when the block ends (in a fixed
//      order: dK stays deterministic), and the partial row is written once;
//   4. forms the reductions' cotangents as the product [G | GAp] times K's
//      ten slabs, over the maps;
//   5. scatters dT with all threads, four channels of one state element in
//      one float4 atomicAdd where C and the chunk are multiples of four.
// Both products run on the tensor cores where P*P is a multiple of 16 (up
// to 256), the chunk has 8 or 16 channels and the panel's width is a
// multiple of 8 (dk_maps_mma, cotangent_maps_mma): mma.sync.m16n8k8 with
// both operands split in two TF32 values, three passes a product, which is
// the float32 product to 2^-19 (see risi18_level_common.cuh); one TF32 pass
// is not taken.  Else on the CUDA cores: dK in register tiles of 4 channels
// x 8 outputs over a part of the rows, the cotangents in tiles of 4 rows x
// 10 slabs.
// Kernel 2 sums the groups' partial rows into dK and db.  All sums are in
// float32.  ops/risi_level.py:risi18_level_backward_factored_reference is
// this algebra in plain PyTorch.  Kernel 1's block is
// risi18::level::backward_block (risi18_backward_block.cuh); the bank's
// backward K5 (risi18_bank_bwd.cu) runs the same block on slots streamed
// from a materialised T, with dT written instead of scattered.  Where G and
// the maps of all P*P rows do not fit one block (from P = 33 at Cout = 32)
// kernel 1 takes a cluster plan (backward_block_cluster): a vertex's row
// tiles spread over a thread-block cluster of up to 8 blocks (fewer where
// the grid of vertex groups, chunks and panels already fills the card:
// risi18_level_common.cuh:cluster_shape, so the plan depends on N), each
// taking dK from its tiles' maps and G rows (the map cases on the tensor
// cores where the plan has mma) and dT, which needs G and not T, for the
// rows b of its tiles, one pass a row tile: the tile's maps on the tensor
// cores from rows of G, GAp and GR, then dT[:, Xb, :] added into dstate
// (risi18_backward_block.cuh:dT_maps; where C is a multiple of 4 and the
// warps' staging buffers fit over G, dT_stage_rows: the row (a, b) of dT
// is the neighbour's row dstate[n, p1, 0:P, chunk] read through pos[a, .],
// so it is staged in storage order, repeated positions added, and added
// by one tensor reduce a row, cp.reduce.async.bulk.tensor through dstate's
// tensor map, as the stream's tensor copies gather it; else dT_assemble's
// float32 atomic a cell and four channels); the blocks' dK and db
// are exchanged through distributed shared memory in rank order, and each
// cluster writes one partial row, so kernel 2 is unchanged
// (ops/risi_bank.py:risi18_bank_backward_cluster_reference).  Where that
// plan would be one block with dK on the CUDA cores, kernel 1 takes the
// row-tiled block of one block a vertex group (backward_block_tiled),
// which measured faster there (the beta pairs' P = 40), with the same dT
// pass.  Both row-tiled blocks read kernel 0 (backward_sums_kernel),
// launched before them: GAp [N,P,P,Cout] and the row sums of geff GR, GAx
// (GA's) and GSx (db's) [N,3,P,Cout] in float32 scratch, once a vertex
// where kernel 1 formed them once per chunk, tile and pair of tiles.  The
// bank's K5 runs the same blocks on T and writes dT.
//
// Element types.  State, K, g and out are float32 or bfloat16 (one type);
// radj is float32.  Behind a bfloat16 forward (as _v3t_bwd runs the TPU
// kernel), geff is formed in float32 from the bfloat16 g and out; the sign
// of the rounded out is the sign of the float32 pre-activation, zero
// counting as negative in both.  The scatter always adds float32 into a
// float32 buffer: a bfloat16 atomic would round up to P times per element.
// In bfloat16 kernel 2 is finish_bf16_kernel: it sums the partial rows into
// dK and db and rounds them, and rounds the float32 buffer into dstate, each
// value once, in one launch.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32)
// the dK and the cotangent products are 0.67 G multiply-adds each (10
// slabs), three tensor-core passes each, in float32 sums for both element
// types; the scatter is at most N*P^3*C/4 = 8.4 M float4 atomics to L2; the
// re-gather reads 134 MB from L2 (67 MB in bfloat16).  By a block's own
// clock (tools/stage_clock.py; two vertices of one 8-channel chunk) the
// stream takes 33 % (instructions and latency, as in the forward), dK 15 %,
// the cotangents 13 %, G against the adjacency 11 %, the scatter 7 %,
// loading geff 7 % and the vertex's structure 6 %: G, GAp and the structure
// are formed once per chunk, four times a vertex, because G and GAp leave no
// room for a 16-channel chunk (where they do, at Cout=16 in bfloat16, kernel
// 1 takes 0.33 ms against 0.39).  G and GAp shared by the chunks of a vertex
// (a cluster of blocks, or bfloat16 storage), a cheaper stream, and a
// scatter that merges the receptive fields of a state row before it reaches
// L2 are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_backward_block.cuh"

namespace {

using risi18::kCases;
using risi18::level::BackwardPlan;
using risi18::level::kThreads;
namespace lv = risi18::level;

// E is the type of state, K, g and out.  kMma: the plan's `mma`.
template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1)
risi18_level_bwd_kernel(const E* __restrict__ state,
                        const int* __restrict__ nbr,
                        const int* __restrict__ pos,
                        const float* __restrict__ radj,
                        const E* __restrict__ K,
                        const E* __restrict__ gout,
                        const E* __restrict__ out,
                        float* __restrict__ dstate,
                        float* __restrict__ partial,
                        int N, BackwardPlan L, float negslope) {
  lv::backward_block<E, kMma, true>(state, nbr, pos, radj, K, gout, out,
                                    dstate, partial, N, L, negslope);
}

// Kernel 1 on a row-tiled plan of one block a vertex group, where a
// cluster plan would be one block on the CUDA cores (choose_backward_plan).
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
risi18_level_bwd_tiled_kernel(const E* __restrict__ state,
                              const int* __restrict__ nbr,
                              const int* __restrict__ pos,
                              const float* __restrict__ radj,
                              const E* __restrict__ K,
                              const E* __restrict__ gout,
                              const E* __restrict__ out,
                              float* __restrict__ dstate,
                              float* __restrict__ partial,
                              int N, BackwardPlan L, float negslope) {
  lv::backward_block_tiled<E, true>(state, nbr, pos, radj, K, gout, out,
                                    dstate, partial, N, L, negslope);
}

// Kernel 1 on a cluster plan (fields from 33 rows at Cout = 32): a
// vertex's row tiles over a cluster of blocks (backward_block_cluster).
// kTma: the plan's stream takes the tensor copies (L.sp.tma), through the
// state's tensor map `map` (else not read).  Where the plan's scatter is
// kScatterTmaReduce, dT's staged rows are added into dstate through its
// tensor map `dmap` (else not read).
template <typename E, bool kMma, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
risi18_level_bwd_cluster_kernel(const E* __restrict__ state,
                                const int* __restrict__ nbr,
                                const int* __restrict__ pos,
                                const float* __restrict__ radj,
                                const E* __restrict__ K,
                                const E* __restrict__ gout,
                                const E* __restrict__ out,
                                const float* __restrict__ gap,
                                const float* __restrict__ sums,
                                float* __restrict__ dstate,
                                float* __restrict__ partial,
                                int N, BackwardPlan L, float negslope,
                                const __grid_constant__ CUtensorMap map,
                                const __grid_constant__ CUtensorMap dmap) {
  lv::backward_block_cluster<E, kMma, true, kTma>(
      state, nbr, pos, radj, K, gout, out, gap, sums, dstate, partial, N, L,
      negslope, &map, &dmap);
}

// Kernel 2 behind a bfloat16 forward.  The first sum_blocks blocks sum the
// nparts partial rows of width W = nK + Cout by column into dK [nK] and db,
// rounded once; the other blocks round the float32 buffer dstate32 [n] into
// dstate, four values a step where n allows (both come from the allocator,
// 16-byte aligned).
__global__ void __launch_bounds__(kThreads)
finish_bf16_kernel(const float* __restrict__ partial, int nparts, int W,
                   int nK, __nv_bfloat16* __restrict__ dK,
                   __nv_bfloat16* __restrict__ db,
                   const float* __restrict__ dstate32,
                   __nv_bfloat16* __restrict__ dstate, size_t n,
                   int sum_blocks) {
  if ((int)blockIdx.x < sum_blocks) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= W) return;
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * W + i];
    risi18::store_value(i < nK ? dK + i : db + (i - nK), s);
    return;
  }
  const size_t at = (size_t)(blockIdx.x - sum_blocks) * blockDim.x
                    + threadIdx.x;
  const size_t step = (size_t)(gridDim.x - sum_blocks) * blockDim.x;
  const size_t n4 = n / 4;
  const float4* src = reinterpret_cast<const float4*>(dstate32);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dstate);
  for (size_t i = at; i < n4; i += step) {
    const float4 x = src[i];
    dst[2 * i] = __floats2bfloat162_rn(x.x, x.y);
    dst[2 * i + 1] = __floats2bfloat162_rn(x.z, x.w);
  }
  for (size_t i = 4 * n4 + at; i < n; i += step)
    risi18::store_value(dstate + i, dstate32[i]);
}

constexpr int kMaxCastBlocks = 1056;   // eight blocks for each of 132 SMs

// Kernel 1 for element type E; returns a cudaError_t.
template <typename E>
int launch_backward(const void* state, const void* nbr, const void* pos,
                    const void* radj, const void* K, const void* g,
                    const void* out, const void* gap, const void* sums,
                    void* dstate, void* partial, int N, int P, int C,
                    int Cout, float negslope, int nblocks, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  // The stream indexes the state's [N,P,P] elements with an int.
  if ((long long)N * P * P >= (1LL << 31)) return cudaErrorInvalidValue;
  if (nblocks != lv::vertex_groups(N)) return cudaErrorInvalidValue;
  BackwardPlan L = lv::choose_backward_plan(
      P, C, Cout, (int)sizeof(E), lv::alignment_of(state), true, true, N);
  if (L.words == 0) return cudaErrorInvalidValue;
  // A cluster plan reads kernel 0's sums.
  if (L.cluster && (gap == nullptr || sums == nullptr))
    return cudaErrorInvalidValue;
  L.wide_g = lv::alignment_of(g) == 16 && lv::alignment_of(out) == 16;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  const dim3 grid(nblocks * (L.cluster ? L.cluster : 1),
                  (C + L.sp.Cc - 1) / L.sp.Cc, (Cout + L.Co - 1) / L.Co);
  if (L.cluster) {
    // A tensor map that does not encode is an error, never another route.
    CUtensorMap map = {}, dmap = {};
    if (L.sp.tma) {
      const int err = lv::encode_state_map(&map, state, N, L.sp,
                                           (int)sizeof(E));
      if (err != 0) return err;
    }
    // The staged scatter's tensor map: the float32 dstate in the state's
    // geometry (a box of {ncp, P} of [N*P*P, C]).  The wrapper allocates
    // dstate, 16-byte aligned; another buffer is refused, not scattered
    // another way.
    if (L.scatter == lv::kScatterTmaReduce) {
      if (lv::alignment_of(dstate) != 16) return cudaErrorInvalidValue;
      const int err = lv::encode_state_map(&dmap, dstate, N, L.sp,
                                           (int)sizeof(float));
      if (err != 0) return err;
    }
    return lv::launch_clusters(
        L.sp.tma ? (L.mma ? risi18_level_bwd_cluster_kernel<E, true, true>
                          : risi18_level_bwd_cluster_kernel<E, false, true>)
                 : (L.mma ? risi18_level_bwd_cluster_kernel<E, true, false>
                          : risi18_level_bwd_cluster_kernel<E, false, false>),
        grid, L.cluster, bytes, (cudaStream_t)stream, (const E*)state,
        (const int*)nbr, (const int*)pos, (const float*)radj, (const E*)K,
        (const E*)g, (const E*)out, (const float*)gap, (const float*)sums,
        (float*)dstate, (float*)partial, N, L, negslope, map, dmap);
  }
  auto kernel = L.tiled ? risi18_level_bwd_tiled_kernel<E>
                : L.mma ? risi18_level_bwd_kernel<E, true>
                        : risi18_level_bwd_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
          (const E*)state, (const int*)nbr, (const int*)pos,
          (const float*)radj, (const E*)K, (const E*)g, (const E*)out,
          (float*)dstate, (float*)partial, N, L, negslope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of partial rows (vertex groups of kernel 1) for N vertices.
int risi18_level_backward_blocks(int N) { return lv::vertex_groups(N); }

// Kernel 0 on `stream` (the cluster plans' sums of geff once a vertex,
// risi18_backward_block.cuh:backward_sums_kernel); returns a cudaError_t.
// radj [N,P,P] f32, g and out [N,P*P,Cout] (f32 or bf16) -> gap
// [N,P,P,Cout] f32 and sums [N,3,P,Cout] f32 (GR, GAx, GSx), all
// contiguous.
int risi18_level_backward_sums_f32(const void* radj, const void* g,
                                   const void* out, void* gap, void* sums,
                                   int N, int P, int Cout, float negslope,
                                   void* stream) {
  return lv::launch_backward_sums<float, true>(
      (const float*)radj, (const float*)g, (const float*)out, (float*)gap,
      (float*)sums, N, P, Cout, negslope, (cudaStream_t)stream);
}

int risi18_level_backward_sums_bf16(const void* radj, const void* g,
                                    const void* out, void* gap, void* sums,
                                    int N, int P, int Cout, float negslope,
                                    void* stream) {
  return lv::launch_backward_sums<__nv_bfloat16, true>(
      (const float*)radj, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)out, (float*)gap, (float*)sums, N, P, Cout,
      negslope, (cudaStream_t)stream);
}

// Kernel 1 on `stream`; returns a cudaError_t (0 on success), or the
// tensor map's error (risi18_level_bwd_error_string names both).
// state [N,P,P,C], nbr [N,P] i32, pos [N,P,P] i32, radj [N,P,P] f32,
// K [18C,Cout], g and out [N,P*P,Cout], and on a cluster plan kernel 0's
// gap and sums (else they may be null) -> adds into dstate [N,P,P,C] f32
// (zeroed by the caller) and writes partial [nblocks, 18C*Cout + Cout] f32,
// all contiguous; nblocks = risi18_level_backward_blocks(N).  State, K, g
// and out are float32 (_f32) or bfloat16 (_bf16); dstate is float32 in both
// (in bfloat16 it is the buffer that risi18_level_backward_finish_bf16
// rounds).
int risi18_level_backward_f32(const void* state, const void* nbr,
                              const void* pos, const void* radj,
                              const void* K, const void* g, const void* out,
                              const void* gap, const void* sums,
                              void* dstate, void* partial, int N, int P,
                              int C, int Cout, float negslope, int nblocks,
                              void* stream) {
  return launch_backward<float>(state, nbr, pos, radj, K, g, out, gap, sums,
                                dstate, partial, N, P, C, Cout, negslope,
                                nblocks, stream);
}

int risi18_level_backward_bf16(const void* state, const void* nbr,
                               const void* pos, const void* radj,
                               const void* K, const void* g, const void* out,
                               const void* gap, const void* sums,
                               void* dstate, void* partial, int N, int P,
                               int C, int Cout, float negslope, int nblocks,
                               void* stream) {
  return launch_backward<__nv_bfloat16>(state, nbr, pos, radj, K, g, out,
                                        gap, sums, dstate, partial, N, P, C,
                                        Cout, negslope, nblocks, stream);
}

// Kernel 2 on `stream`: partial [nblocks, 18C*Cout + Cout] -> dK [18C,Cout],
// db [Cout] (both written, zero when nblocks is 0).
int risi18_level_backward_reduce_f32(const void* partial, void* dK, void* db,
                                     int nblocks, int C, int Cout,
                                     void* stream) {
  if (C <= 0 || Cout <= 0 || nblocks < 0) return cudaErrorInvalidValue;
  const int nK = kCases * C * Cout;
  return risi18::launch_sum_partial_rows(
      (const float*)partial, nblocks, nK + Cout, nK, (float*)dK, (float*)db,
      (cudaStream_t)stream);
}

// Kernel 2 in bfloat16 on `stream`: the same sums rounded into dK and db
// (bfloat16), and dstate32 [n] f32 rounded into dstate [n] bfloat16.
int risi18_level_backward_finish_bf16(const void* partial, void* dK,
                                      void* db, const void* dstate32,
                                      void* dstate, long long n, int nblocks,
                                      int C, int Cout, void* stream) {
  if (C <= 0 || Cout <= 0 || nblocks < 0 || n < 0)
    return cudaErrorInvalidValue;
  const int nK = kCases * C * Cout, W = nK + Cout;
  const int sum_blocks = (W + kThreads - 1) / kThreads;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int cast_blocks =
      n == 0 ? 0 : (int)(want < 1 ? 1 : (want > kMaxCastBlocks
                                             ? kMaxCastBlocks : want));
  finish_bf16_kernel<<<sum_blocks + cast_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)partial, nblocks, W, nK, (__nv_bfloat16*)dK,
      (__nv_bfloat16*)db, (const float*)dstate32, (__nv_bfloat16*)dstate,
      (size_t)n, sum_blocks);
  return cudaGetLastError();
}

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs) in
// row tiles of one row.
long long risi18_level_backward_min_smem_bytes(int P, int Cout) {
  return lv::min_backward_smem_bytes(P, Cout, true);
}

// The plan kernel 1 takes for N vertices of float32 (bf16 = 0) or
// bfloat16 (bf16 = 1) inputs whose state starts at a multiple of
// `aligned` bytes (N sizes a cluster plan's clusters:
// cluster_shape): plan[0] the rows of a row tile (P: untiled;
// a plan with plan[5] = 1 and plan[0] = P is one tile, its stream in shared
// memory), plan[1] the panel's outputs, plan[2] the chunk's channels,
// plan[3] the ring's depth, plan[4] the shared memory in bytes, plan[5] 1
// for a row-tiled block, plan[6] the pieces a ring buffer holds, plan[7]
// the blocks of a cluster (0: one block a vertex group, chunk and panel),
// plan[8] the row tiles a block of the cluster takes, plan[9] 1 where dK's
// map cases run on the tensor cores, plan[10] kernel 0's float32 scratch
// words a vertex (0: a plan of no cluster, which launches no kernel 0),
// plan[11] its shared memory in bytes, plan[12] 1 where the stream
// takes one tensor copy a gathered row (else cp.async a cell) and plan[13]
// 1 where dT's rows are staged and added by tensor reduces (else 0, float32
// atomics).  Returns 0, or 1 where no plan fits.
int risi18_level_backward_plan(int N, int P, int C, int Cout, int bf16,
                               int aligned, int* plan) {
  const BackwardPlan L = lv::choose_backward_plan(P, C, Cout, bf16 ? 2 : 4,
                                                  aligned, true, true, N);
  lv::report_backward_plan(L, P, Cout, plan);
  return L.words == 0;
}

#ifdef RISI18_STAGE_CLOCK
// The stage clock's 24 sums of cycles, zeroed after the copy.
int risi18_level_backward_stage_cycles(long long* host) {
  return risi18::level::read_stage_cycles(host);
}
#endif

const char* risi18_level_bwd_error_string(int err) {
  return lv::error_string(err);
}

}  // extern "C"
