// Fused second-order SMP level forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of graphflow_tpu/ops/risi_fused_pallas.py:
//   _kernel_v3 (run by risi18_level_fused_v3_raw, P a multiple of the
//   sublane tile) and _kernel (run by risi18_level_fused_raw, any other P).
// Both compute one function, and so does this kernel, for every P.
//
// Per vertex v, with Ap = max(radj[v], 0) (the adj>0 guard of
// RisiContraction_18.h:90), R[d] = sum_e Ap[d,e], S = sum Ap, trA = tr Ap:
//   T[a,b,c,f] = state[nbr[v,a], pos[v,a,b], pos[v,a,c], f]   (aligned slots;
//                zero when the neighbour id is outside [0, N) or a position
//                is outside [0, P): the sentinels N and P read zeros)
//   Y          = RisiContraction_18(T, Ap)                    [P, P, 18C]
//   out[v]     = LeakyReLU(Y.reshape(P*P, 18C) @ K + b)        [P*P, Cout]
// with K's rows in the order case*C + f (cases as in risi_contraction_18).
//
// Design.  One block of 512 threads per vertex (and per panel of output
// channels, where a large P needs Z split), one block an SM: the maps of a
// 16-channel chunk take half of its shared memory, so a second block would
// not fit, and the asynchronous stream overlaps the copies with the
// reductions inside the block instead.  The block never stages T [P,P,P,C]
// (512 KB at P=16, C=32); it walks the channels in chunks of up to 16 and,
// per chunk,
//   1. streams the vertex's non-empty aligned slots from the state
//      (L2-resident: 8 MB at N=256) through a ring of cp.async buffers and
//      reduces each staged slot with all threads
//      (risi18_level_common.cuh): the maps T_ab, T_bc, D_bc, D_ac, M6, M10
//      as [row][channel], the row sums and the scalars;
//   2. multiplies the maps into K as the matrix product it is, maps
//      [P*P x 9*16] times K's slabs [9*16 x Cout], accumulated over the
//      chunks.  Where P*P is a multiple of 16 (up to 256), the
//      chunk has 16 channels and the panel's width is a multiple of 8, on
//      the tensor cores: a warp keeps 16 rows of Z and of W in registers
//      over the chunks and feeds
//      mma.sync.m16n8k8 with both operands split in two TF32 values, three
//      passes a product (mma_products), which is the float32 product to
//      2^-19.  One TF32 pass rounds each product to 2^-10 and is not
//      taken; a bfloat16 state gets the same float32 sums as a float32 one,
//      so no rounding is added in either type.  Else on the CUDA cores, in
//      register tiles of 8 rows x 4 output channels (float4 loads of four
//      channels of a row and of four outputs of a row of K), added to Z
//      and W in shared memory once per chunk.
// The 18 cases are factored so that the product has 9 map slabs, not 18:
//   Z[x,y,:] =  T_ab[x,y] (S K1 + trA K7) + T_bc[x,y] S K3
//             + M6[x,y] K6 + M10[x,y] K10                       (direct)
//             + sum_e Ap[y,e] W[x,e,:]                          (cases 9, 12,
//               W[x,e,:] = T_ab[x,e] K9 + T_ab[e,x] K12          13, 16, 17)
//                        + T_bc[x,e] K13 + D_bc[x,e] K16 + D_ac[e,x] K17
//             + R[y] U[x,:],  U[x,:] = T_a[x] K2 + T_b[x] K4     (cases 2, 4,
//                        + Tdbc[x] K8 + Tdac[x] K11               8, 11)
//             + Ap[x,y] s,  s = Tfull K5 + s14 K14 + s15 K15 + t18 K18.
// W, U and s are linear in the maps, so they accumulate over the chunks and
// the adjacency is applied once per vertex, in the epilogue, with the bias
// and LeakyReLU (ops/risi_bank.py:risi18_bank_factored_reference is this
// algebra in plain PyTorch, which ops/risi_level.py:
// risi18_level_factored_reference runs after the take-gather).  All sums
// are in float32.  The block is risi18::level::forward_block
// (risi18_forward_block.cuh); the bank kernel K4 (risi18_bank.cu) runs the
// same block on slots streamed from a materialised T.
//
// Fields beyond one block.  Where no plan keeps the maps and Z of all P*P
// rows (from P = 36 at Cout = 32; SMP_beta sets P = V), the launcher takes
// a cluster plan (forward_block_cluster): the vertex's rows x in tiles of
// sp.rows rows, spread over a thread-block cluster of up to 8 blocks (grid
// (N * cluster, panels)), each tile's maps streamed from the rows of the
// tile of every slot and the whole slots in the tile (about twice T's
// elements over all tiles), Z, W and U kept for the tile's rows only.
// The scalar cases are sums over the slots of per-slot sums that a tile's
// whole slots give, so each block sums its tiles' part of s and the
// cluster adds the parts through distributed shared memory, in rank
// order, before the epilogue adds Ap s: no pass over the slots for the
// scalars alone.  A tile's pre-activations wait for that in float32 in
// `pre` (out itself in float32).  The products run on the tensor cores
// where a tile's rows make at most one 16-row tile a warp (P = 64: tiles
// of 4 rows), else on the CUDA cores.  The block stages up to 16 rows
// (pieces of a few rows of one slot) at a time and meets at a barrier per
// stage, which with the copies' issue sets its pace (PERF.md).  A card
// that cannot place the cluster refuses the launch, and the wrapper
// raises.  ops/risi_bank.py:risi18_bank_cluster_reference is that
// decomposition in plain PyTorch.  (The bank's kernels K4 and K6 keep one
// block a vertex there: forward_block_tiled.)
//
// Element types.  State, K, b and out are float32 or bfloat16 (one type; the
// TPU kernels work in the state's dtype the same way); radj is float32.  The
// ring holds the state's elements as they are; a bfloat16 value becomes a
// float when it is reduced, every map and accumulator is float32 in both,
// and the output is rounded once, after the bias and LeakyReLU, as
// _kernel_v3 writes Z.astype(out_ref.dtype).
//
// What bounds it.  At the production level shape (N=256, P=16, C=32,
// Cout=32) the factored products are 0.6 G multiply-adds (half of the
// 18-slab product's 1.2), three tensor-core passes each, against 134 MB of
// gathered reads from L2 (67 MB in bfloat16) and 8 MB written.  By the
// block's own clock (tools/stage_clock.py) the stream takes half of a
// vertex: starting the copies and the reduction of a staged slot are bound by
// instructions and their latencies, not by bytes (a bfloat16 state, half
// the bytes, gains 4 %) nor by the block meeting at a barrier (a warp
// copies and reduces its own rows and meets no other).  The products take
// 18 %, K's staging 9 %, the epilogue 8 %.  Both element types run the same
// float32 sums.  Fewer instructions per staged element (T_ab and M6 as a
// tensor-core product of the slot with [1 | R] instead of shuffles), K
// staged once per SM instead of once per vertex, and one bfloat16 pass for
// a bfloat16 state, once its rounding is argued, are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_forward_block.cuh"

namespace {

using risi18::level::ForwardPlan;
using risi18::level::kThreads;
namespace lv = risi18::level;

// E is the type of state, K, bias and out: float or __nv_bfloat16.  kMma:
// the plan's `mma`.  kWide: the plan's stream is wide.
template <typename E, bool kMma, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
risi18_level_kernel(const E* __restrict__ state,
                    const int* __restrict__ nbr,
                    const int* __restrict__ pos,
                    const float* __restrict__ radj,
                    const E* __restrict__ K,
                    const E* __restrict__ bias,
                    E* __restrict__ out,
                    int N, ForwardPlan L, float negslope) {
  lv::forward_block<E, kMma, kWide, lv::kLevel>(state, nbr, pos, radj, K,
                                                bias, out, N, L, negslope);
}

// The level on a cluster plan (fields from 36 rows at Cout = 32): a
// vertex's row tiles over a cluster of blocks (forward_block_cluster).
template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1)
risi18_level_cluster_kernel(const E* __restrict__ state,
                            const int* __restrict__ nbr,
                            const int* __restrict__ pos,
                            const float* __restrict__ radj,
                            const E* __restrict__ K,
                            const E* __restrict__ bias,
                            E* __restrict__ out,
                            float* __restrict__ pre,
                            int N, ForwardPlan L, float negslope) {
  lv::forward_block_cluster<E, kMma>(state, nbr, pos, radj, K, bias, out,
                                     pre, N, L, negslope);
}

// Launches a cluster plan: grid (N * L.cluster, panels), clusters of
// L.cluster blocks along x.  A cluster the card cannot place is refused
// (cudaErrorLaunchOutOfResources), never run another way.
template <typename E>
int launch_cluster(const E* state, const int* nbr, const int* pos,
                   const float* radj, const E* K, const E* b, E* out,
                   float* pre, int N, int Cout, const ForwardPlan& L,
                   float negslope, cudaStream_t stream) {
  if (pre == nullptr) return cudaErrorInvalidValue;
  auto kernel = L.mma ? risi18_level_cluster_kernel<E, true>
                      : risi18_level_cluster_kernel<E, false>;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)N * L.cluster, (Cout + L.Co - 1) / L.Co);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, state, nbr, pos, radj, K, b,
                           out, pre, N, L, negslope);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the level for element type E; returns a cudaError_t.
template <typename E>
int launch_level(const void* state, const void* nbr, const void* pos,
                 const void* radj, const void* K, const void* b, void* out,
                 void* pre, int N, int P, int C, int Cout, float negslope,
                 void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  // The stream indexes the state's [N,P,P] elements with an int.
  if ((long long)N * P * P >= (1LL << 31)) return cudaErrorInvalidValue;
  const ForwardPlan L = lv::choose_forward_plan(
      P, C, Cout, (int)sizeof(E), lv::alignment_of(state), true, true);
  if (L.words == 0) return cudaErrorInvalidValue;
  if (L.cluster)
    return launch_cluster<E>((const E*)state, (const int*)nbr,
                             (const int*)pos, (const float*)radj,
                             (const E*)K, (const E*)b, (E*)out, (float*)pre,
                             N, Cout, L, negslope, (cudaStream_t)stream);
  const size_t bytes = sizeof(float) * (size_t)L.words;
  auto kernel = L.sp.wide ? risi18_level_kernel<E, false, true>
                : L.mma     ? risi18_level_kernel<E, true, false>
                            : risi18_level_kernel<E, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, (Cout + L.Co - 1) / L.Co);
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const E*)state, (const int*)nbr, (const int*)pos, (const float*)radj,
      (const E*)K, (const E*)b, (E*)out, N, L, negslope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the level on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C], nbr [N,P] i32, pos [N,P,P] i32, radj [N,P,P] f32,
// K [18C,Cout], b [Cout] -> out [N,P*P,Cout], all contiguous; state, K, b
// and out in float32 (_f32) or bfloat16 (_bf16).  pre: float32 [N,P*P,Cout]
// scratch for the pre-activations of a cluster plan (risi18_level_plan's
// plan[7] > 0; out itself may serve in float32), else not read (may be
// null).
int risi18_level_forward_f32(const void* state, const void* nbr,
                             const void* pos, const void* radj,
                             const void* K, const void* b, void* out,
                             void* pre, int N, int P, int C, int Cout,
                             float negslope, void* stream) {
  return launch_level<float>(state, nbr, pos, radj, K, b, out, pre, N, P, C,
                             Cout, negslope, stream);
}

int risi18_level_forward_bf16(const void* state, const void* nbr,
                              const void* pos, const void* radj,
                              const void* K, const void* b, void* out,
                              void* pre, int N, int P, int C, int Cout,
                              float negslope, void* stream) {
  return launch_level<__nv_bfloat16>(state, nbr, pos, radj, K, b, out, pre,
                                     N, P, C, Cout, negslope, stream);
}

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs) in
// row tiles of one row.
long long risi18_level_min_smem_bytes(int P, int Cout) {
  return lv::min_forward_smem_bytes(P, Cout, true);
}

// The plan the launcher takes for a state of 16-byte aligned float32 (bf16
// = 0) or bfloat16 (bf16 = 1) elements: plan[0] the rows of a row tile (P:
// untiled), plan[1] the panel's outputs, plan[2] the chunk's channels,
// plan[3] the ring's depth, plan[4] the shared memory in bytes, plan[5] 1
// for a row-tiled block, plan[6] the pieces a ring buffer holds, plan[7]
// the blocks of a cluster (0: one block a vertex and panel), plan[8] the
// row tiles a block of the cluster takes, plan[9] 1 where the map products
// run on the tensor cores.  Returns 0, or 1 where no plan fits.
int risi18_level_plan(int P, int C, int Cout, int bf16, int* plan) {
  const lv::ForwardPlan L = lv::choose_forward_plan(
      P, C, Cout, bf16 ? 2 : 4, 16, true, true);
  plan[0] = L.sp.rows; plan[1] = L.Co; plan[2] = L.sp.Cc; plan[3] = L.sp.D;
  plan[4] = (int)(sizeof(float) * L.words); plan[5] = L.tiled;
  plan[6] = L.words ? lv::pieces(L.sp) : 0;   // (none fits: no ring)
  plan[7] = L.cluster;
  plan[8] = L.tiles_per_block; plan[9] = L.mma;
  return L.words == 0;
}

#ifdef RISI18_STAGE_CLOCK
// The stage clock's 16 sums of cycles, zeroed after the copy.
int risi18_level_stage_cycles(long long* host) {
  return risi18::level::read_stage_cycles(host);
}
#endif

const char* risi18_level_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
