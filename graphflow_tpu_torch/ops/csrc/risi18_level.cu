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
// Design.  One block per vertex.  The block never stages T [P,P,P,C]
// (512 KB at P=16, C=32); it walks the channels in chunks of Cc and, per
// chunk, streams the P aligned slots straight from the state in global
// memory (the state of a whole level, 8 MB at N=256, sits in the 50 MB L2).
// While streaming it accumulates in shared memory the shared reductions of
// graphflow_tpu/ops/fused.py:54-67 and :87-93: T_ab, T_bc, D_bc (= W16),
// D_ac (W17 transposed), M6 and M10, plus the row and scalar sums (device
// code in risi18_common.cuh, shared with the backward risi18_level_bwd.cu
// and the bank kernels risi18_bank.cu and risi18_bank_bwd.cu).
// The thread that owns (row b, channel f) owns every accumulator entry it
// updates, so the slot loop needs no barrier.  Then each thread assembles
// the 18 case values of its output rows (x, y) for the chunk's channels,
// forming the adjacency-weighted cases M9/M12/M13/M16/M17 on the fly, and
// multiplies them into the chunk's rows of K (staged in shared memory),
// accumulating Z in shared memory across chunks.  Bias and LeakyReLU are
// applied in the final coalesced write.  All sums are in float32.
//
// What bounds it.  At the production level shape (N=256, P=16, C=32,
// Cout=32) the assembly is ~2.4 GFLOP of float32 FMAs on the CUDA cores
// (the bank's 18*C*Cout product per output row), against ~134 MB of
// gathered reads served mostly by L2 and 8 MB written.  So the kernel is
// bound by arithmetic and by the shared-memory loads feeding it; the
// chunk size Cc is chosen so that two blocks fit on one SM.  Tensor cores
// (wgmma), TMA and pipelined loads are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_common.cuh"

namespace {

using risi18::ForwardLayout;
using risi18::kThreads;

__global__ void __launch_bounds__(kThreads)
risi18_level_kernel(const float* __restrict__ state,
                    const int* __restrict__ nbr,
                    const int* __restrict__ pos,
                    const float* __restrict__ radj,
                    const float* __restrict__ K,
                    const float* __restrict__ bias,
                    float* __restrict__ out,
                    int N, ForwardLayout L, float negslope) {
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
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);

  for (int i = tid; i < Cout * ZLD; i += nth) Zs[i] = 0.f;
  risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal,
                      snbr, spos);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  const risi18::GatherSlots slots{state, snbr, spos, P, C};

  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int nc = min(Cc, C - c0);
    risi18::stage_K(K, Ks, C, c0, nc, Cc, Cout, Cout);
    // 1-3. The shared reductions of this chunk.
    risi18::chunk_reductions(slots, R, P, c0, nc, LD, m);
    // 4. The 18 cases of each output row times this chunk's rows of K.
    risi18::accumulate_products(m, Ap, ALD, R, S, trA, Ks, Zs, ZLD, P, Cc,
                                nc, Cout, LD);
  }

  // 5. Bias and LeakyReLU; neighbouring threads write neighbouring words.
  float* outv = out + v * PP * Cout;
  for (int i = tid; i < PP * Cout; i += nth) {
    const int r = i / Cout, o = i % Cout;
    const float z = Zs[o * ZLD + r] + bias[o];
    outv[i] = z > 0.f ? z : negslope * z;
  }
}

}  // namespace

extern "C" {

// Launches the level on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C] f32, nbr [N,P] i32, pos [N,P,P] i32, radj [N,P,P] f32,
// K [18C,Cout] f32, b [Cout] f32 -> out [N,P*P,Cout] f32, all contiguous.
int risi18_level_forward_f32(const void* state, const void* nbr,
                             const void* pos, const void* radj,
                             const void* K, const void* b, void* out,
                             int N, int P, int C, int Cout, float negslope,
                             void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  auto make = [&](int Cc) {
    return risi18::make_forward_layout(P, C, Cout, Cc, true);
  };
  const int Cc = risi18::choose_chunk(C, make);
  if (Cc == 0) return cudaErrorInvalidValue;
  const ForwardLayout L = make(Cc);
  const size_t bytes = risi18::smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      risi18_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  risi18_level_kernel<<<N, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)state, (const int*)nbr, (const int*)pos,
      (const float*)radj, (const float*)K, (const float*)b, (float*)out,
      N, L, negslope);
  return cudaGetLastError();
}

// The least shared memory one block needs at a channel chunk of one.
long long risi18_level_min_smem_bytes(int P, int Cout) {
  return risi18::min_forward_smem_bytes(P, Cout, true);
}

const char* risi18_level_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
