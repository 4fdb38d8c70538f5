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
// Design.  Kernel 1 walks vertices (grid-stride, at most kMaxPartials
// blocks) and, per vertex, channel chunks of Cc, all in shared memory:
// G, GAp, GR, GA once per vertex; per chunk, K's chunk rows, the forward's
// reductions, the dK chunk (added into the block's own partial row in
// global memory: no atomics, so dK is deterministic), the reductions'
// cotangents written over the reduction buffers, and the scatter.  Kernel 2
// sums the partial rows into dK and db.  All sums are in float32.  The
// algebra's device code is in risi18_common.cuh, shared with the bank's
// backward risi18_bank_bwd.cu.
//
// What bounds it.  At the production shape (N=256, P=16, C=32, Cout=32)
// the dK and the cotangent products are ~0.6 G FMAs each on the CUDA cores,
// fed from shared memory; the scatter is N*P^3*C = 33.5 M float atomics to
// L2 at most (fewer with absent slots); the re-gather reads ~134 MB, mostly
// from L2.  Phase 1 of the reductions keeps only P*Cc threads busy.  Tensor
// cores (wgmma), TMA and a segment scatter without atomics are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "risi18_common.cuh"

namespace {

using risi18::BackwardLayout;
using risi18::kCases;
using risi18::kThreads;

__global__ void __launch_bounds__(kThreads)
risi18_level_bwd_kernel(const float* __restrict__ state,
                        const int* __restrict__ nbr,
                        const int* __restrict__ pos,
                        const float* __restrict__ radj,
                        const float* __restrict__ K,
                        const float* __restrict__ gout,
                        const float* __restrict__ out,
                        float* __restrict__ dstate,
                        float* __restrict__ partial,
                        int N, BackwardLayout L, float negslope) {
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
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  const risi18::GatherSlots slots{state, snbr, spos, P, C};

  // This block's partial sums: dK rows (case*C + f) then db.
  const size_t W = (size_t)kCases * C * Cout + Cout;
  float* part = partial + blockIdx.x * W;

  for (size_t v = blockIdx.x; v < (size_t)N; v += gridDim.x) {
    const bool first = v == blockIdx.x;

    // geff of this vertex, G[r, o] with r = x*P + y.
    const float* gv = gout + v * PP * Cout;
    const float* ov = out + v * PP * Cout;
    for (int i = tid; i < PP * Cout; i += nth) {
      const float gi = gv[i];
      G[(i / Cout) * GLD + (i % Cout)] = ov[i] > 0.f ? gi : negslope * gi;
    }
    risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal,
                        snbr, spos);
    const float S = smem[L.scal], trA = smem[L.scal + 1];

    // G against the adjacency: GAp, GR, GA; and db.
    risi18::adjacency_products(G, Ap, R, GAp, GR, GA, P, Cout, ALD, GLD,
                               part + (size_t)kCases * C * Cout, first);

    for (int c0 = 0; c0 < C; c0 += Cc) {
      const int nc = min(Cc, C - c0);
      risi18::stage_K(K, Ks, C, c0, nc, Cc, Cout, GLD);
      // The forward's reductions of this chunk.
      risi18::chunk_reductions(slots, R, P, c0, nc, LD, m);
      // (a) dK of this chunk; (b, c) the reductions' cotangents.
      risi18::dk_chunk(m, G, GAp, GR, GA, S, trA, part, first, P, C, c0, nc,
                       Cout, LD, GLD);
      risi18::reduction_cotangents(m, G, GAp, GR, GA, Ks, S, trA, P, Cc, nc,
                                   Cout, LD, GLD);

      // (d) Scatter dT to the state, item (b, f): row b of every slot a.
      for (int item = tid; item < P * nc; item += nth) {
        const int f = item % nc, b = item / nc;
        const float* dtbc = m.tbc + f * LD + b * P;
        const float* dm10 = m.m10 + f * LD + b * P;
        for (int a = 0; a < P; ++a) {
          const int n = snbr[a];
          const int p1 = spos[a * P + b];
          if (n < 0 || p1 < 0) continue;
          const int ab = f * LD + a * P + b;
          const float dtab = m.tab[ab], dm6 = m.m6[ab];
          const float ddbc = m.dbc[ab], ddac = m.dac[ab], ra = R[a];
          float* row = dstate + (((size_t)n * P + p1) * P) * C + c0 + f;
          for (int c = 0; c < P; ++c) {
            const int p2 = spos[a * P + c];
            if (p2 < 0) continue;
            float val = dtab + dtbc[c] + dm6 * R[c] + ra * dm10[c];
            if (c == b) val += ddbc;
            if (c == a) val += ddac;
            atomicAdd(row + (size_t)p2 * C, val);
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Number of partial rows (blocks of kernel 1) for N vertices.
int risi18_level_backward_blocks(int N) { return risi18::partial_blocks(N); }

// Kernel 1 on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C] f32, nbr [N,P] i32, pos [N,P,P] i32, radj [N,P,P] f32,
// K [18C,Cout] f32, g and out [N,P*P,Cout] f32 -> adds into dstate
// [N,P,P,C] f32 (zeroed by the caller) and writes partial
// [nblocks, 18C*Cout + Cout] f32, all contiguous;
// nblocks = risi18_level_backward_blocks(N).
int risi18_level_backward_f32(const void* state, const void* nbr,
                              const void* pos, const void* radj,
                              const void* K, const void* g, const void* out,
                              void* dstate, void* partial, int N, int P,
                              int C, int Cout, float negslope, int nblocks,
                              void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  if (nblocks != risi18::partial_blocks(N)) return cudaErrorInvalidValue;
  auto make = [&](int Cc) {
    return risi18::make_backward_layout(P, C, Cout, Cc, true);
  };
  const int Cc = risi18::choose_chunk(C, make);
  if (Cc == 0) return cudaErrorInvalidValue;
  const BackwardLayout L = make(Cc);
  const size_t bytes = risi18::smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      risi18_level_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  risi18_level_bwd_kernel<<<nblocks, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)state, (const int*)nbr, (const int*)pos,
      (const float*)radj, (const float*)K, (const float*)g,
      (const float*)out, (float*)dstate, (float*)partial, N, L, negslope);
  return cudaGetLastError();
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

// The least shared memory one block needs at a channel chunk of one.
long long risi18_level_backward_min_smem_bytes(int P, int Cout) {
  return risi18::min_backward_smem_bytes(P, Cout, true);
}

const char* risi18_level_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
