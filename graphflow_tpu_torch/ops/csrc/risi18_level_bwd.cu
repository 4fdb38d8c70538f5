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
// sums the partial rows into dK and db.  All sums are in float32.
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

using risi18::kCases;
using risi18::kMaxSmemBytes;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kMaxPartials = 264;                // two blocks per SM, 132 SMs
constexpr size_t kTargetSmemBytes = 113 * 1024;  // two blocks per SM

// Offsets (in 4-byte words) of the block's shared-memory arrays.
struct Layout {
  int P, C, Cout, Cc;
  int LD;    // P*P + 1: padded stride of one channel plane of a [P,P] map
  int ALD;   // P + 1: padded row stride of Ap
  int GLD;   // Cout + 1: padded row stride of G, GAp, GR, GA and K's rows
  int ap, r, scal, g, gap, gr, ga, tab, tbc, dbc, dac, m6, m10, ta, tb;
  int tdbc, tdac, tfull, s14, s15, t18, ks, inbr, ipos, words;
};

Layout make_layout(int P, int C, int Cout, int Cc) {
  Layout L;
  L.P = P; L.C = C; L.Cout = Cout; L.Cc = Cc;
  L.LD = P * P + 1; L.ALD = P + 1; L.GLD = Cout + 1;
  int w = 0;
  auto take = [&w](int n) { int at = w; w += n; return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.g = take(P * P * L.GLD);
  L.gap = take(P * P * L.GLD);
  L.gr = take(P * L.GLD);
  L.ga = take(L.GLD);
  L.tab = take(Cc * L.LD);
  L.tbc = take(Cc * L.LD);
  L.dbc = take(Cc * L.LD);
  L.dac = take(Cc * L.LD);
  L.m6 = take(Cc * L.LD);
  L.m10 = take(Cc * L.LD);
  L.ta = take(Cc * P);
  L.tb = take(Cc * P);
  L.tdbc = take(Cc * P);
  L.tdac = take(Cc * P);
  L.tfull = take(Cc);
  L.s14 = take(Cc);
  L.s15 = take(Cc);
  L.t18 = take(Cc);
  L.ks = take(kCases * Cc * L.GLD);
  L.inbr = take(P);
  L.ipos = take(P * P);
  L.words = w;
  return L;
}

size_t smem_bytes(const Layout& L) { return sizeof(float) * (size_t)L.words; }

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
                        int N, Layout L, float negslope) {
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
  const risi18::ChunkMaps m{
      smem + L.tab, smem + L.tbc, smem + L.dbc, smem + L.dac, smem + L.m6,
      smem + L.m10, smem + L.ta, smem + L.tb, smem + L.tdbc, smem + L.tdac,
      smem + L.tfull, smem + L.s14, smem + L.s15, smem + L.t18};
  float* Ks = smem + L.ks;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);

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
    for (int i = tid; i < PP * Cout; i += nth) {
      const int o = i % Cout, r = i / Cout, x = r / P, e = r % P;
      float s = 0.f;
      for (int y = 0; y < P; ++y)
        s += G[(x * P + y) * GLD + o] * Ap[y * ALD + e];
      GAp[r * GLD + o] = s;
    }
    for (int i = tid; i < P * Cout; i += nth) {
      const int o = i % Cout, x = i / Cout;
      float s = 0.f;
      for (int y = 0; y < P; ++y) s += G[(x * P + y) * GLD + o] * R[y];
      GR[x * GLD + o] = s;
    }
    for (int o = tid; o < Cout; o += nth) {
      float ga = 0.f, gs = 0.f;
      for (int r = 0; r < PP; ++r) {
        const float g = G[r * GLD + o];
        ga += Ap[(r / P) * ALD + (r % P)] * g;
        gs += g;
      }
      GA[o] = ga;
      float* pdb = part + (size_t)kCases * C * Cout + o;
      *pdb = first ? gs : *pdb + gs;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += Cc) {
      const int nc = min(Cc, C - c0);
      for (int i = tid; i < kCases * nc * Cout; i += nth) {
        const int o = i % Cout, kf = i / Cout, f = kf % nc, k = kf / nc;
        Ks[(k * Cc + f) * GLD + o] = K[(size_t)(k * C + c0 + f) * Cout + o];
      }
      // The forward's reductions of this chunk (ends with a barrier).
      risi18::chunk_reductions(state, snbr, spos, R, P, C, c0, nc, LD, m);

      // (a) dK of this chunk, item (f, o): one dot product per case.
      for (int item = tid; item < nc * Cout; item += nth) {
        const int f = item / Cout, o = item % Cout;
        const float* tab = m.tab + f * LD;
        const float* tbc = m.tbc + f * LD;
        const float* dbc = m.dbc + f * LD;
        const float* dac = m.dac + f * LD;
        const float* m6 = m.m6 + f * LD;
        const float* m10 = m.m10 + f * LD;
        float a_tab = 0.f, a_tbc = 0.f, a_m6 = 0.f, a_m10 = 0.f;
        float b9 = 0.f, b12 = 0.f, b13 = 0.f, b16 = 0.f, b17 = 0.f;
        for (int r = 0; r < PP; ++r) {
          const int rt = (r % P) * P + r / P;      // (x, e) -> (e, x)
          const float g = G[r * GLD + o], gp = GAp[r * GLD + o];
          a_tab += tab[r] * g;
          a_tbc += tbc[r] * g;
          a_m6 += m6[r] * g;
          a_m10 += m10[r] * g;
          b9 += tab[r] * gp;                       // case 9:  T_ab[x,e]
          b12 += tab[rt] * gp;                     // case 12: T_ab[e,x]
          b13 += tbc[r] * gp;                      // case 13: T_bc[x,e]
          b16 += dbc[r] * gp;                      // case 16: T[x,e,e]
          b17 += dac[rt] * gp;                     // case 17: T[e,x,e]
        }
        float u1 = 0.f, u3 = 0.f, u7 = 0.f, u10 = 0.f;
        for (int x = 0; x < P; ++x) {
          const float gr = GR[x * GLD + o];
          u1 += m.ta[f * P + x] * gr;
          u3 += m.tb[f * P + x] * gr;
          u7 += m.tdbc[f * P + x] * gr;
          u10 += m.tdac[f * P + x] * gr;
        }
        const float ga = GA[o];
        float dk[kCases];
        dk[0] = S * a_tab;                // 1
        dk[1] = u1;                       // 2
        dk[2] = S * a_tbc;                // 3
        dk[3] = u3;                       // 4
        dk[4] = m.tfull[f] * ga;          // 5
        dk[5] = a_m6;                     // 6
        dk[6] = trA * a_tab;              // 7
        dk[7] = u7;                       // 8
        dk[8] = b9;                       // 9
        dk[9] = a_m10;                    // 10
        dk[10] = u10;                     // 11
        dk[11] = b12;                     // 12
        dk[12] = b13;                     // 13
        dk[13] = m.s14[f] * ga;           // 14
        dk[14] = m.s15[f] * ga;           // 15
        dk[15] = b16;                     // 16
        dk[16] = b17;                     // 17
        dk[17] = m.t18[f] * ga;           // 18
#pragma unroll
        for (int k = 0; k < kCases; ++k) {
          float* p = part + (size_t)(k * C + c0 + f) * Cout + o;
          *p = first ? dk[k] : *p + dk[k];
        }
      }
      __syncthreads();

      // (b) Cotangents of the vectors and scalars, over their buffers:
      //     ta <- dT_a, tb <- dT_b, tdbc <- dTdbc, tdac <- dTdac,
      //     tfull <- dTfull, s14 <- dS14, s15 <- dS15, t18 <- dT18.
      for (int item = tid; item < P * nc; item += nth) {
        const int f = item % nc, x = item / nc;
        const float* gr = GR + x * GLD;
        const float* k1 = Ks + (1 * Cc + f) * GLD;
        const float* k3 = Ks + (3 * Cc + f) * GLD;
        const float* k7 = Ks + (7 * Cc + f) * GLD;
        const float* k10 = Ks + (10 * Cc + f) * GLD;
        float s1 = 0.f, s3 = 0.f, s7 = 0.f, s10 = 0.f;
        for (int o = 0; o < Cout; ++o) {
          s1 += gr[o] * k1[o];
          s3 += gr[o] * k3[o];
          s7 += gr[o] * k7[o];
          s10 += gr[o] * k10[o];
        }
        m.ta[f * P + x] = s1;
        m.tb[f * P + x] = s3;
        m.tdbc[f * P + x] = s7;
        m.tdac[f * P + x] = s10;
      }
      for (int f = tid; f < nc; f += nth) {
        const float* k4 = Ks + (4 * Cc + f) * GLD;
        const float* k13 = Ks + (13 * Cc + f) * GLD;
        const float* k14 = Ks + (14 * Cc + f) * GLD;
        const float* k17 = Ks + (17 * Cc + f) * GLD;
        float s4 = 0.f, s13 = 0.f, s14 = 0.f, s17 = 0.f;
        for (int o = 0; o < Cout; ++o) {
          s4 += GA[o] * k4[o];
          s13 += GA[o] * k13[o];
          s14 += GA[o] * k14[o];
          s17 += GA[o] * k17[o];
        }
        m.tfull[f] = s4;
        m.s14[f] = s13;
        m.s15[f] = s14;
        m.t18[f] = s17;
      }
      __syncthreads();

      // (c) Cotangents of the maps, item (r, f), over their buffers.
      for (int item = tid; item < PP * nc; item += nth) {
        const int f = item % nc, r = item / nc, x = r / P, y = r % P;
        const float* g = G + r * GLD;
        const float* gp = GAp + r * GLD;
        const float* gt = GAp + (y * P + x) * GLD;   // GAp transposed
        const float* kf = Ks + f * GLD;
        const int ks = Cc * GLD;                     // stride between cases
        float y0 = 0.f, y2 = 0.f, y5 = 0.f, y6 = 0.f, y9 = 0.f;
        float y8 = 0.f, y11 = 0.f, y12 = 0.f, y15 = 0.f, y16 = 0.f;
        for (int o = 0; o < Cout; ++o) {
          const float a = g[o], p = gp[o], t = gt[o];
          y0 += a * kf[0 * ks + o];
          y2 += a * kf[2 * ks + o];
          y5 += a * kf[5 * ks + o];
          y6 += a * kf[6 * ks + o];
          y9 += a * kf[9 * ks + o];
          y8 += p * kf[8 * ks + o];
          y12 += p * kf[12 * ks + o];
          y15 += p * kf[15 * ks + o];
          y11 += t * kf[11 * ks + o];
          y16 += t * kf[16 * ks + o];
        }
        const bool diag = x == y;
        const int at = f * LD + r;
        m.tab[at] = S * y0 + trA * y6 + y8 + y11 + m.ta[f * P + x]
                    + m.tfull[f] + (diag ? m.s14[f] : 0.f);
        m.tbc[at] = S * y2 + y12 + m.tb[f * P + x];
        m.m6[at] = y5;
        m.m10[at] = y9;
        m.dbc[at] = y15 + m.tdbc[f * P + x] + m.s15[f]
                    + (diag ? m.t18[f] : 0.f);
        m.dac[at] = y16 + m.tdac[f * P + y];
      }
      __syncthreads();

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

// dK[i] (i < nK) or db[i - nK] = sum over the partial rows.
__global__ void __launch_bounds__(kReduceThreads)
risi18_level_bwd_reduce_kernel(const float* __restrict__ partial, int nparts,
                               int W, int nK, float* __restrict__ dK,
                               float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * W + i];
  if (i < nK) dK[i] = s; else db[i - nK] = s;
}

// Largest channel chunk (at most 32) whose block fits the target; 0 if not
// even one channel fits the hardware limit.
int choose_chunk(int P, int C, int Cout) {
  int Cc = C < 32 ? C : 32;
  while (Cc > 1 && smem_bytes(make_layout(P, C, Cout, Cc)) > kTargetSmemBytes)
    Cc = (Cc + 1) / 2;
  return smem_bytes(make_layout(P, C, Cout, Cc)) <= kMaxSmemBytes ? Cc : 0;
}

}  // namespace

extern "C" {

// Number of partial rows (blocks of kernel 1) for N vertices.
int risi18_level_backward_blocks(int N) {
  return N < kMaxPartials ? (N > 0 ? N : 0) : kMaxPartials;
}

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
  if (nblocks != risi18_level_backward_blocks(N)) return cudaErrorInvalidValue;
  const int Cc = choose_chunk(P, C, Cout);
  if (Cc == 0) return cudaErrorInvalidValue;
  const Layout L = make_layout(P, C, Cout, Cc);
  const size_t bytes = smem_bytes(L);
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
  const int nK = kCases * C * Cout, W = nK + Cout;
  const int grid = (W + kReduceThreads - 1) / kReduceThreads;
  risi18_level_bwd_reduce_kernel<<<grid, kReduceThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)partial, nblocks, W, nK, (float*)dK, (float*)db);
  return cudaGetLastError();
}

const char* risi18_level_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
