// Device code shared by the level forward (risi18_level.cu) and the level
// backward (risi18_level_bwd.cu): the per-vertex structure and the shared
// reductions of the aligned slots, streamed from the state in global memory.
//
// Per vertex v, with Ap = max(radj[v], 0), R[d] = sum_e Ap[d,e], S = sum Ap,
// trA = tr Ap, and T[a,b,c,f] = state[nbr[v,a], pos[v,a,b], pos[v,a,c], f]
// (zero when the id is outside [0, N) or a position outside [0, P)), one
// channel chunk [c0, c0 + nc) yields, per channel f of the chunk:
//   [P,P] maps (stride LD per channel):
//     tab[a,b] = sum_c T[a,b,c]        tbc[b,c] = sum_a T[a,b,c]
//     dbc[a,b] = T[a,b,b]              dac[a,b] = T[a,b,a]
//     m6[a,b]  = sum_c T[a,b,c] R[c]   m10[b,c] = sum_a R[a] T[a,b,c]
//   [P] vectors (stride P per channel):
//     ta[x] = sum_b tab[x,b]   tb[x] = sum_{a,c} T[a,x,c]
//     tdbc[x] = sum_b T[x,b,b]   tdac[x] = sum_a T[a,x,a]
//   scalars: tfull = sum T, s14 = sum_{a,c} T[a,a,c], s15 = sum_{a,b} T[a,b,b],
//            t18 = sum_a T[a,a,a].
// These are the reductions of graphflow_tpu/ops/fused.py:54-67 and :87-93.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace risi18 {

constexpr int kCases = 18;
constexpr size_t kMaxSmemBytes = 232448;      // per block on sm_90

struct ChunkMaps {
  float *tab, *tbc, *dbc, *dac, *m6, *m10;    // [Cc][LD]
  float *ta, *tb, *tdbc, *tdac;               // [Cc][P]
  float *tfull, *s14, *s15, *t18;             // [Cc]
};

// Loads vertex v's guarded adjacency Ap (row stride ALD), neighbour ids and
// positions (-1 marks an absent slot or position; nothing out of range is
// read), then R, and S, trA into scal[0], scal[1].  Ends with a barrier.
__device__ inline void load_vertex(const int* __restrict__ nbr,
                                   const int* __restrict__ pos,
                                   const float* __restrict__ radj, size_t v,
                                   int N, int P, int ALD, float* Ap, float* R,
                                   float* scal, int* snbr, int* spos) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  for (int i = tid; i < PP; i += nth) {
    const float a = radj[v * PP + i];
    Ap[(i / P) * ALD + (i % P)] = a > 0.f ? a : 0.f;
    const int p = pos[v * PP + i];
    spos[i] = (p >= 0 && p < P) ? p : -1;
  }
  for (int i = tid; i < P; i += nth) {
    const int n = nbr[v * P + i];
    snbr[i] = (n >= 0 && n < N) ? n : -1;
  }
  __syncthreads();
  for (int d = tid; d < P; d += nth) {
    float s = 0.f;
    for (int e = 0; e < P; ++e) s += Ap[d * ALD + e];
    R[d] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, tr = 0.f;
    for (int d = 0; d < P; ++d) { s += R[d]; tr += Ap[d * ALD + d]; }
    scal[0] = s;
    scal[1] = tr;
  }
  __syncthreads();
}

// The reductions of one channel chunk into m.  Starts by zeroing the two
// slot-accumulated maps and ends with a barrier; the caller must not touch
// m's buffers while it runs.
__device__ inline void chunk_reductions(const float* __restrict__ state,
                                        const int* snbr, const int* spos,
                                        const float* R, int P, int C, int c0,
                                        int nc, int LD, const ChunkMaps& m) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < nc * LD; i += nth) { m.tbc[i] = 0.f; m.m10[i] = 0.f; }
  __syncthreads();

  // 1. Stream the aligned slots.  Item (b, f): row b of every slot a,
  //    channel c0 + f.  Neighbouring threads read neighbouring channels.
  //    The thread that owns (b, f) owns every entry it updates.
  for (int item = tid; item < P * nc; item += nth) {
    const int f = item % nc, b = item / nc;
    float* tbc_row = m.tbc + f * LD + b * P;
    float* m10_row = m.m10 + f * LD + b * P;
    float tb = 0.f, tdac = 0.f;
    for (int a = 0; a < P; ++a) {
      const int n = snbr[a];
      const int p1 = spos[a * P + b];
      const float ra = R[a];
      float tab = 0.f, m6 = 0.f, dbc = 0.f, dac = 0.f;
      if (n >= 0 && p1 >= 0) {
        const float* row = state + (((size_t)n * P + p1) * P) * C + c0 + f;
        for (int c = 0; c < P; ++c) {
          const int p2 = spos[a * P + c];
          const float x = p2 >= 0 ? __ldg(row + (size_t)p2 * C) : 0.f;
          tbc_row[c] += x;            // T_bc[b,c]  = sum_a T[a,b,c]
          m10_row[c] += ra * x;       // M10[b,c]   = sum_a R[a] T[a,b,c]
          tab += x;                   // T_ab[a,b]  = sum_c T[a,b,c]
          m6 += x * R[c];             // M6[a,b]    = sum_c T[a,b,c] R[c]
          if (c == b) dbc = x;        // D_bc[a,b]  = T[a,b,b]
          if (c == a) dac = x;        // D_ac[a,b]  = T[a,b,a]
        }
      }
      const int ab = f * LD + a * P + b;
      m.tab[ab] = tab;
      m.m6[ab] = m6;
      m.dbc[ab] = dbc;
      m.dac[ab] = dac;
      tb += tab;                      // T_b[b]  = sum_{a,c} T[a,b,c]
      tdac += dac;                    // sum_a T[a,b,a]
    }
    m.tb[f * P + b] = tb;
    m.tdac[f * P + b] = tdac;
  }
  __syncthreads();

  // 2. Row sums across slots.
  for (int item = tid; item < P * nc; item += nth) {
    const int f = item % nc, x = item / nc;
    float ta = 0.f, td = 0.f;
    for (int b = 0; b < P; ++b) {
      ta += m.tab[f * LD + x * P + b];  // T_a[x] = sum_b T_ab[x,b]
      td += m.dbc[f * LD + x * P + b];  // sum_b T[x,b,b]
    }
    m.ta[f * P + x] = ta;
    m.tdbc[f * P + x] = td;
  }
  __syncthreads();

  // 3. Per-channel scalars.
  for (int f = tid; f < nc; f += nth) {
    float tf = 0.f, s14 = 0.f, s15 = 0.f, t18 = 0.f;
    for (int x = 0; x < P; ++x) {
      tf += m.ta[f * P + x];
      s14 += m.tab[f * LD + x * P + x];  // sum_{a,c} T[a,a,c]
      s15 += m.tdbc[f * P + x];          // sum_{a,b} T[a,b,b]
      t18 += m.dbc[f * LD + x * P + x];  // sum_a T[a,a,a]
    }
    m.tfull[f] = tf; m.s14[f] = s14; m.s15[f] = s15; m.t18[f] = t18;
  }
  __syncthreads();
}

}  // namespace risi18
