// Device code shared by the level kernels (risi18_level.cu, K1, and
// risi18_level_bwd.cu, K2) and the bank kernels (risi18_bank.cu, K4, and
// risi18_bank_bwd.cu, K5), and by the bank's ablation variants
// (risi18_bank_ablate.cu, K6): the per-vertex structure, the shared
// reductions of one vertex's slots, the 18-case products with K, and their
// adjoints.
//
// Per vertex v, with Ap = max(A[v], 0) (the adj>0 guard), R[d] =
// sum_e Ap[d,e], S = sum Ap and trA = tr Ap, the slots T[a,b,c,f] are
//   gathered     (K1, K2): state[nbr[v,a], pos[v,a,b], pos[v,a,c], f], zero
//                when the id is outside [0, N) or a position outside [0, P)
//                (GatherSlots, float or bfloat16), or
//   materialised (K4, K5): T[v,a,b,c,f], read as stored; the take-gather
//                that built T already wrote zeros where a slot is absent
//                (BankSlots, float or bfloat16).
// One channel chunk [c0, c0 + nc) yields, per channel f of the chunk:
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
// Every sum is in float32; a bfloat16 value is converted once, on load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace risi18 {

constexpr int kCases = 18;
constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;         // per block on sm_90
constexpr size_t kTargetSmemBytes = 113 * 1024;  // two blocks per SM
constexpr int kMaxPartials = 264;                // two blocks per SM, 132 SMs

// How much of the bank chunk_reductions, accumulate_products and bank_block
// compute.  Every kernel of the package computes kFull; the other parts exist
// for the ablation variants (risi18_bank_ablate.cu), which time this same
// device code with one stage left out:
//   kNoGroupD     without the adjacency-weighted cases 6, 9, 10, 12, 13, 16,
//                 17 (K's blocks 5, 8, 9, 11, 12, 15, 16): no M6 and M10 in
//                 the slot stream, no M9/M12/M13/M16/M17, 11 products instead
//                 of 18;
//   kNoSelect     every diagonal extraction replaced by the full sum, which
//                 is wrong as a contraction by design: D_bc = D_ac = T_ab,
//                 T_bc[b,c] = T_b[b], M10[b,c] = sum_{a,c'} R[a] T[a,b,c'],
//                 s14 = t18 = tfull (so tdbc = ta, tdac = tb, s15 = tfull).
//                 The stream does the same loads and shared-memory updates
//                 as kFull, without the (c == b), (c == a) picks;
//   kTwoProducts  the stream and the reductions (without M6 and M10), then
//                 two products instead of eighteen:
//                 Z = (T_ab + T_bc + W17) K[0:C] + (D_bc + D_ac) K[C:2C],
//                 W17[x,y] = T[y,x,y] = D_ac[y,x].
enum BankPart { kFull = 0, kNoGroupD = 1, kNoSelect = 2, kTwoProducts = 3 };

// Whether `part` computes the adjacency-weighted full-map cases (group D).
__host__ __device__ constexpr bool has_group_d(BankPart part) {
  return part == kFull || part == kNoSelect;
}

// Whether 0-based case k is one of those cases.
__host__ __device__ constexpr bool is_group_d(int k) {
  return k == 5 || k == 8 || k == 9 || k == 11 || k == 12 || k == 15 ||
         k == 16;
}

struct ChunkMaps {
  float *tab, *tbc, *dbc, *dac, *m6, *m10;    // [Cc][LD]
  float *ta, *tb, *tdbc, *tdac;               // [Cc][P]
  float *tfull, *s14, *s15, *t18;             // [Cc]
};

// Offsets (in 4-byte words) of a forward block's shared-memory arrays (K1,
// K4): the adjacency, the chunk's maps, K's chunk rows Ks [18][Cc][Cout], the
// output Zs [Cout][ZLD] and, for a gathering kernel, the neighbour ids and
// positions.
struct ForwardLayout {
  int P, C, Cout, Cc;
  int LD;    // P*P + 1: padded stride of one channel plane of a [P,P] map
  int ALD;   // P + 1: padded row stride of Ap
  int ZLD;   // P*P + 1: padded stride of one output channel of Z
  int ap, r, scal, maps, ks, zs, inbr, ipos, words;
};

// Offsets of a backward block's arrays (K2, K5): the adjacency, the
// cotangent G [P*P][GLD] and its products GAp [P*P][GLD], GR [P][GLD],
// GA [GLD], the chunk's maps, Ks [18][Cc][GLD] and, for a gathering kernel,
// the neighbour ids and positions.
struct BackwardLayout {
  int P, C, Cout, Cc;
  int LD, ALD;
  int GLD;   // Cout + 1: padded row stride of G, GAp, GR, GA and K's rows
  int ap, r, scal, g, gap, gr, ga, maps, ks, inbr, ipos, words;
};

// The chunk's maps, vectors and scalars, laid out from word `at` on.
inline int take_maps(int at, int P, int Cc, int LD) {
  return at + 6 * Cc * LD + 4 * Cc * P + 4 * Cc;
}

inline ForwardLayout make_forward_layout(int P, int C, int Cout, int Cc,
                                         bool gather) {
  ForwardLayout L;
  L.P = P; L.C = C; L.Cout = Cout; L.Cc = Cc;
  L.LD = P * P + 1; L.ALD = P + 1; L.ZLD = P * P + 1;
  int w = 0;
  auto take = [&w](int n) { int at = w; w += n; return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.maps = w;
  w = take_maps(w, P, Cc, L.LD);
  L.ks = take(kCases * Cc * Cout);
  L.zs = take(Cout * L.ZLD);
  L.inbr = take(gather ? P : 0);
  L.ipos = take(gather ? P * P : 0);
  L.words = w;
  return L;
}

inline BackwardLayout make_backward_layout(int P, int C, int Cout, int Cc,
                                           bool gather) {
  BackwardLayout L;
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
  L.maps = w;
  w = take_maps(w, P, Cc, L.LD);
  L.ks = take(kCases * Cc * L.GLD);
  L.inbr = take(gather ? P : 0);
  L.ipos = take(gather ? P * P : 0);
  L.words = w;
  return L;
}

template <typename Layout>
size_t smem_bytes(const Layout& L) { return sizeof(float) * (size_t)L.words; }

// The least shared memory a forward or a backward block needs: its layout at
// a channel chunk of one.  The wrappers ask this before a launch, to refuse a
// receptive field that cannot fit with its sizes named.
inline long long min_forward_smem_bytes(int P, int Cout, bool gather) {
  return (long long)smem_bytes(make_forward_layout(P, 1, Cout, 1, gather));
}
inline long long min_backward_smem_bytes(int P, int Cout, bool gather) {
  return (long long)smem_bytes(make_backward_layout(P, 1, Cout, 1, gather));
}

// Largest channel chunk (at most 32) whose block fits the two-blocks-per-SM
// target; 0 if not even one channel fits the hardware limit.  `make(Cc)`
// builds the layout at chunk Cc.
template <typename Make>
int choose_chunk(int C, Make make) {
  int Cc = C < 32 ? C : 32;
  while (Cc > 1 && smem_bytes(make(Cc)) > kTargetSmemBytes)
    Cc = (Cc + 1) / 2;
  return smem_bytes(make(Cc)) <= kMaxSmemBytes ? Cc : 0;
}

__device__ inline ChunkMaps chunk_maps(float* smem, int at, int P, int Cc,
                                       int LD) {
  float* s = smem + at;
  const int map = Cc * LD, vec = Cc * P;
  return ChunkMaps{s, s + map, s + 2 * map, s + 3 * map, s + 4 * map,
                   s + 5 * map,
                   s + 6 * map, s + 6 * map + vec, s + 6 * map + 2 * vec,
                   s + 6 * map + 3 * vec,
                   s + 6 * map + 4 * vec, s + 6 * map + 4 * vec + Cc,
                   s + 6 * map + 4 * vec + 2 * Cc,
                   s + 6 * map + 4 * vec + 3 * Cc};
}

// -- element types ----------------------------------------------------------

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store_value(float* p, float x) { *p = x; }
__device__ inline void store_value(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// -- the vertex's structure -------------------------------------------------

// Loads vertex v's guarded adjacency Ap (row stride ALD), then R, and S, trA
// into scal[0], scal[1].  Ends with a barrier.
__device__ inline void load_adjacency(const float* __restrict__ radj,
                                      size_t v, int P, int ALD, float* Ap,
                                      float* R, float* scal) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  for (int i = tid; i < PP; i += nth) {
    const float a = radj[v * PP + i];
    Ap[(i / P) * ALD + (i % P)] = a > 0.f ? a : 0.f;
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

// load_adjacency, after loading vertex v's neighbour ids and positions (-1
// marks an absent slot or position; nothing out of range is read).
__device__ inline void load_vertex(const int* __restrict__ nbr,
                                   const int* __restrict__ pos,
                                   const float* __restrict__ radj, size_t v,
                                   int N, int P, int ALD, float* Ap, float* R,
                                   float* scal, int* snbr, int* spos) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  for (int i = tid; i < PP; i += nth) {
    const int p = pos[v * PP + i];
    spos[i] = (p >= 0 && p < P) ? p : -1;
  }
  for (int i = tid; i < P; i += nth) {
    const int n = nbr[v * P + i];
    snbr[i] = (n >= 0 && n < N) ? n : -1;
  }
  load_adjacency(radj, v, P, ALD, Ap, R, scal);
}

// -- slot loaders -----------------------------------------------------------
// row(a, b, ch, r): whether row b of slot a is present, and its base for
// channel ch; load(r, a, c): T[a,b,c] at that channel, as float.

// The aligned slots gathered from the previous level's state (K1, K2),
// float or bfloat16.
template <typename E>
struct GatherSlots {
  const E* __restrict__ state;       // [N,P,P,C]
  const int* snbr;                   // [P] in shared memory, -1 when absent
  const int* spos;                   // [P,P] in shared memory, -1 when absent
  int P, C;
  using Row = const E*;
  __device__ bool row(int a, int b, int ch, Row& r) const {
    const int n = snbr[a], p1 = spos[a * P + b];
    if (n < 0 || p1 < 0) return false;
    r = state + (((size_t)n * P + p1) * P) * C + ch;
    return true;
  }
  __device__ float load(Row r, int a, int c) const {
    const int p2 = spos[a * P + c];
    return p2 >= 0 ? to_float(__ldg(r + (size_t)p2 * C)) : 0.f;
  }
};

// One vertex's materialised slots T [P,P,P,C] (K4, K5).
template <typename E>
struct BankSlots {
  const E* __restrict__ T;
  int P, C;
  using Row = const E*;
  __device__ bool row(int a, int b, int ch, Row& r) const {
    r = T + ((size_t)(a * P + b) * P) * C + ch;
    return true;
  }
  __device__ float load(Row r, int, int c) const {
    return to_float(r[(size_t)c * C]);
  }
};

// The reductions of one channel chunk into m.  Starts by zeroing the two
// slot-accumulated maps and ends with a barrier; the caller must not touch
// m's buffers while it runs.
template <typename Slots, BankPart kPart = kFull>
__device__ inline void chunk_reductions(const Slots& slots, const float* R,
                                        int P, int c0, int nc, int LD,
                                        const ChunkMaps& m) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < nc * LD; i += nth) { m.tbc[i] = 0.f; m.m10[i] = 0.f; }
  __syncthreads();

  // 1. Stream the slots.  Item (b, f): row b of every slot a, channel
  //    c0 + f.  Neighbouring threads read neighbouring channels.  The
  //    thread that owns (b, f) owns every entry it updates.
  for (int item = tid; item < P * nc; item += nth) {
    const int f = item % nc, b = item / nc;
    float* tbc_row = m.tbc + f * LD + b * P;
    float* m10_row = m.m10 + f * LD + b * P;
    float tb = 0.f, tdac = 0.f;
    for (int a = 0; a < P; ++a) {
      const float ra = R[a];
      float tab = 0.f, m6 = 0.f, dbc = 0.f, dac = 0.f;
      typename Slots::Row row;
      if (slots.row(a, b, c0 + f, row)) {
        for (int c = 0; c < P; ++c) {
          const float x = slots.load(row, a, c);
          if constexpr (kPart != kNoSelect)
            tbc_row[c] += x;          // T_bc[b,c]  = sum_a T[a,b,c]
          if constexpr (kPart == kFull)
            m10_row[c] += ra * x;     // M10[b,c]   = sum_a R[a] T[a,b,c]
          tab += x;                   // T_ab[a,b]  = sum_c T[a,b,c]
          if constexpr (has_group_d(kPart))
            m6 += x * R[c];           // M6[a,b]    = sum_c T[a,b,c] R[c]
          if constexpr (kPart != kNoSelect) {
            if (c == b) dbc = x;      // D_bc[a,b]  = T[a,b,b]
            if (c == a) dac = x;      // D_ac[a,b]  = T[a,b,a]
          }
        }
        if constexpr (kPart == kNoSelect) {
          for (int c = 0; c < P; ++c) {
            tbc_row[c] += tab;
            m10_row[c] += ra * tab;
          }
          dbc = tab;
          dac = tab;
        }
      }
      const int ab = f * LD + a * P + b;
      m.tab[ab] = tab;
      if constexpr (has_group_d(kPart)) m.m6[ab] = m6;
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
    if constexpr (kPart == kNoSelect) { s14 = tf; t18 = tf; }
    m.tfull[f] = tf; m.s14[f] = s14; m.s15[f] = s15; m.t18[f] = t18;
  }
  __syncthreads();
}

// K's rows of the chunk, Ks[(k*Cc + f)*ldk + o] = K[(k*C + c0 + f), o], as
// float.  No barrier: the next chunk_reductions' first barrier orders it.
template <typename E>
__device__ inline void stage_K(const E* __restrict__ K, float* Ks, int C,
                               int c0, int nc, int Cc, int Cout, int ldk) {
  for (int i = threadIdx.x; i < kCases * nc * Cout; i += blockDim.x) {
    const int o = i % Cout, kf = i / Cout, f = kf % nc, k = kf / nc;
    Ks[(k * Cc + f) * ldk + o] =
        to_float(K[(size_t)(k * C + c0 + f) * Cout + o]);
  }
}

// -- forward: the 18 cases times K ------------------------------------------

// Assembles the 18 cases of each output row (x, y) for the chunk's channels,
// forming the adjacency-weighted cases M9/M12/M13/M16/M17 on the fly, and
// adds their product with the chunk's rows of K (Ks, ldk = Cout) into
// Zs [Cout][ZLD].  Ends with a barrier.
template <BankPart kPart = kFull>
__device__ inline void accumulate_products(const ChunkMaps& m,
                                           const float* Ap, int ALD,
                                           const float* R, float S, float trA,
                                           const float* Ks, float* Zs,
                                           int ZLD, int P, int Cc, int nc,
                                           int Cout, int LD) {
  const int PP = P * P;
  if constexpr (kPart == kTwoProducts) {
    for (int r = threadIdx.x; r < PP; r += blockDim.x) {
      const int rt = (r % P) * P + r / P;        // (x, y) -> (y, x)
      for (int f = 0; f < nc; ++f) {
        const int at = f * LD;
        const float y0 = m.tab[at + r] + m.tbc[at + r] + m.dac[at + rt];
        const float y1 = m.dbc[at + r] + m.dac[at + r];
        const float* k0 = Ks + f * Cout;
        const float* k1 = Ks + (Cc + f) * Cout;
        for (int o = 0; o < Cout; ++o)
          Zs[o * ZLD + r] += y0 * k0[o] + y1 * k1[o];
      }
    }
    __syncthreads();
    return;
  }
  for (int r = threadIdx.x; r < PP; r += blockDim.x) {
    const int x = r / P, y = r % P;
    const float Ry = R[y], Axy = Ap[x * ALD + y];
    const float* Ay = Ap + y * ALD;
    for (int f = 0; f < nc; ++f) {
      const float* tab = m.tab + f * LD;
      const float* tbc = m.tbc + f * LD;
      const float* dbc = m.dbc + f * LD;
      const float* dac = m.dac + f * LD;
      float m9 = 0.f, m12 = 0.f, m13 = 0.f, m16 = 0.f, m17 = 0.f;
      if constexpr (has_group_d(kPart)) {
        for (int e = 0; e < P; ++e) {
          const float a = Ay[e];        // Ap[y, e]
          m9 += tab[x * P + e] * a;     // sum_e T_ab[x,e] Ap[y,e]
          m12 += tab[e * P + x] * a;    // sum_e T_ab[e,x] Ap[y,e]
          m13 += tbc[x * P + e] * a;    // sum_e T_bc[x,e] Ap[y,e]
          m16 += dbc[x * P + e] * a;    // sum_e T[x,e,e] Ap[y,e]
          m17 += dac[e * P + x] * a;    // sum_e T[e,x,e] Ap[y,e]
        }
      }
      float yk[kCases];
      yk[0] = tab[r] * S;                   // 1  (a,b)
      yk[1] = m.ta[f * P + x] * Ry;         // 2  (a,d)
      yk[2] = tbc[r] * S;                   // 3  (b,c)
      yk[3] = m.tb[f * P + x] * Ry;         // 4  (b,d)
      yk[4] = Axy * m.tfull[f];             // 5  (d,e)
      yk[5] = has_group_d(kPart) ? m.m6[f * LD + r] : 0.f;  // 6 (a,b) c==d
      yk[6] = tab[r] * trA;                 // 7  (a,b) d==e
      yk[7] = m.tdbc[f * P + x] * Ry;       // 8  (a,d) b==c
      yk[8] = m9;                           // 9  (a,d) b==e
      yk[9] = has_group_d(kPart) ? m.m10[f * LD + r] : 0.f;  // 10 (b,c) a==d
      yk[10] = m.tdac[f * P + x] * Ry;      // 11 (b,d) a==c
      yk[11] = m12;                         // 12 (b,d) a==e
      yk[12] = m13;                         // 13 (b,d) c==e
      yk[13] = Axy * m.s14[f];              // 14 (d,e) a==b
      yk[14] = Axy * m.s15[f];              // 15 (d,e) b==c
      yk[15] = m16;                         // 16 (a,d) b==c==e
      yk[16] = m17;                         // 17 (b,d) a==c==e
      yk[17] = Axy * m.t18[f];              // 18 (d,e) a==b==c
      const float* kf = Ks + f * Cout;
      for (int o = 0; o < Cout; ++o) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kCases; ++k) {
          if (!has_group_d(kPart) && is_group_d(k)) continue;
          acc += yk[k] * kf[k * Cc * Cout + o];
        }
        Zs[o * ZLD + r] += acc;
      }
    }
  }
  __syncthreads();
}

// One vertex's bank over materialised slots, the whole block of the bank
// kernel (risi18_bank.cu): Z[v] = the 18 cases of T[v] against max(A[v], 0),
// times K, walked in channel chunks of L.Cc with Z kept in shared memory and
// rounded to E once, when written.
template <typename E, BankPart kPart = kFull>
__device__ __forceinline__ void bank_block(const E* __restrict__ T,
                                           const float* __restrict__ A,
                                           const E* __restrict__ K,
                                           E* __restrict__ Z,
                                           const ForwardLayout& L) {
  extern __shared__ float smem[];
  const int P = L.P, C = L.C, Cout = L.Cout, Cc = L.Cc;
  const int LD = L.LD, ALD = L.ALD, ZLD = L.ZLD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  const ChunkMaps m = chunk_maps(smem, L.maps, P, Cc, LD);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;

  for (int i = tid; i < Cout * ZLD; i += nth) Zs[i] = 0.f;
  load_adjacency(A, v, P, ALD, Ap, R, smem + L.scal);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  const BankSlots<E> slots{T + v * PP * P * C, P, C};

  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int nc = min(Cc, C - c0);
    stage_K(K, Ks, C, c0, nc, Cc, Cout, Cout);
    chunk_reductions<BankSlots<E>, kPart>(slots, R, P, c0, nc, LD, m);
    accumulate_products<kPart>(m, Ap, ALD, R, S, trA, Ks, Zs, ZLD, P, Cc, nc,
                               Cout, LD);
  }

  E* zv = Z + v * PP * Cout;
  for (int i = tid; i < PP * Cout; i += nth)
    store_value(zv + i, Zs[(i % Cout) * ZLD + i / Cout]);
}

// -- backward: the adjoint of accumulate_products ---------------------------
// Per vertex, with G the cotangent of its [P*P, Cout] output as [P,P,Cout],
//   GAp[x,e,o] = sum_y G[x,y,o] Ap[y,e],  GR[x,o] = sum_y G[x,y,o] R[y],
//   GA[o] = sum_{x,y} Ap[x,y] G[x,y,o].
// dK per case is a [P*P]- or [P]-long dot product of one of the reductions
// with G, GAp or GR, or a scalar times GA; the cotangent of each reduction is
// G, GAp (or its transpose), GR or GA times one of K's case slabs; and
//   dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
//             + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].

// GAp, GR and GA from G; when db is given, also adds (or, for the block's
// first vertex, writes) G's column sums into db.  Ends with a barrier.
__device__ inline void adjacency_products(const float* G, const float* Ap,
                                          const float* R, float* GAp,
                                          float* GR, float* GA, int P,
                                          int Cout, int ALD, int GLD,
                                          float* db, bool first) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
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
    if (db) db[o] = first ? gs : db[o] + gs;
  }
  __syncthreads();
}

// dK of the chunk, item (f, o): one dot product per case, added into (or,
// for the block's first vertex, written to) the block's partial row
// part[(k*C + c0 + f)*Cout + o].  Ends with a barrier.
__device__ inline void dk_chunk(const ChunkMaps& m, const float* G,
                                const float* GAp, const float* GR,
                                const float* GA, float S, float trA,
                                float* part, bool first, int P, int C,
                                int c0, int nc, int Cout, int LD, int GLD) {
  const int PP = P * P;
  for (int item = threadIdx.x; item < nc * Cout; item += blockDim.x) {
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
}

// The reductions' cotangents, written over m's buffers:
//   ta <- dT_a, tb <- dT_b, tdbc <- dTdbc, tdac <- dTdac,
//   tfull <- dTfull, s14 <- dS14, s15 <- dS15, t18 <- dT18;
//   tab <- dTab (with every broadcast folded in), tbc <- dTbc, m6 <- dM6,
//   m10 <- dM10, dbc <- dDbc, dac <- dDac.
// Ks holds K's chunk rows with ldk = GLD.  Ends with a barrier.
__device__ inline void reduction_cotangents(const ChunkMaps& m,
                                            const float* G, const float* GAp,
                                            const float* GR, const float* GA,
                                            const float* Ks, float S,
                                            float trA, int P, int Cc, int nc,
                                            int Cout, int LD, int GLD) {
  const int tid = threadIdx.x, nth = blockDim.x, PP = P * P;
  // (b) The vectors and scalars.
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

  // (c) The maps, item (r, f).
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
}

// out[i] (i < nK) or db[i - nK] = the sum of column i over the nparts
// partial rows of width W (db may be null when W == nK).
__global__ void __launch_bounds__(kThreads)
sum_partial_rows(const float* __restrict__ partial, int nparts, int W,
                 int nK, float* __restrict__ out, float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * W + i];
  if (i < nK) out[i] = s; else db[i - nK] = s;
}

// Number of partial rows (blocks of a backward kernel) for N vertices.
inline int partial_blocks(int N) {
  return N < kMaxPartials ? (N > 0 ? N : 0) : kMaxPartials;
}

// Launches sum_partial_rows over W columns; returns a cudaError_t.
inline int launch_sum_partial_rows(const float* partial, int nparts, int W,
                                   int nK, float* out, float* db,
                                   cudaStream_t stream) {
  const int grid = (W + kThreads - 1) / kThreads;
  sum_partial_rows<<<grid, kThreads, 0, stream>>>(partial, nparts, W, nK,
                                                  out, db);
  return cudaGetLastError();
}

}  // namespace risi18
