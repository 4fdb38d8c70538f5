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
// this algebra in plain PyTorch.
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

#include "risi18_level_common.cuh"

namespace {

using risi18::kCases;
using risi18::level::kThreads;
using risi18::level::StreamPlan;
namespace lv = risi18::level;

constexpr int kGroups = 132;     // vertex groups: partial rows of [dK | db]
constexpr int kSlabs = 10;       // dK's map cases, cases 1 and 7 apart

// A backward block's shared memory, offsets in 4-byte words.
struct BackwardPlan {
  StreamPlan sp;
  int Cout;
  int Co;      // output channels of one block's panel
  int GLD;     // row stride of G, GAp, GR, GA, K's rows and the dK buffers
  int mma;     // 1: dK's map cases and the maps' cotangents run on the
               // tensor cores (dk_maps_mma, cotangent_maps_mma)
  int wide_g;  // g and out start at multiples of 16 bytes
  int ALD;     // P + 1
  int ap, r, scal, inbr, ipos, islots, g, gap, gr, ga, gax, gsx, stream, ks,
      dkv, dbs, red, words;
};

// `wide`: on the tensor cores, whether the rows of G, GAp and K lie eight
// words further apart than the panel (no bank conflicts) or four.
BackwardPlan make_backward_plan(int P, int C, int Cout, int Cc, int D, int Co,
                                int es, int aligned, bool wide) {
  BackwardPlan L;
  L.sp = lv::make_stream_plan(P, C, Cc, D, es, aligned);
  L.Cout = Cout; L.Co = Co; L.ALD = P + 1; L.wide_g = 0;
  // The tensor cores take chunks of 8 or 16 channels, 16-row tiles of the
  // maps, a warp a tile, and the panel's outputs eight at a time.
  const int Co4 = lv::round_up(Co, 4);
  L.mma = (L.sp.ncp == 8 || L.sp.ncp == 16) && (P * P) % 16 == 0 &&
          P * P / 16 <= kThreads / 32 && Co4 % 8 == 0 && Co4 <= 32;
  // Four more than the panel: rows a multiple of 4 words apart fall on
  // different banks, and an 8-wide tile may read past an odd group of four.
  // Eight more for the tensor cores, whose lanes read two words of each of
  // four rows, or one word of each of four rows eight lanes wide; four,
  // with some conflicts, where that buys a larger chunk.
  L.GLD = Co4 + (L.mma && wide ? 8 : 4);
  const int rows = lv::round_up(P * P, 4);
  int w = 0;
  auto take = [&w](int n) { int at = w; w += lv::round_up(n, 4); return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.inbr = take(P);
  L.ipos = take(P * P);
  L.islots = take(P + 1);
  L.g = take(rows * L.GLD);
  L.gap = take(rows * L.GLD);
  L.gr = take(P * L.GLD);
  L.ga = take(L.GLD);
  L.gax = take(P * L.GLD);
  L.gsx = take(P * L.GLD);
  L.stream = take(lv::stream_words(L.sp));
  L.ks = take(kCases * L.sp.ncp * L.GLD);
  L.dkv = take(8 * L.sp.ncp * L.GLD);
  L.dbs = take(L.GLD);
  L.red = take(kSlabs * L.sp.ncp * L.GLD);
  L.words = w;
  return L;
}

// The plan that fits one block with the widest panel, then the largest
// chunk, then the deepest ring, then the wide rows; words == 0 if none
// fits.  (The stream's wide plans, for fields of more than 32 rows, are not
// taken: G and GAp of such a field leave no room for the maps.)
BackwardPlan choose_backward_plan(int P, int C, int Cout, int es,
                                  int aligned) {
  for (int Co = Cout;; Co = lv::round_up((Co + 1) / 2, 4)) {
    for (int Cc : {lv::kMaxChunk, 8, 4}) {
      Cc = Cc < C ? Cc : C;
      for (int D = 4; D >= 2; --D) {
        for (bool wide : {true, false}) {
          const BackwardPlan L = make_backward_plan(P, C, Cout, Cc, D, Co,
                                                    es, aligned, wide);
          // Every dK tile (slab, four channels, eight outputs) needs a
          // thread.
          const bool tiled = kSlabs * (L.sp.ncp / 4) * ((Co + 7) / 8)
                             <= kThreads;
          if (tiled && !L.sp.wide &&
              sizeof(float) * (size_t)L.words <= risi18::kMaxSmemBytes)
            return L;
        }
      }
    }
    if (Co <= 4) break;
  }
  BackwardPlan none{};
  return none;
}

// dK's map slabs: the map, whether it meets GAp (else G), its per-vertex
// scale (0: one, 1: S, 2: trA) and K's 0-based case.
__constant__ int kSlabMap[kSlabs] = {lv::kTab, lv::kTab, lv::kTbc, lv::kM6,
                                     lv::kM10, lv::kTab, lv::kTabT, lv::kTbc,
                                     lv::kDbc, lv::kDacT};
__constant__ int kSlabScale[kSlabs] = {1, 2, 1, 0, 0, 0, 0, 0, 0, 0};
__constant__ int kSlabCase[kSlabs] = {0, 6, 2, 5, 9, 8, 11, 12, 15, 16};
// The vector cases (against GR) and the scalar cases (against GA).
__constant__ int kVectorCase[8] = {1, 3, 7, 10, 4, 13, 14, 17};

// dK's map cases on the tensor cores, for one vertex: dk[nt] += the product
// A^T Gm over this warp's rows [r_begin, r_end) of the maps, where A's 16
// columns are the channels of one map (16-channel chunks) or of two (8-
// channel chunks; `second` < 0: of one, the other eight idle) and Gm is G
// or GAp, eight outputs a tile nt < nnt.  With g = lane / 4, t = lane % 4,
// dk[nt][0..1] are outputs 8 nt + 2t, 2t + 1 of A's column g, dk[nt][2..3]
// of column g + 8.  Floats are split in two TF32 values and every product
// takes three passes (lv::mma_3xtf32), which keeps float32's accuracy.
__device__ __forceinline__ void dk_maps_mma(float (&dk)[4][4],
                                            const float* lo_map,
                                            float lo_scale,
                                            const float* hi_map,
                                            float hi_scale, const float* Gm,
                                            int r_begin, int r_end, int nnt,
                                            int ncp, int GLD, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = r_begin; r0 < r_end; r0 += 8) {
    unsigned ah[4], al[4];
    const int at = (r0 + t) * ncp;
    lv::split_tf32(lo_scale * lo_map[at], ah[0], al[0]);
    lv::split_tf32(hi_scale * hi_map[at], ah[1], al[1]);
    lv::split_tf32(lo_scale * lo_map[at + 4 * ncp], ah[2], al[2]);
    lv::split_tf32(hi_scale * hi_map[at + 4 * ncp], ah[3], al[3]);
    const float* gm = Gm + (r0 + t) * GLD + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < nnt) {
        unsigned bh[2], bl[2];
        lv::split_tf32(gm[8 * nt], bh[0], bl[0]);
        lv::split_tf32(gm[4 * GLD + 8 * nt], bh[1], bl[1]);
        lv::mma_3xtf32(dk[nt], ah, al, bh, bl);
      }
    }
  }
}

// The cotangents of five maps on the tensor cores, for the 16 rows from
// row0 of one vertex: y[j][nt] = Gm [16 x Cout] times slab kSlabCase[first
// + j] of K, transposed [Cout x 8 channels from 8 nt], j < 5, nt < kNT.
// With g = lane / 4, t = lane % 4, y[j][nt][0..1] are channels 8 nt + 2t,
// 2t + 1 of row row0 + g, y[j][nt][2..3] of row row0 + g + 8.  The order of
// the outputs in a k-step is free as long as both operands follow it: a
// lane reads outputs 2t, 2t + 1 of its rows as one float2.
template <int kNT>
__device__ __forceinline__ void cotangent_maps_mma(float (&y)[5][kNT][4],
                                                   const float* Gm,
                                                   const float* Ks,
                                                   const int* cases,
                                                   int row0, int ksteps,
                                                   int ncp, int GLD,
                                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[j][nt][i] = 0.f;
  const float* gm = Gm + (row0 + g) * GLD + 2 * t;
  for (int ks = 0; ks < ksteps; ++ks) {
    const float2 top = *reinterpret_cast<const float2*>(gm + 8 * ks);
    const float2 bottom =
        *reinterpret_cast<const float2*>(gm + 8 * GLD + 8 * ks);
    unsigned ah[4], al[4];
    lv::split_tf32(top.x, ah[0], al[0]);
    lv::split_tf32(bottom.x, ah[1], al[1]);
    lv::split_tf32(top.y, ah[2], al[2]);
    lv::split_tf32(bottom.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Ks + (cases[j] * ncp + 8 * nt + g) * GLD + 8 * ks + 2 * t);
        unsigned bh[2], bl[2];
        lv::split_tf32(kv.x, bh[0], bl[0]);
        lv::split_tf32(kv.y, bh[1], bl[1]);
        lv::mma_3xtf32(y[j][nt], ah, al, bh, bl);
      }
    }
  }
}

// Writes the maps' cotangents of the rows row0 + g and row0 + g + 8 from
// cotangent_maps_mma's two halves: G's (slabs 0..4) stores, GAp's (5..9)
// adds to T_ab's and T_bc's and stores the rest.
template <int kNT>
__device__ __forceinline__ void store_cotangents(
    const float (&y)[5][kNT][4], bool second, float S, float trA, float* tab,
    float* tabT, float* tbc, float* dbc, float* dacT, float* m6, float* m10,
    int row0, int ncp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (row0 + g + 8 * h) * ncp + 8 * nt + 2 * t;
      auto two = [&](int j) {
        return make_float2(y[j][nt][2 * h], y[j][nt][2 * h + 1]);
      };
      auto put = [&](float* map, float2 v) {
        *reinterpret_cast<float2*>(map + at) = v;
      };
      if (!second) {
        const float2 a = two(0), b = two(1), c = two(2);
        put(tab, make_float2(S * a.x + trA * b.x, S * a.y + trA * b.y));
        put(tbc, make_float2(S * c.x, S * c.y));
        put(m6, two(3));
        put(m10, two(4));
      } else {
        const float2 a = two(0), c = two(2);
        put(tab, make_float2(tab[at] + a.x, tab[at + 1] + a.y));
        put(tabT, two(1));                   // case 12, for dT_ab[e,x]
        put(tbc, make_float2(tbc[at] + c.x, tbc[at + 1] + c.y));
        put(dbc, two(3));
        put(dacT, two(4));                   // case 17, for dD_ac[e,x]
      }
    }
  }
}


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
  extern __shared__ __align__(16) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp;
  const int GLD = L.GLD, ALD = L.ALD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int c0 = blockIdx.y * sp.Cc, nc = min(sp.Cc, C - c0);
  const int o0 = blockIdx.z * L.Co, no = min(L.Co, Cout - o0);
  const int n4 = lv::round_up(no, 4) / 4;     // groups of four outputs

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  int* slots = reinterpret_cast<int*>(smem + L.islots);
  float* G = smem + L.g;
  float* GAp = smem + L.gap;
  float* GR = smem + L.gr;
  float* GA = smem + L.ga;
  float* GAx = smem + L.gax;
  float* GSx = smem + L.gsx;
  const lv::StreamBuffers s = lv::stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* dKv = smem + L.dkv;
  float* dbs = smem + L.dbs;
  float* red = smem + L.red;
  float* tab = s.map(lv::kTab, sp.mapw);
  float* tabT = s.map(lv::kTabT, sp.mapw);
  float* tbc = s.map(lv::kTbc, sp.mapw);
  float* dbc = s.map(lv::kDbc, sp.mapw);
  float* dacT = s.map(lv::kDacT, sp.mapw);
  float* m6 = s.map(lv::kM6, sp.mapw);
  float* m10 = s.map(lv::kM10, sp.mapw);

  STAGE_CLOCK_START();
  // Zero G and GAp (their padding is read), the ring and the maps, and the
  // block's accumulators; then K's rows of the chunk and the panel,
  // Ks[(k*ncp + f)*GLD + o], zero beyond nc and no.
  lv::zero_words(smem + L.g, L.words - L.g);
  __syncthreads();
#pragma unroll 3
  for (int i = tid; i < kCases * nc * no; i += nth) {
    const int o = i % no, kf = i / no, f = kf % nc, k = kf / nc;
    Ks[(k * ncp + f) * GLD + o] = risi18::to_float(
        K[(size_t)(k * C + c0 + f) * Cout + o0 + o]);
  }

  // dK's register tile: slab, four channels and eight outputs, for the row
  // quads [q0, q1) of every vertex.
  const int quads = ncp / 4, nog = (no + 7) / 8;
  const int tiles = kSlabs * quads * nog;
  // (At most eight parts: the block sums them one after another when it
  // ends, a barrier each.)
  const int parts = max(1, min(min(nth / tiles, 8), lv::round_up(PP, 4) / 4));
  const int nq = lv::round_up(PP, 4) / 4, qpp = (nq + parts - 1) / parts;
  float4 dk[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dk[i][0] = dk[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  // On the tensor cores: a warp owns 16 channels, of one slab (16-channel
  // chunks) or of two neighbours of the same half (8-channel chunks: slabs
  // 0..4 meet G, 5..9 GAp, so a half has two pairs and a single), over its
  // part of every vertex's rows, and keeps all outputs of them (dk_maps_mma).
  const int lane = tid % 32, warp = tid / 32;
  const int mtiles = ncp == 16 ? kSlabs : 6;
  const int mparts = max(1, nth / 32 / mtiles);
  const int mt = warp % mtiles, mpart = warp / mtiles;
  const int sl_lo = ncp == 16 ? mt : 5 * (mt / 3) + 2 * (mt % 3);
  const int sl_hi = ncp == 16 ? mt : (mt % 3 < 2 ? sl_lo + 1 : -1);
  const int rows_per_part = lv::round_up((PP / 8 + mparts - 1) / mparts * 8, 8);
  float dkm[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dkm[nt][i] = 0.f;

  const bool vec_scatter = C % 4 == 0 && sp.Cc % 4 == 0;
  // geff in groups of four outputs where every row of g and out allows it.
  const bool wide_g = Cout % 4 == 0 && L.Co % 4 == 0 && L.wide_g;

  STAGE(0);   // set-up and K's staging
  for (size_t v = blockIdx.x; v < (size_t)N; v += gridDim.x) {
    // 1. geff of this vertex, G[r, o] with r = x*P + y; the structure.
    //    (The barrier that ended the previous vertex's scatter ordered its
    //    reads before these writes.)
    const E* gv = gout + v * PP * Cout + o0;
    const E* ov = out + v * PP * Cout + o0;
    if (wide_g) {
#pragma unroll 4
      for (int i = tid; i < PP * (no / 4); i += nth) {
        const int r = i / (no / 4), o = 4 * (i % (no / 4));
        const float4 gi = lv::load4(gv + (size_t)r * Cout + o);
        const float4 oi = lv::load4(ov + (size_t)r * Cout + o);
        *reinterpret_cast<float4*>(G + r * GLD + o) = make_float4(
            oi.x > 0.f ? gi.x : negslope * gi.x,
            oi.y > 0.f ? gi.y : negslope * gi.y,
            oi.z > 0.f ? gi.z : negslope * gi.z,
            oi.w > 0.f ? gi.w : negslope * gi.w);
      }
    } else {
      for (int i = tid; i < PP * no; i += nth) {
        const int r = i / no, o = i % no;
        const float gi = risi18::to_float(gv[(size_t)r * Cout + o]);
        G[r * GLD + o] =
            risi18::to_float(ov[(size_t)r * Cout + o]) > 0.f ? gi
                                                             : negslope * gi;
      }
    }
    STAGE(1);   // geff
    risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal,
                        snbr, spos);
    const float S = smem[L.scal], trA = smem[L.scal + 1];
    lv::list_slots(snbr, spos, P, slots);
    STAGE(2);   // the vertex's structure
    // The first slots' copies fly while G meets the adjacency.
    lv::stream_prologue(state, snbr, spos, slots, sp, s, c0, nc);

    // GAp[x,e,:] = sum_y G[x,y,:] Ap[y,e]; GR[x,:] = sum_y G[x,y,:] R[y];
    // per x, sum_y Ap[x,y] G[x,y,:] and sum_y G[x,y,:].
    for (int item = tid; item < PP * n4; item += nth) {
      const int og = item % n4, r = item / n4, x = r / P, e = r % P;
      const float* g = G + x * P * GLD + 4 * og;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int y = 0; y < P; ++y)
        lv::fma4(acc, Ap[y * ALD + e], lv::load4(g + y * GLD));
      *reinterpret_cast<float4*>(GAp + r * GLD + 4 * og) = acc;
    }
    for (int item = tid; item < P * n4; item += nth) {
      const int og = item % n4, x = item / n4;
      const float* g = G + x * P * GLD + 4 * og;
      float4 gr = make_float4(0.f, 0.f, 0.f, 0.f), ga = gr, gs = gr;
      for (int y = 0; y < P; ++y) {
        const float4 gy = lv::load4(g + y * GLD);
        lv::fma4(gr, R[y], gy);
        lv::fma4(ga, Ap[x * ALD + y], gy);
        lv::fma4(gs, 1.f, gy);
      }
      *reinterpret_cast<float4*>(GR + x * GLD + 4 * og) = gr;
      *reinterpret_cast<float4*>(GAx + x * GLD + 4 * og) = ga;
      *reinterpret_cast<float4*>(GSx + x * GLD + 4 * og) = gs;
    }
    __syncthreads();
    for (int o = tid; o < no; o += nth) {
      float ga = 0.f, gs = 0.f;
      for (int x = 0; x < P; ++x) {
        ga += GAx[x * GLD + o];
        gs += GSx[x * GLD + o];
      }
      GA[o] = ga;                 // sum_{x,y} Ap[x,y] G[x,y,o]
      dbs[o] += gs;               // db (written by the blocks of chunk 0)
    }

    // 2. The forward's reductions of this chunk (its barriers order GAp,
    //    GR and GA before their readers).
    STAGE(3);   // the first copies' start, GAp, GR, GA
    lv::stream_reductions(state, snbr, spos, slots, R, sp, s, c0, nc);
    STAGE(4);   // the stream

    // 3. dK.  The map cases: this warp's tile on the tensor cores, or this
    //    thread's tile over its row quads.
    if constexpr (kMma) {
      if (mpart < mparts) {
        auto scale_of = [&](int sl) {
          const int kind = sl < 0 ? 0 : kSlabScale[sl];
          return sl < 0 ? 0.f : kind == 1 ? S : kind == 2 ? trA : 1.f;
        };
        const int f_hi = ncp == 16 ? 8 : 0;
        dk_maps_mma(dkm, s.map(kSlabMap[sl_lo], sp.mapw) + (lane >> 2),
                    scale_of(sl_lo),
                    s.map(kSlabMap[max(sl_hi, 0)], sp.mapw) + (lane >> 2)
                        + f_hi,
                    scale_of(sl_hi), sl_lo >= 5 ? GAp : G,
                    mpart * rows_per_part,
                    min(PP, (mpart + 1) * rows_per_part), (no + 7) / 8, ncp,
                    GLD, lane);
      }
    } else {
      const int item = tid;
      if (item < tiles * parts) {
        const int t = item % tiles, part = item / tiles;
        const int og = t % nog, sq = t / nog, q = sq % quads, sl = sq / quads;
        const float* map = s.map(kSlabMap[sl], sp.mapw) + 4 * q;
        const float* gm = (sl >= 5 ? GAp : G) + 8 * og;
        const int kind = kSlabScale[sl];
        const float scale = kind == 1 ? S : kind == 2 ? trA : 1.f;
        const int r1 = min(nq, (part + 1) * qpp) * 4;
        for (int r = part * qpp * 4; r < r1; ++r) {
          float4 m = lv::load4(map + r * ncp);
          m.x *= scale; m.y *= scale; m.z *= scale; m.w *= scale;
          const float4 g0 = lv::load4(gm + r * GLD);
          const float4 g1 = lv::load4(gm + r * GLD + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lv::fma4(dk[i][0], lv::get4(m, i), g0);
            lv::fma4(dk[i][1], lv::get4(m, i), g1);
          }
        }
      }
    }
    //    The vector cases against GR and the scalar cases against GA; each
    //    entry of dKv has one owner.
    for (int i = tid; i < 8 * nc * no; i += nth) {
      const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
      float acc;
      if (j < 4) {
        const float* vec = (j == 0 ? s.ta : j == 1 ? s.tb
                            : j == 2 ? s.tdbc : s.tdac) + f;
        acc = 0.f;
        for (int x = 0; x < P; ++x) acc += vec[x * ncp] * GR[x * GLD + o];
      } else {
        const float* sc = j == 4 ? s.tfull : j == 5 ? s.s14
                          : j == 6 ? s.s15 : s.t18;
        acc = sc[f] * GA[o];
      }
      dKv[(j * ncp + f) * GLD + o] += acc;
    }
    __syncthreads();

    STAGE(5);   // dK
    // 4. The reductions' cotangents.  (b) The vectors and scalars, written
    //    over the forward's: ta <- dT_a, tb <- dT_b, tdbc, tdac, tfull,
    //    s14, s15, t18 likewise.
    for (int item = tid; item < P * nc; item += nth) {
      const int f = item % nc, x = item / nc;
      const float* gr = GR + x * GLD;
      float s1 = 0.f, s3 = 0.f, s7 = 0.f, s10 = 0.f;
      for (int o = 0; o < no; ++o) {
        s1 += gr[o] * Ks[(1 * ncp + f) * GLD + o];
        s3 += gr[o] * Ks[(3 * ncp + f) * GLD + o];
        s7 += gr[o] * Ks[(7 * ncp + f) * GLD + o];
        s10 += gr[o] * Ks[(10 * ncp + f) * GLD + o];
      }
      s.ta[x * ncp + f] = s1; s.tb[x * ncp + f] = s3;
      s.tdbc[x * ncp + f] = s7; s.tdac[x * ncp + f] = s10;
    }
    for (int f = tid; f < nc; f += nth) {
      float s4 = 0.f, s13 = 0.f, s14 = 0.f, s17 = 0.f;
      for (int o = 0; o < no; ++o) {
        s4 += GA[o] * Ks[(4 * ncp + f) * GLD + o];
        s13 += GA[o] * Ks[(13 * ncp + f) * GLD + o];
        s14 += GA[o] * Ks[(14 * ncp + f) * GLD + o];
        s17 += GA[o] * Ks[(17 * ncp + f) * GLD + o];
      }
      s.tfull[f] = s4; s.s14[f] = s13; s.s15[f] = s14; s.t18[f] = s17;
    }
    //    (c) The maps, item (four rows rq, rq + nrq, ..., channel f): G and
    //    GAp against K's ten slabs.  The two transposed cases are written
    //    where they were computed; their readers transpose.
    if constexpr (kMma) {
      if (warp < PP / 16) {
        const int ksteps = (no + 7) / 8;
        auto halves = [&](auto& y) {
          cotangent_maps_mma(y, G, Ks, kSlabCase, 16 * warp, ksteps, ncp,
                             GLD, lane);
          store_cotangents(y, false, S, trA, tab, tabT, tbc, dbc, dacT, m6,
                           m10, 16 * warp, ncp, lane);
          cotangent_maps_mma(y, GAp, Ks, kSlabCase + 5, 16 * warp, ksteps,
                             ncp, GLD, lane);
          store_cotangents(y, true, S, trA, tab, tabT, tbc, dbc, dacT, m6,
                           m10, 16 * warp, ncp, lane);
        };
        if (ncp == 16) {
          float y[5][2][4];
          halves(y);
        } else {
          float y[5][1][4];
          halves(y);
        }
      }
    } else {
      const int nrq = (PP + 3) / 4, n4k = lv::round_up(no, 4) / 4;
      for (int item = tid; item < nrq * ncp; item += nth) {
        const int f = item % ncp, rq = item / ncp;
        int rows[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] = min(rq + i * nrq, PP - 1);
        float y[4][kSlabs];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) y[i][j] = 0.f;
        const float* kf = Ks + f * GLD;
        for (int o4 = 0; o4 < n4k; ++o4) {
          float4 g[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            g[i] = lv::load4(G + rows[i] * GLD + 4 * o4);
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const float4 k4 = lv::load4(kf + kSlabCase[j] * ncp * GLD
                                        + 4 * o4);
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i][j] += lv::dot4(g[i], k4);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            g[i] = lv::load4(GAp + rows[i] * GLD + 4 * o4);
#pragma unroll
          for (int j = 5; j < kSlabs; ++j) {
            const float4 k4 = lv::load4(kf + kSlabCase[j] * ncp * GLD
                                        + 4 * o4);
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i][j] += lv::dot4(g[i], k4);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (rq + i * nrq >= PP) continue;
          const int at = rows[i] * ncp + f;
          tab[at] = S * y[i][0] + trA * y[i][1] + y[i][5];
          tabT[at] = y[i][6];                 // case 12, for dT_ab[e,x]
          tbc[at] = S * y[i][2] + y[i][7];
          m6[at] = y[i][3];
          m10[at] = y[i][4];
          dbc[at] = y[i][8];
          dacT[at] = y[i][9];                 // case 17, for dD_ac[e,x]
        }
      }
    }
    __syncthreads();
    //    Fold the transposed case and the broadcasts in: each thread
    //    updates its own entries (tabT is only read).
    for (int item = tid; item < PP * ncp; item += nth) {
      const int f = item % ncp, r = item / ncp, a = r / P, b = r % P;
      const bool diag = a == b;
      tab[item] += tabT[(b * P + a) * ncp + f] + s.ta[a * ncp + f]
                   + s.tfull[f] + (diag ? s.s14[f] : 0.f);
      tbc[item] += s.tb[a * ncp + f];           // r = (b, c): row b
      dbc[item] += s.tdbc[a * ncp + f] + s.s15[f] + (diag ? s.t18[f] : 0.f);
      dacT[item] += s.tdac[a * ncp + f];        // r = (b, a): row b
    }
    __syncthreads();

    STAGE(6);   // the cotangents
    // 5. Scatter, item (listed slot a, column c, four channels), over the
    //    rows b:
    //    dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
    //              + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].
    for (int item = tid; item < slots[P] * P * quads; item += nth) {
      const int q = item % quads, ic = item / quads, c = ic % P;
      const int a = slots[ic / P], n = snbr[a], p2 = spos[a * P + c];
      if (p2 < 0 || 4 * q >= nc) continue;
      const float ra = R[a], rc = R[c];
      float* base = dstate + ((size_t)n * PP + p2) * C + c0 + 4 * q;
      for (int b = 0; b < P; ++b) {
        const int p1 = spos[a * P + b];
        if (p1 < 0) continue;
        const int ab = (a * P + b) * ncp + 4 * q;
        const int bc = (b * P + c) * ncp + 4 * q;
        float4 val = lv::load4(tab + ab);
        const float4 fbc = lv::load4(tbc + bc);
        val.x += fbc.x; val.y += fbc.y; val.z += fbc.z; val.w += fbc.w;
        lv::fma4(val, rc, lv::load4(m6 + ab));
        lv::fma4(val, ra, lv::load4(m10 + bc));
        if (c == b) lv::fma4(val, 1.f, lv::load4(dbc + ab));
        if (c == a)
          lv::fma4(val, 1.f, lv::load4(dacT + (b * P + a) * ncp + 4 * q));
        float* at = base + (size_t)p1 * P * C;
        if (vec_scatter) {
          atomicAdd(reinterpret_cast<float4*>(at), val);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * q + i < nc) atomicAdd(at + i, lv::get4(val, i));
        }
      }
    }
    __syncthreads();
    STAGE(7);   // the scatter
  }

  // The block's partial row: the k-parts of the map cases summed in order,
  // then every case's rows of this chunk and panel, and db.
  if constexpr (kMma) {
    const int g = lane >> 2, t = lane & 3;
    for (int p = 0; p < mparts; ++p) {
      if (mpart == p) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (8 * nt >= no) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int sl = h ? sl_hi : sl_lo;
            if (sl < 0) continue;
            const int f = ncp == 16 ? g + 8 * h : g;
            float* at = red + (sl * ncp + f) * GLD + 8 * nt + 2 * t;
            at[0] += dkm[nt][2 * h];
            at[1] += dkm[nt][2 * h + 1];
          }
        }
      }
      __syncthreads();
    }
  } else {
    const int item = tid;
    const bool active = item < tiles * parts;
    const int t = item % tiles, part = item / tiles;
    const int og = t % nog, sq = t / nog, q = sq % quads, sl = sq / quads;
    for (int p = 0; p < parts; ++p) {
      if (active && part == p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* at = red + (sl * ncp + 4 * q + i) * GLD + 8 * og;
          const float4 a0 = lv::load4(at), a1 = lv::load4(at + 4);
          *reinterpret_cast<float4*>(at) = make_float4(
              a0.x + dk[i][0].x, a0.y + dk[i][0].y, a0.z + dk[i][0].z,
              a0.w + dk[i][0].w);
          *reinterpret_cast<float4*>(at + 4) = make_float4(
              a1.x + dk[i][1].x, a1.y + dk[i][1].y, a1.z + dk[i][1].z,
              a1.w + dk[i][1].w);
        }
      }
      __syncthreads();
    }
  }
  const size_t nK = (size_t)kCases * C * Cout;
  float* part_row = partial + blockIdx.x * (nK + Cout);
  for (int i = tid; i < kSlabs * nc * no; i += nth) {
    const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
    part_row[(size_t)(kSlabCase[j] * C + c0 + f) * Cout + o0 + o] =
        red[(j * ncp + f) * GLD + o];
  }
  for (int i = tid; i < 8 * nc * no; i += nth) {
    const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
    part_row[(size_t)(kVectorCase[j] * C + c0 + f) * Cout + o0 + o] =
        dKv[(j * ncp + f) * GLD + o];
  }
  if (blockIdx.y == 0)
    for (int o = tid; o < no; o += nth) part_row[nK + o0 + o] = dbs[o];
  STAGE(8);   // the partial row
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

// Number of vertex groups (partial rows) for N vertices.
int vertex_groups(int N) { return N < kGroups ? (N > 0 ? N : 0) : kGroups; }

// The bytes a pointer is aligned to, up to 16.
int alignment_of(const void* p) {
  const size_t a = (size_t)p;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

// Kernel 1 for element type E; returns a cudaError_t.
template <typename E>
int launch_backward(const void* state, const void* nbr, const void* pos,
                    const void* radj, const void* K, const void* g,
                    const void* out, void* dstate, void* partial, int N,
                    int P, int C, int Cout, float negslope, int nblocks,
                    void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  // The stream indexes the state's [N,P,P] elements with an int.
  if ((long long)N * P * P >= (1LL << 31)) return cudaErrorInvalidValue;
  if (nblocks != vertex_groups(N)) return cudaErrorInvalidValue;
  BackwardPlan L = choose_backward_plan(P, C, Cout, (int)sizeof(E),
                                        alignment_of(state));
  if (L.words == 0) return cudaErrorInvalidValue;
  L.wide_g = alignment_of(g) == 16 && alignment_of(out) == 16;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  auto kernel = L.mma ? risi18_level_bwd_kernel<E, true>
                      : risi18_level_bwd_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblocks, (C + L.sp.Cc - 1) / L.sp.Cc,
                  (Cout + L.Co - 1) / L.Co);
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
          (const E*)state, (const int*)nbr, (const int*)pos,
          (const float*)radj, (const E*)K, (const E*)g, (const E*)out,
          (float*)dstate, (float*)partial, N, L, negslope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of partial rows (vertex groups of kernel 1) for N vertices.
int risi18_level_backward_blocks(int N) { return vertex_groups(N); }

// Kernel 1 on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C], nbr [N,P] i32, pos [N,P,P] i32, radj [N,P,P] f32,
// K [18C,Cout], g and out [N,P*P,Cout] -> adds into dstate [N,P,P,C] f32
// (zeroed by the caller) and writes partial [nblocks, 18C*Cout + Cout] f32,
// all contiguous; nblocks = risi18_level_backward_blocks(N).  State, K, g
// and out are float32 (_f32) or bfloat16 (_bf16); dstate is float32 in both
// (in bfloat16 it is the buffer that risi18_level_backward_finish_bf16
// rounds).
int risi18_level_backward_f32(const void* state, const void* nbr,
                              const void* pos, const void* radj,
                              const void* K, const void* g, const void* out,
                              void* dstate, void* partial, int N, int P,
                              int C, int Cout, float negslope, int nblocks,
                              void* stream) {
  return launch_backward<float>(state, nbr, pos, radj, K, g, out, dstate,
                                partial, N, P, C, Cout, negslope, nblocks,
                                stream);
}

int risi18_level_backward_bf16(const void* state, const void* nbr,
                               const void* pos, const void* radj,
                               const void* K, const void* g, const void* out,
                               void* dstate, void* partial, int N, int P,
                               int C, int Cout, float negslope, int nblocks,
                               void* stream) {
  return launch_backward<__nv_bfloat16>(state, nbr, pos, radj, K, g, out,
                                        dstate, partial, N, P, C, Cout,
                                        negslope, nblocks, stream);
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
// (a chunk of one, the shallowest ring, the narrowest panel of outputs).
long long risi18_level_backward_min_smem_bytes(int P, int Cout) {
  const int Co = Cout < 4 ? Cout : 4;
  return (long long)sizeof(float) *
         make_backward_plan(P, 1, Cout, 1, 2, Co, (int)sizeof(float), 16,
                            false).words;
}

#ifdef RISI18_STAGE_CLOCK
// The stage clock's 16 sums of cycles, zeroed after the copy.
int risi18_level_backward_stage_cycles(long long* host) {
  return risi18::level::read_stage_cycles(host);
}
#endif

const char* risi18_level_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
