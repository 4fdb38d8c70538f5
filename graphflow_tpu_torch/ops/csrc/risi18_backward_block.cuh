// The block of the backward kernels' first kernel: the level's backward
// (risi18_level_bwd.cu, K2 kernel 1) and the bank's (risi18_bank_bwd.cu, K5
// kernel 1).  One block of 512 threads per (vertex group, channel chunk,
// output panel), one block an SM; the design and its algebra are described
// in risi18_level_bwd.cu.  K2 streams its slots gathered from the state,
// takes G from the cotangent through LeakyReLU', sums db and scatters dT
// into dstate with atomics; K5 streams them from T, takes G as the
// cotangent itself and writes dT, which each vertex owns, once per element.
// backward_block_cluster (K2, K5) and backward_block_tiled (where a
// cluster plan would be one block on the CUDA cores) are the same function
// for a field whose G and maps do not fit one block, in row tiles: a
// vertex's tiles spread over a cluster, or one block a vertex group.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "risi18_level_common.cuh"

namespace risi18 {
namespace level {

// Four float32 values into four consecutive elements (16 bytes for float32,
// 8 for bfloat16, aligned so), as streaming stores (evict first): K5's dT
// is written once and read by nothing the kernel runs after it, and with
// plain stores its 134 MB (float32) pushed out of L2 the lines of T and G
// that the next slots and vertices read; the dT phase then took a third of
// a block (0.499 against 0.414 ms at N=256, P=16, C=Cout=32).
__device__ inline void store4(float* p, const float4& v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ inline void store4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), raw);
}

constexpr int kGroups = 132;     // vertex groups: partial rows of dK (and db)
constexpr int kSlabs = 10;       // dK's map cases, cases 1 and 7 apart

// Number of vertex groups (partial rows) for N vertices.
inline int vertex_groups(int N) {
  return N < kGroups ? (N > 0 ? N : 0) : kGroups;
}

// How a backward block's dT reaches its destination (BackwardPlan::scatter).
enum { kScatterAtomic = 0, kScatterTmaReduce = 1, kScatterStore = 2 };
constexpr int kStageBufs = 2;   // staging buffers a warp, at most
constexpr int kMaxColumnWords = 5;   // 32-column words of a slot: P <= 160

// A backward block's shared memory, offsets in 4-byte words.
struct BackwardPlan {
  StreamPlan sp;
  int Cout;
  int Co;      // output channels of one block's panel
  int GLD;     // row stride of G, GAp, GR, GA, K's rows and the dK buffers
  int mma;     // 1: dK's map cases and the maps' cotangents run on the
               // tensor cores (dk_maps_mma, cotangent_maps_mma)
  int wide_g;  // g and out (K2) or g and dT (K5) start at multiples of 16
               // bytes
  int ALD;     // P + 1
  int tiled;   // 1: a vertex is walked in row tiles of sp.rows rows
               // (backward_block_tiled, backward_block_cluster)
  int cluster; // blocks a cluster of the cluster plan (K2's and K5's row
               // tiles, backward_block_cluster), 0 for one block a vertex
               // group
  int tiles_per_block;  // the row tiles one block of the cluster takes
  int ring;    // -1: the ring lies in the stream area; else its offset
               // over G and GAp (a cluster plan whose ring holds several
               // pieces and fits there: backward_block_cluster forms G
               // and GAp of a tile after its stream)
  int lists;   // -1: the tensor-copy route's piece list and weights
               // (producer_words) lie in the stream area, or there is no
               // such route; else their offset over G and GAp, after the
               // ring where it lies there
  int scatter; // how dT reaches its destination: kScatterAtomic (K2:
               // float32 atomics into dstate), kScatterTmaReduce (K2 on a
               // cluster plan: rows staged in storage order, each added by
               // one tensor reduce; dT_stage_rows) or kScatterStore (K5:
               // dT written)
  int sbufs;   // kScatterTmaReduce: staging buffers a warp (1 or 2)
  int srow;    // kScatterTmaReduce: words of a staging buffer (a row of P
               // cells of ncp channels, 128-byte aligned)
  int stage;   // kScatterTmaReduce: offset of the warps' staging buffers
               // over G and GAp, then the slots' columns' cells (P * P
               // 16-bit words: scatter_cells)
  int ap, r, scal, inbr, ipos, islots, bars, g, gap, gr, ga, gax, gsx,
      stream, ks, dkv, dbs, red, sacc, part, words;
};

// `wide`: on the tensor cores, whether the rows of G, GAp and K lie eight
// words further apart than the panel (no bank conflicts) or four.
// `gather`: the block gathers its slots and scatters dstate (K2), and keeps
// the vertex's neighbour ids, positions, listed slots and db's sums; else
// (K5) they take no room.
// `rows`: the rows of a row tile (a tiled plan), 0 for none.  `cluster`:
// a row-tiled plan for backward_block_cluster (K2, K5), whose dK map cases
// run on the tensor cores where the plan allows, its cluster sized for N
// vertices (cluster_shape: the grid is vertex groups x chunks x
// panels); else backward_block_tiled's, on the CUDA cores.
inline BackwardPlan make_backward_plan(int P, int C, int Cout, int Cc, int D,
                                       int Co, int es, int aligned, bool wide,
                                       bool gather, int rows = 0, int G = 1,
                                       bool cluster = false, int N = 0) {
  BackwardPlan L;
  if (rows > 0 && cluster) rows = balanced_rows(P, rows);
  L.sp = make_stream_plan(P, C, Cc, D, es, aligned, rows, G,
                          gather && cluster);
  L.Cout = Cout; L.Co = Co; L.ALD = P + 1; L.wide_g = 0;
  L.tiled = rows > 0;
  const int tiles = (P + L.sp.rows - 1) / L.sp.rows;
  const ClusterShape cs = cluster_shape(
      tiles, vertex_groups(N) * ((C + Cc - 1) / Cc) * ((Cout + Co - 1) / Co));
  L.cluster = L.tiled && cluster ? cs.blocks : 0;
  L.tiles_per_block = L.cluster ? cs.per : 1;
  // The tensor cores take chunks of 8 or 16 channels, 16-row tiles of the
  // maps, a warp a tile, and the panel's outputs eight at a time; dK's map
  // cases of a cluster plan's row tile take its rows eight at a time.
  const int Co4 = round_up(Co, 4);
  L.mma = (L.sp.ncp == 8 || L.sp.ncp == 16) && Co4 % 8 == 0 && Co4 <= 32 &&
          ((!L.tiled && (P * P) % 16 == 0 && P * P / 16 <= kThreads / 32) ||
           (L.cluster && (L.sp.rows * P) % 8 == 0));
  // Four more than the panel: rows a multiple of 4 words apart fall on
  // different banks, and an 8-wide tile may read past an odd group of four.
  // Eight more for the tensor cores, whose lanes read two words of each of
  // four rows, or one word of each of four rows eight lanes wide; four,
  // with some conflicts, where that buys a larger chunk.
  L.GLD = Co4 + (L.mma && wide ? 8 : 4);
  const int grows = round_up(L.sp.rows * P, 4);
  int w = 0;
  auto take = [&w](int n) { int at = w; w += round_up(n, 4); return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.inbr = take(gather ? P : 0);
  L.ipos = take(gather ? P * P : 0);
  L.islots = take(gather ? P + 1 : 0);
  L.bars = take(barrier_words(L.sp));
  // The ring lies over G or leads the stream area: either aligned for the
  // tensor copies.
  const int align = L.sp.tma ? kTmaAlign / 4 : 4;
  w = round_up(w, align);
  L.g = take(grows * L.GLD);
  L.gap = take(grows * L.GLD);
  L.gr = take(L.sp.rows * L.GLD);
  L.ga = take(L.GLD);
  L.gax = take(L.tiled ? 0 : P * L.GLD);
  L.gsx = take(gather && !L.tiled ? P * L.GLD : 0);
  // A cluster plan's ring lies over G and GAp where it holds several
  // pieces (a tile's cells in registers: tile_regs), or takes the tensor
  // copies, and fits there.  (With the copies' one piece a stage of tiles
  // of 8 rows it freed the room for a cluster of one on the tensor cores:
  // K2 kernel 1 at (64,64,16,8) 3.54 → 1.09 ms in float32, where the ring
  // in the stream area had left the one-block row-tiled block; an H100,
  // PERF.md.)
  const bool over_g = L.cluster && (pieces(L.sp) > 1 || L.sp.tma) &&
                      ring_words(L.sp) <= L.gr - L.g;
  // So do the tensor-copy route's piece list and weights where they fit
  // beside it (K2 at P = 40 in bfloat16 keeps its plan of one block a
  // cluster so).
  const int after_ring = over_g ? ring_words(L.sp) : 0;
  const bool lists_over_g = L.cluster && producer_words(L.sp) > 0 &&
                            producer_words(L.sp) <= L.gr - L.g - after_ring;
  if (!over_g) w = round_up(w, align);
  L.stream = take(stream_words(L.sp) - after_ring -
                  (lists_over_g ? producer_words(L.sp) : 0));
  L.ring = over_g ? L.g : -1;
  L.lists = lists_over_g ? L.g + after_ring : -1;
  L.ks = take(kCases * L.sp.ncp * L.GLD);
  L.dkv = take(8 * L.sp.ncp * L.GLD);
  L.dbs = take(gather ? L.GLD : 0);
  L.red = take(kSlabs * L.sp.ncp * L.GLD);
  L.sacc = take(L.tiled ? 4 * L.sp.ncp : 0);
  // (A cluster plan's block takes GA and db's sums from kernel 0, not from
  // parts here; it keeps its dT pass's parameters in these words.)
  L.part = take(L.tiled ? kTilePartWords : 0);
  // K2's scatter on a cluster plan: every warp stages rows of dT in
  // storage order, beside the slots' columns' cells (scatter_cells), over G
  // and GAp, which the dT pass does not read (it reads G from kernel 0's
  // scratch and the cotangent), and a tensor reduce adds a staged row into
  // the float32 dstate seen as [N*P*P, C], whose rows of C channels must be
  // a multiple of 16 bytes.  Where it gains (dT_stage_rows): a row tile of
  // at most kThreads / 64 rows, so that at least two warps share a row b's
  // slots, and cells of at least 8 channels (a reduce's 32-byte sector
  // whole); and where G and GAp hold a buffer a warp.  Else the atomics.
  // (On an H100, K2 kernels 0 and 1 staged against atomics: tiles of 4 and
  // 8 rows in chunks of 8 channels 0.92-0.99 of the time, tiles of 13 and
  // 14 rows 1.04-1.07, chunks of 4 channels 1.03; the untiled block staged
  // over its stream's ring, its rows of 16 cells paying a row's issue for
  // little work, 1.15 at (256,16,32,32).  PERF.md.)
  L.scatter = gather ? kScatterAtomic : kScatterStore;
  L.sbufs = 0; L.srow = 0; L.stage = -1;
  if (gather && L.cluster && C % 4 == 0 && L.sp.ncp >= 8 &&
      L.sp.rows <= kThreads / 64 && P <= 32 * kMaxColumnWords) {
    const int warps = kThreads / 32, cells = round_up((P * P + 1) / 2, 4);
    const int srow = round_up(P * L.sp.ncp, kTmaAlign / 4);
    const int at = round_up(L.g, kTmaAlign / 4);
    const int bufs = (L.gr - at - cells) / (srow * warps);
    if (bufs >= 1) {
      L.scatter = kScatterTmaReduce;
      L.sbufs = bufs < kStageBufs ? bufs : kStageBufs;
      L.srow = srow;
      L.stage = at;
    }
  }
  L.words = w;
  return L;
}

// The plan that fits one block with the widest panel, then the largest
// chunk, then the deepest ring, then the wide rows.  The stream's wide
// plans, for fields of more than 32 rows, go through the row-tiled block:
// where no plan keeps the maps of every row with a stream in registers, a
// row-tiled one with the widest panel, then the most rows a tile (all P
// first: one tile, the stream in shared memory), then the largest chunk,
// the most pieces a ring buffer and the deepest ring.  words == 0 if none
// fits.  Without `gather` (K5) the
// panel is all of Cout: a chunk's dT needs every output's cotangents, and
// it is written once, without atomics.  With `cluster` (K2, K5) the
// row-tiled plan is a cluster plan (backward_block_cluster) for N vertices,
// one whose tiles keep their cells in registers (tile_regs) first, and the
// rows of G, GAp and K eight words further apart than the panel before four
// where its dK runs on the tensor cores; every plan that fits without it
// fits with it.  A cluster plan of one block with dK on the CUDA cores has
// nothing over the row-tiled block of one block a vertex group but the
// cluster's meetings, and measured slower on an H100 at P = 40 (K2 kernel 1
// by 1.5-4 %, K5 kernel 1 by 12-17 %: PERF.md); there the row-tiled plan
// is taken instead.
inline BackwardPlan choose_backward_plan(int P, int C, int Cout, int es,
                                         int aligned, bool gather,
                                         bool cluster = false, int N = 0) {
  // Every dK tile (slab, four channels, eight outputs) needs a thread.
  auto dk_tiles_fit = [](const BackwardPlan& L, int Co) {
    return kSlabs * (L.sp.ncp / 4) * ((Co + 7) / 8) <= kThreads;
  };
  for (int Co = Cout;; Co = round_up((Co + 1) / 2, 4)) {
    for (int Cc : {kMaxChunk, 8, 4}) {
      Cc = Cc < C ? Cc : C;
      for (int D = 4; D >= 2; --D) {
        for (bool wide : {true, false}) {
          const BackwardPlan L = make_backward_plan(P, C, Cout, Cc, D, Co,
                                                    es, aligned, wide,
                                                    gather);
          if (dk_tiles_fit(L, Co) && !L.sp.wide &&
              sizeof(float) * (size_t)L.words <= risi18::kMaxSmemBytes)
            return L;
        }
      }
    }
    if (Co <= 4 || !gather) break;
  }
  auto tiled = [&](bool clustered) {
    for (int regs = clustered ? 1 : 0; regs >= 0; --regs) {
      for (int Co = Cout;; Co = round_up((Co + 1) / 2, 4)) {
        for (int k = -1; k < 6; ++k) {
          const int rows = k < 0 ? P : kTileRows[k];
          if (rows > P || (k >= 0 && rows == P)) continue;
          for (int Cc : {kMaxChunk, 8, 4}) {
            Cc = Cc < C ? Cc : C;
            for (int G = kThreads / 32; G >= 1; G /= 2) {
              for (int D = 4; D >= 2; --D) {
                for (bool wide : {true, false}) {
                  if (wide && !clustered) continue;
                  const BackwardPlan L = make_backward_plan(
                      P, C, Cout, Cc, D, Co, es, aligned, wide, gather, rows,
                      G, clustered, N);
                  if ((!regs || (tile_regs(L.sp) && !L.sp.no_producer)) &&
                      dk_tiles_fit(L, Co) &&
                      sizeof(float) * (size_t)L.words <=
                          risi18::kMaxSmemBytes)
                    return L;
                }
              }
            }
          }
        }
        if (Co <= 4 || !gather) break;
      }
    }
    BackwardPlan none{};
    return none;
  };
  const BackwardPlan L = tiled(cluster);
  if (!cluster || (L.words && (L.cluster > 1 || L.mma))) return L;
  const BackwardPlan one = tiled(false);
  return one.words ? one : L;
}

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs that
// the kernel takes) in row tiles of one row.
inline long long min_backward_smem_bytes(int P, int Cout, bool gather) {
  const int Co = Cout < 4 || !gather ? Cout : 4;
  return (long long)sizeof(float) *
         make_backward_plan(P, 1, Cout, 1, 2, Co, (int)sizeof(float), 16,
                            false, gather, 1).words;
}

// dK's map slabs: the map, whether it meets GAp (else G), its per-vertex
// scale (0: one, 1: S, 2: trA) and K's 0-based case.
__constant__ int kSlabMap[kSlabs] = {kTab, kTab, kTbc, kM6,
                                     kM10, kTab, kTabT, kTbc,
                                     kDbc, kDacT};
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
// takes three passes (mma_3xtf32), which keeps float32's accuracy.
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
    split_tf32(lo_scale * lo_map[at], ah[0], al[0]);
    split_tf32(hi_scale * hi_map[at], ah[1], al[1]);
    split_tf32(lo_scale * lo_map[at + 4 * ncp], ah[2], al[2]);
    split_tf32(hi_scale * hi_map[at + 4 * ncp], ah[3], al[3]);
    const float* gm = Gm + (r0 + t) * GLD + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < nnt) {
        unsigned bh[2], bl[2];
        split_tf32(gm[8 * nt], bh[0], bl[0]);
        split_tf32(gm[4 * GLD + 8 * nt], bh[1], bl[1]);
        mma_3xtf32(dk[nt], ah, al, bh, bl);
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
    split_tf32(top.x, ah[0], al[0]);
    split_tf32(bottom.x, ah[1], al[1]);
    split_tf32(top.y, ah[2], al[2]);
    split_tf32(bottom.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Ks + (cases[j] * ncp + 8 * nt + g) * GLD + 8 * ks + 2 * t);
        unsigned bh[2], bl[2];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        mma_3xtf32(y[j][nt], ah, al, bh, bl);
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


// One backward block: vertex group blockIdx.x, channel chunk blockIdx.y,
// output panel blockIdx.z (K2); vertex group blockIdx.y, channel chunk
// blockIdx.x (K5: blocks are started x first, so the chunks of one group
// run side by side and their 32-byte pieces of T's and dT's rows meet in
// L2, where whole rows go to device memory).  E is the type of the slots'
// source, K, gout and out.  kMma: the plan's `mma`.  kGather: the level's
// backward (K2 kernel 1): `in` is the state [N,P,P,C] with nbr and pos,
// G = gout times LeakyReLU'(out), db's sums go into the partial row, and dT
// is scattered into the float32 dstate `dst` [N,P,P,C] with atomics.  Else
// the bank's (K5 kernel 1): `in` is T [N,P,P,P,C], G = gout, out, nbr and
// pos are not read, and dT is written into `dst` [N,P,P,P,C] (E), each
// element once.
// partial: [vertex groups, 18C*Cout (+ Cout with db)] float32.
template <typename E, bool kMma, bool kGather>
__device__ __forceinline__ void backward_block(
    const E* __restrict__ in, const int* __restrict__ nbr,
    const int* __restrict__ pos, const float* __restrict__ radj,
    const E* __restrict__ K, const E* __restrict__ gout,
    const E* __restrict__ out,
    std::conditional_t<kGather, float, E>* __restrict__ dst,
    float* __restrict__ partial, int N, const BackwardPlan& L,
    float negslope) {
  extern __shared__ __align__(128) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp;
  const int GLD = L.GLD, ALD = L.ALD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  // The vertex group, the number of groups and the channel chunk, read
  // where they are used.
  auto group = [] { return kGather ? blockIdx.x : blockIdx.y; };
  auto groups = [] { return kGather ? gridDim.x : gridDim.y; };
  auto chunk = [] { return kGather ? blockIdx.y : blockIdx.x; };
  const int c0 = chunk() * sp.Cc, nc = min(sp.Cc, C - c0);
  const int o0 = blockIdx.z * L.Co, no = min(L.Co, Cout - o0);
  const int n4 = round_up(no, 4) / 4;     // groups of four outputs

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
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* dKv = smem + L.dkv;
  float* dbs = smem + L.dbs;
  float* red = smem + L.red;
  float* tab = s.map(kTab, sp.mapw);
  float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m6 = s.map(kM6, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);

  STAGE_CLOCK_START();
  // Zero G and GAp (their padding is read), the ring and the maps, and the
  // block's accumulators; then K's rows of the chunk and the panel,
  // Ks[(k*ncp + f)*GLD + o], zero beyond nc and no.
  zero_words(smem + L.g, L.words - L.g);
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
  const int parts = max(1, min(min(nth / tiles, 8), round_up(PP, 4) / 4));
  const int nq = round_up(PP, 4) / 4, qpp = (nq + parts - 1) / parts;
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
  const int rows_per_part = round_up((PP / 8 + mparts - 1) / mparts * 8, 8);
  float dkm[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dkm[nt][i] = 0.f;

  // Four channels of one element in one access (a float4 atomic in K2, a
  // store of four in K5).
  const bool vec_scatter = C % 4 == 0 && sp.Cc % 4 == 0 && (kGather ||
                                                            L.wide_g);
  // geff in groups of four outputs where every row of g and out allows it.
  const bool wide_g = Cout % 4 == 0 && L.Co % 4 == 0 && L.wide_g;
  const size_t vT = (size_t)PP * P * C;      // elements of one vertex's T

  STAGE(0);   // set-up and K's staging
  for (size_t v = group(); v < (size_t)N; v += groups()) {
    // 1. geff of this vertex (G = g itself in the bank's), G[r, o] with
    //    r = x*P + y; the structure.  (The barrier that ended the previous
    //    vertex's scatter ordered its reads before these writes.)
    const E* gv = gout + v * PP * Cout + o0;
    const E* ov = out + v * PP * Cout + o0;
    if constexpr (!kGather) {
      if (wide_g) {
#pragma unroll 4
        for (int i = tid; i < PP * (no / 4); i += nth) {
          const int r = i / (no / 4), o = 4 * (i % (no / 4));
          *reinterpret_cast<float4*>(G + r * GLD + o) =
              load4(gv + (size_t)r * Cout + o);
        }
      } else {
        for (int i = tid; i < PP * no; i += nth) {
          const int r = i / no, o = i % no;
          G[r * GLD + o] = risi18::to_float(gv[(size_t)r * Cout + o]);
        }
      }
    } else if (wide_g) {
#pragma unroll 4
      for (int i = tid; i < PP * (no / 4); i += nth) {
        const int r = i / (no / 4), o = 4 * (i % (no / 4));
        const float4 gi = load4(gv + (size_t)r * Cout + o);
        const float4 oi = load4(ov + (size_t)r * Cout + o);
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
    if constexpr (kGather) {
      risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R,
                          smem + L.scal, snbr, spos);
    } else {
      risi18::load_adjacency(radj, v, P, ALD, Ap, R, smem + L.scal);
    }
    const float S = smem[L.scal], trA = smem[L.scal + 1];
    if constexpr (kGather) list_slots(snbr, spos, P, slots);
    const auto src = [&] {
      if constexpr (kGather)
        return GatheredSlots<E>{in, snbr, spos, slots};
      else
        return StoredSlots<E>{in + v * vT};
    }();
    STAGE(2);   // the vertex's structure
    // The first slots' copies fly while G meets the adjacency.
    stream_prologue(src, sp, s, c0, nc);

    // GAp[x,e,:] = sum_y G[x,y,:] Ap[y,e]; GR[x,:] = sum_y G[x,y,:] R[y];
    // per x, sum_y Ap[x,y] G[x,y,:] and sum_y G[x,y,:].
    for (int item = tid; item < PP * n4; item += nth) {
      const int og = item % n4, r = item / n4, x = r / P, e = r % P;
      const float* g = G + x * P * GLD + 4 * og;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int y = 0; y < P; ++y)
        fma4(acc, Ap[y * ALD + e], load4(g + y * GLD));
      *reinterpret_cast<float4*>(GAp + r * GLD + 4 * og) = acc;
    }
    for (int item = tid; item < P * n4; item += nth) {
      const int og = item % n4, x = item / n4;
      const float* g = G + x * P * GLD + 4 * og;
      float4 gr = make_float4(0.f, 0.f, 0.f, 0.f), ga = gr, gs = gr;
      for (int y = 0; y < P; ++y) {
        const float4 gy = load4(g + y * GLD);
        fma4(gr, R[y], gy);
        fma4(ga, Ap[x * ALD + y], gy);
        if constexpr (kGather) fma4(gs, 1.f, gy);
      }
      *reinterpret_cast<float4*>(GR + x * GLD + 4 * og) = gr;
      *reinterpret_cast<float4*>(GAx + x * GLD + 4 * og) = ga;
      if constexpr (kGather)
        *reinterpret_cast<float4*>(GSx + x * GLD + 4 * og) = gs;
    }
    __syncthreads();
    for (int o = tid; o < no; o += nth) {
      float ga = 0.f, gs = 0.f;
      for (int x = 0; x < P; ++x) {
        ga += GAx[x * GLD + o];
        if constexpr (kGather) gs += GSx[x * GLD + o];
      }
      GA[o] = ga;                 // sum_{x,y} Ap[x,y] G[x,y,o]
      if constexpr (kGather)
        dbs[o] += gs;             // db (written by the blocks of chunk 0)
    }

    // 2. The forward's reductions of this chunk (its barriers order GAp,
    //    GR and GA before their readers).
    STAGE(3);   // the first copies' start, GAp, GR, GA
    stream_reductions(src, R, sp, s, c0, nc);
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
          float4 m = load4(map + r * ncp);
          m.x *= scale; m.y *= scale; m.z *= scale; m.w *= scale;
          const float4 g0 = load4(gm + r * GLD);
          const float4 g1 = load4(gm + r * GLD + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(dk[i][0], get4(m, i), g0);
            fma4(dk[i][1], get4(m, i), g1);
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
      const int nrq = (PP + 3) / 4, n4k = round_up(no, 4) / 4;
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
            g[i] = load4(G + rows[i] * GLD + 4 * o4);
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const float4 k4 = load4(kf + kSlabCase[j] * ncp * GLD
                                        + 4 * o4);
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i][j] += dot4(g[i], k4);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            g[i] = load4(GAp + rows[i] * GLD + 4 * o4);
#pragma unroll
          for (int j = 5; j < kSlabs; ++j) {
            const float4 k4 = load4(kf + kSlabCase[j] * ncp * GLD
                                        + 4 * o4);
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i][j] += dot4(g[i], k4);
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
    if constexpr (kGather) {
      // 5. Scatter, item (listed slot a, column c, four channels), over the
      //    rows b:
      //    dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
      //              + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].
      for (int item = tid; item < slots[P] * P * quads; item += nth) {
        const int q = item % quads, ic = item / quads, c = ic % P;
        const int a = slots[ic / P], n = snbr[a], p2 = spos[a * P + c];
        if (p2 < 0 || 4 * q >= nc) continue;
        const float ra = R[a], rc = R[c];
        float* base = dst + ((size_t)n * PP + p2) * C + c0 + 4 * q;
        for (int b = 0; b < P; ++b) {
          const int p1 = spos[a * P + b];
          if (p1 < 0) continue;
          const int ab = (a * P + b) * ncp + 4 * q;
          const int bc = (b * P + c) * ncp + 4 * q;
          float4 val = load4(tab + ab);
          const float4 fbc = load4(tbc + bc);
          val.x += fbc.x; val.y += fbc.y; val.z += fbc.z; val.w += fbc.w;
          fma4(val, rc, load4(m6 + ab));
          fma4(val, ra, load4(m10 + bc));
          if (c == b) fma4(val, 1.f, load4(dbc + ab));
          if (c == a)
            fma4(val, 1.f, load4(dacT + (b * P + a) * ncp + 4 * q));
          float* at = base + (size_t)p1 * P * C;
          if (vec_scatter) {
            atomicAdd(reinterpret_cast<float4*>(at), val);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (4 * q + i < nc) atomicAdd(at + i, get4(val, i));
          }
        }
      }
    } else {
      // 5. dT of this chunk, item (a, b, c, four channels), the same sum:
      //    each element of the vertex's dT has one owner and is written
      //    once, rounded to E once.
      E* dTv = dst + v * vT + c0;
      for (int item = tid; item < PP * P * quads; item += nth) {
        const int q = item % quads, abc = item / quads, c = abc % P;
        const int a = abc / PP, b = (abc / P) % P;
        if (4 * q >= nc) continue;
        const int ab = (a * P + b) * ncp + 4 * q;
        const int bc = (b * P + c) * ncp + 4 * q;
        float4 val = load4(tab + ab);
        const float4 fbc = load4(tbc + bc);
        val.x += fbc.x; val.y += fbc.y; val.z += fbc.z; val.w += fbc.w;
        fma4(val, R[c], load4(m6 + ab));
        fma4(val, R[a], load4(m10 + bc));
        if (c == b) fma4(val, 1.f, load4(dbc + ab));
        if (c == a) fma4(val, 1.f, load4(dacT + (b * P + a) * ncp + 4 * q));
        E* at = dTv + (size_t)abc * C + 4 * q;
        if (vec_scatter) {
          store4(at, val);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * q + i < nc) risi18::store_value(at + i, get4(val, i));
        }
      }
    }
    __syncthreads();
    STAGE(7);   // the scatter (K2) or dT (K5)
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
          const float4 a0 = load4(at), a1 = load4(at + 4);
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
  float* part_row = partial + group() * (nK + (kGather ? Cout : 0));
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
  if (kGather && chunk() == 0)
    for (int o = tid; o < no; o += nth) part_row[nK + o0 + o] = dbs[o];
  STAGE(8);   // the partial row
}

// geff of the rows [r0, r0 + nr) of a vertex's panel (K2: g through
// LeakyReLU' of out; K5: g itself) into G[(r - r0)*GLD + o]; gv and ov
// point at the vertex's panel.  No barrier.
template <typename E, bool kGather>
__device__ inline void load_geff_rows(const E* __restrict__ gv,
                                      const E* __restrict__ ov, int r0,
                                      int nr, float* G, int GLD, int no,
                                      int Cout, bool wide_g, float negslope) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (wide_g) {
    const int n4 = no / 4;
    for (int i = tid; i < nr * n4; i += nth) {
      const int r = i / n4, o = 4 * (i % n4);
      const size_t at = (size_t)(r0 + r) * Cout + o;
      float4 gi = load4(gv + at);
      if constexpr (kGather) {
        const float4 oi = load4(ov + at);
        gi = make_float4(oi.x > 0.f ? gi.x : negslope * gi.x,
                         oi.y > 0.f ? gi.y : negslope * gi.y,
                         oi.z > 0.f ? gi.z : negslope * gi.z,
                         oi.w > 0.f ? gi.w : negslope * gi.w);
      }
      *reinterpret_cast<float4*>(G + r * GLD + o) = gi;
    }
  } else {
    for (int i = tid; i < nr * no; i += nth) {
      const int r = i / no, o = i % no;
      const size_t at = (size_t)(r0 + r) * Cout + o;
      float gi = risi18::to_float(gv[at]);
      if constexpr (kGather)
        if (!(risi18::to_float(ov[at]) > 0.f)) gi *= negslope;
      G[r * GLD + o] = gi;
    }
  }
}

// sum_i a[i] b[i] over n4 groups of four.
__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int n4) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n4; ++i) {
    const float4 x = load4(a + 4 * i), y = load4(b + 4 * i);
    acc.x += x.x * y.x; acc.y += x.y * y.y;
    acc.z += x.z * y.z; acc.w += x.w * y.w;
  }
  return acc.x + acc.y + acc.z + acc.w;
}

// -- kernel 0 of the row-tiled plans ----------------------------------------
//
// Once a vertex, the sums of G that every channel chunk of kernel 1 reads
// on a cluster plan (backward_block_cluster), into float32 scratch:
//   gap  [N,P,P,Cout]  GAp[x,e,:] = sum_y G[x,y,:] Ap[y,e],
//   sums [N,3,P,Cout]  GR[x,:]  = sum_y R[y] G[x,y,:],
//                      GAx[x,:] = sum_y Ap[x,y] G[x,y,:]  (GA = sum_x GAx),
//                      GSx[x,:] = sum_y G[x,y,:]          (db's sums),
// with G = g through LeakyReLU' of out (kGather, K2) or g itself (K5).  A
// block of kSumThreads takes sum_rows(P) rows x of one vertex and the
// outputs 32 at a time: the rows' panel of G and the vertex's adjacency in
// shared memory, a thread a column e of GAp with 32 outputs in registers
// (the lanes read consecutive Ap[y, e] and one broadcast row of G); R's
// row sums a warp a row.  Kernel 1 formed GAp and GR of a tile's rows once
// per tile and chunk, and GAp at (a, b) and GR of rows a once per pair of
// tiles: 16 times a vertex and chunk at P = 64 in tiles of 4 rows.
constexpr int kSumRows = 8;       // rows x a block of kernel 0 takes, at most
constexpr int kSumThreads = 512;
constexpr int kSumPanel = 32;     // outputs a pass of kernel 0

// Scratch floats of kernel 0 for one vertex: GAp, GR, GAx and GSx.
__host__ __device__ inline long long sums_words(int P, int Cout) {
  return (long long)(P * P + 3 * P) * Cout;
}

// The rows x a block of kernel 0 takes: kSumRows, or as many as shared
// memory holds beside the adjacency (6 at P = 156).
inline int sum_rows(int P) {
  const long long fixed = round_up(P * (P + 1), 4) + round_up(P, 4);
  const long long room = (long long)(risi18::kMaxSmemBytes / sizeof(float))
                         - fixed;
  const long long rows = room / ((long long)P * kSumPanel);
  return (int)(rows < kSumRows ? (rows > 0 ? rows : 0) : kSumRows);
}

// Shared memory of a block of kernel 0: Ap, R and a panel of G's rows.
inline size_t sums_smem_bytes(int P) {
  return sizeof(float) * ((size_t)round_up(P * (P + 1), 4) + round_up(P, 4)
                          + (size_t)sum_rows(P) * P * kSumPanel);
}

template <typename E, bool kGather>
__global__ void __launch_bounds__(kSumThreads)
backward_sums_kernel(const float* __restrict__ radj, const E* __restrict__ g,
                     const E* __restrict__ out, float* __restrict__ gap,
                     float* __restrict__ sums, int P, int Cout, int rows,
                     float negslope) {
  extern __shared__ __align__(128) float smem[];
  const int ALD = P + 1, PP = P * P, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, nwarps = nth / 32;
  const int per = (P + rows - 1) / rows;
  const size_t v = blockIdx.x / per;
  const int x0 = (int)(blockIdx.x % per) * rows;
  const int nx = min(rows, P - x0);
  float* Ap = smem;
  float* R = Ap + round_up(P * ALD, 4);
  float* Gs = R + round_up(P, 4);          // [nx * P][kSumPanel]
  // The guarded adjacency, then R[d] = sum_e Ap[d, e], a warp a row.
#pragma unroll 8
  for (int i = tid; i < PP; i += nth) {
    const float a = radj[v * PP + i];
    Ap[(i / P) * ALD + (i % P)] = a > 0.f ? a : 0.f;
  }
  __syncthreads();
  for (int d = tid / 32; d < P; d += nwarps) {
    float r = 0.f;
    for (int e = lane; e < P; e += 32) r += Ap[d * ALD + e];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) r += __shfl_xor_sync(0xffffffffu, r, m);
    if (lane == 0) R[d] = r;
  }
  const size_t row0 = v * PP + (size_t)x0 * P;
  for (int p0 = 0; p0 < Cout; p0 += kSumPanel) {
    const int np = min(kSumPanel, Cout - p0);
    __syncthreads();             // the last panel's readers are done
    // Four outputs an item, in one 16- or 8-byte load where the rows
    // allow it, unrolled so that a thread's loads are in flight together.
    const bool wide = Cout % 4 == 0 && (size_t)g % 16 == 0 &&
                      (!kGather || (size_t)out % 16 == 0);
#pragma unroll 8
    for (int i = tid; i < nx * P * (kSumPanel / 4); i += nth) {
      const int o = 4 * (i % (kSumPanel / 4));
      const size_t at = (row0 + i / (kSumPanel / 4)) * Cout + p0 + o;
      float4 gi = make_float4(0.f, 0.f, 0.f, 0.f), oi = gi;
      if (wide && o < np) {
        gi = load4(g + at);
        if constexpr (kGather) oi = load4(out + at);
      } else {
        for (int k = 0; k < 4 && o + k < np; ++k) {
          reinterpret_cast<float*>(&gi)[k] = to_float(g[at + k]);
          if constexpr (kGather)
            reinterpret_cast<float*>(&oi)[k] = to_float(out[at + k]);
        }
      }
      if constexpr (kGather) {
        gi.x = oi.x > 0.f ? gi.x : negslope * gi.x;
        gi.y = oi.y > 0.f ? gi.y : negslope * gi.y;
        gi.z = oi.z > 0.f ? gi.z : negslope * gi.z;
        gi.w = oi.w > 0.f ? gi.w : negslope * gi.w;
      }
      *reinterpret_cast<float4*>(Gs + 4 * i) = gi;
    }
    __syncthreads();
    const int n4 = round_up(np, 4) / 4;
    for (int item = tid; item < nx * P; item += nth) {
      const int e = item % P, xl = item / P;
      const float* gx = Gs + xl * P * kSumPanel;
      float4 acc[kSumPanel / 4];
#pragma unroll
      for (int k = 0; k < kSumPanel / 4; ++k)
        acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int y = 0; y < P; ++y) {
        const float a = Ap[y * ALD + e];
#pragma unroll
        for (int k = 0; k < kSumPanel / 4; ++k)
          if (k < n4) fma4(acc[k], a, load4(gx + y * kSumPanel + 4 * k));
      }
      float* at = gap + (row0 + (size_t)xl * P + e) * Cout + p0;
#pragma unroll
      for (int k = 0; k < kSumPanel / 4; ++k) {
        if (k >= n4) continue;
        if (Cout % 4 == 0) {
          *reinterpret_cast<float4*>(at + 4 * k) = acc[k];
        } else {
          for (int i = 0; i < 4; ++i)
            if (4 * k + i < np) at[4 * k + i] = get4(acc[k], i);
        }
      }
    }
    for (int item = tid; item < nx * np; item += nth) {
      const int o = item % np, xl = item / np, x = x0 + xl;
      const float* gx = Gs + xl * P * kSumPanel + o;
      float gr = 0.f, ga = 0.f, gs = 0.f;
      for (int y = 0; y < P; ++y) {
        const float gy = gx[y * kSumPanel];
        gr += R[y] * gy;
        ga += Ap[x * ALD + y] * gy;
        gs += gy;
      }
      float* at = sums + (v * 3 * P + x) * Cout + p0 + o;
      at[0] = gr;
      at[(size_t)P * Cout] = ga;
      at[2 * (size_t)P * Cout] = gs;
    }
  }
}

// Launches kernel 0 on `stream` for N vertices; returns a cudaError_t.
template <typename E, bool kGather>
inline int launch_backward_sums(const float* radj, const E* g, const E* out,
                                float* gap, float* sums, int N, int P,
                                int Cout, float negslope,
                                cudaStream_t stream) {
  if (N < 0 || P <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const int rows = sum_rows(P);
  const size_t bytes = sums_smem_bytes(P);
  const long long blocks = rows ? (long long)N * ((P + rows - 1) / rows) : 0;
  if (rows == 0 || bytes > risi18::kMaxSmemBytes || blocks >= (1LL << 31))
    return cudaErrorInvalidValue;
  auto kernel = backward_sums_kernel<E, kGather>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kSumThreads, bytes, stream>>>(
      radj, g, out, gap, sums, P, Cout, rows, negslope);
  return cudaGetLastError();
}

// The backward plan queries' fourteen fields (risi18_level_backward_plan,
// risi18_bank_backward_plan): the plan, then kernel 0's scratch words a
// vertex and its shared memory in bytes (0 for a plan of no cluster,
// which launches no kernel 0), then 1 where the stream takes the tensor
// copies (sp.tma), then how dT is added or written (L.scatter).
inline void report_backward_plan(const BackwardPlan& L, int P, int Cout,
                                 int* plan) {
  plan[0] = L.sp.rows; plan[1] = L.Co; plan[2] = L.sp.Cc; plan[3] = L.sp.D;
  plan[4] = (int)(sizeof(float) * L.words); plan[5] = L.tiled;
  plan[6] = L.words ? pieces(L.sp) : 0;   // (none fits: no ring)
  plan[7] = L.cluster;
  plan[8] = L.tiles_per_block; plan[9] = L.mma;
  const bool sums = L.words && L.cluster;
  plan[10] = sums ? (int)sums_words(P, Cout) : 0;
  plan[11] = sums ? (int)sums_smem_bytes(P) : 0;
  plan[12] = L.sp.tma;
  plan[13] = L.scatter;
}

// -- the dT pass of a row tile ----------------------------------------------
//
// The row-tiled blocks form dT from G, not T.  Split by the row whose G
// they come from,
//   dT[a,b,c] = A[a,b] + A6[a,b] R[c] + d(b,c) A15[a,b]               (row a)
//             + B11[b,a] + Bbc[b,c] + R[a] B9[b,c] + d(a,c) B16[b,a] (row b),
// with, K_k K's k-th [C, Cout] slab (0-based) and each product taken with
// the slab transposed,
//   A   = G (S K0 + trA K6) + GAp K8 + GR K1 + dTfull + d(a,b) ds14,
//   A6  = G K5,   A15 = GAp K15 + GR K7 + ds15 + d(a,b) dt18   (at (a, b)),
//   B11 = GAp K11,   Bbc = G (S K2) + GAp K12 + GR K3,
//   B9  = G K9,      B16 = GAp K16 + GR K10                    (at (b, y)),
// G and GAp at the map's own entry, GR at its first row.  For a tile Xb of
// rows b a block forms the A maps of every a at the columns Xb and the B
// maps of the rows Xb, then writes dT[:, Xb, :, chunk] in one pass: 13
// products of rows of kernel 0's scratch (G from g and out) read straight
// into the tensor cores' fragments, S and trA folded into the slabs of G.

// Two values of a row at o and o + 1 (zero from `no` on), as one load where
// `vec` says the row allows it.
template <typename E>
__device__ __forceinline__ float2 pair_of(const E* p, int o, int no,
                                          bool vec) {
  if (vec && o + 1 < no) {
    if constexpr (std::is_same<E, float>::value)
      return *reinterpret_cast<const float2*>(p + o);
    else
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + o));
  }
  return make_float2(o < no ? risi18::to_float(p[o]) : 0.f,
                     o + 1 < no ? risi18::to_float(p[o + 1]) : 0.f);
}

// What a row tile's dT pass reads and writes, for one vertex and chunk.
template <typename E, bool kGather>
struct TileDT {
  const E* gv;          // g at the vertex's panel: rows of Cout
  const E* ov;          // out likewise (kGather)
  const float* gapv;    // kernel 0's GAp at the vertex's panel
  const float* grv;     // kernel 0's GR at the vertex's panel
  const float* Ks;      // K's slabs of the chunk, (k*ncp + f)*GLD + o
  const float* R;
  const int* snbr;      // kGather
  const int* spos;
  StreamBuffers s;      // the maps of a tile, tfull, s14, s15, t18
  std::conditional_t<kGather, float, E>* dst;   // dstate, or dT
  size_t v;
  int P, C, Cout, no, ncp, nc, c0, GLD, mapw;
  float S, trA, negslope;
  bool vec_g;           // g's (and out's) rows take 2-value loads
  bool vec_s;           // the scratch's rows do
  bool vec_scatter;     // dst takes four channels in one access
  // K2's staged scatter (plan scatter kScatterTmaReduce; dT_stage_rows):
  // the tensor map of the float32 dstate as [N*P*P, C], with a box of
  // {ncp, P}; null on the atomics.
  const CUtensorMap* dmap;
  float* stage;         // the warps' staging buffers, sbufs of srow words
                        // each a warp
  unsigned short* cells;   // the slots' columns' cells (scatter_cells)
  int sbufs, srow;
};

// The maps of the 16 rows from m0 of one side of tile [xb0, xb0 + nxb) on
// the tensor cores, this warp's: the B rows (brows), m = bl*P + y at
// (xb0 + bl, y), into tabT, tbc, m10, dacT; or the A rows, m = a*nxb + bl
// at (a, xb0 + bl), into tab, m6, dbc.  Rows from RR on are not stored.
// mma.sync m16n8k8 in three TF32 passes (mma_3xtf32), a channel of the
// chunk a column, eight a tile nt < kNT; channels from ncp on take zero
// slabs.
template <int kNT, typename E, bool kGather>
__device__ __forceinline__ void dT_maps_mma(const TileDT<E, kGather>& d,
                                            bool brows, int m0, int RR,
                                            int xb0, int nxb, int lane) {
  const int g = lane >> 2, t = lane & 3, P = d.P, ncp = d.ncp;
  // The lane's two rows: offsets of G's and GAp's row and of GR's in the
  // vertex's panel (-1 past RR).
  int grow[2], xrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= RR) {
      grow[h] = xrow[h] = -1;
    } else if (brows) {
      xrow[h] = (xb0 + m / P) * d.Cout;
      grow[h] = ((xb0 + m / P) * P + m % P) * d.Cout;
    } else {
      xrow[h] = (m / nxb) * d.Cout;
      grow[h] = ((m / nxb) * P + xb0 + m % nxb) * d.Cout;
    }
  }
  float y[4][kNT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[j][nt][i] = 0.f;
  // (Loading two k-steps' fragments before using either, or forming the
  // next tile's maps while this tile's dT is written, raised the block's
  // register spills and measured slower on an H100: PERF.md.)
  const int ksteps = (d.no + 7) / 8;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int o = 8 * ks + 2 * t;
    float2 fg[2], fp[2], fr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 zero = make_float2(0.f, 0.f);
      fg[h] = fp[h] = fr[h] = zero;
      if (grow[h] < 0) continue;
      fg[h] = pair_of(d.gv + grow[h], o, d.no, d.vec_g);
      fp[h] = pair_of(d.gapv + grow[h], o, d.no, d.vec_s);
      fr[h] = pair_of(d.grv + xrow[h], o, d.no, d.vec_s);
      if constexpr (kGather) {
        const float2 s = pair_of(d.ov + grow[h], o, d.no, d.vec_g);
        if (!(s.x > 0.f)) fg[h].x *= d.negslope;
        if (!(s.y > 0.f)) fg[h].y *= d.negslope;
      }
    }
    // K's slab k at the lane's channel (zero past ncp) and k-step.
    auto slab = [&](int k, int nt) {
      const int ch = 8 * nt + g;
      return ch < ncp ? *reinterpret_cast<const float2*>(
                            d.Ks + (k * ncp + ch) * d.GLD + 8 * ks + 2 * t)
                      : make_float2(0.f, 0.f);
    };
    // acc += A's fragment times the slab kv, three TF32 passes.  A's
    // fragment: rows g, g + 8 at k positions t (column o) and t + 4
    // (column o + 1), as cotangent_maps_mma orders them.  One source's
    // split fragment is live at a time: G's, GAp's, GR's.
    unsigned ah[4], al[4];
    auto frag = [&](const float2 (&f)[2]) {
      split_tf32(f[0].x, ah[0], al[0]);
      split_tf32(f[1].x, ah[1], al[1]);
      split_tf32(f[0].y, ah[2], al[2]);
      split_tf32(f[1].y, ah[3], al[3]);
    };
    auto mma = [&](float (&acc)[4], float2 kv) {
      unsigned bh[2], bl[2];
      split_tf32(kv.x, bh[0], bl[0]);
      split_tf32(kv.y, bh[1], bl[1]);
      mma_3xtf32(acc, ah, al, bh, bl);
    };
    frag(fg);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (brows) {
        const float2 k2 = slab(2, nt);
        mma(y[1][nt], make_float2(d.S * k2.x, d.S * k2.y));
        mma(y[2][nt], slab(9, nt));
      } else {
        const float2 s0 = slab(0, nt), s6 = slab(6, nt);
        mma(y[0][nt], make_float2(d.S * s0.x + d.trA * s6.x,
                                  d.S * s0.y + d.trA * s6.y));
        mma(y[1][nt], slab(5, nt));
      }
    }
    frag(fp);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (brows) {
        mma(y[0][nt], slab(11, nt));
        mma(y[1][nt], slab(12, nt));
        mma(y[3][nt], slab(16, nt));
      } else {
        mma(y[0][nt], slab(8, nt));
        mma(y[2][nt], slab(15, nt));
      }
    }
    frag(fr);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (brows) {
        mma(y[1][nt], slab(3, nt));
        mma(y[3][nt], slab(10, nt));
      } else {
        mma(y[0][nt], slab(1, nt));
        mma(y[2][nt], slab(7, nt));
      }
    }
  }
  // D's rows g and g + 8, channels ch and ch + 1.
  const StreamBuffers& s = d.s;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int ch = 8 * nt + 2 * t;
    if (ch >= ncp) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (grow[h] < 0) continue;
      const int m = m0 + g + 8 * h, at = m * ncp + ch;
      auto two = [&](int j) {
        return make_float2(y[j][nt][2 * h], y[j][nt][2 * h + 1]);
      };
      auto put = [&](int map, float2 val) {
        *reinterpret_cast<float2*>(s.map(map, d.mapw) + at) = val;
      };
      if (brows) {
        put(kTabT, two(0));
        put(kTbc, two(1));
        put(kM10, two(2));
        put(kDacT, two(3));
      } else {
        const bool diag = m / nxb == xb0 + m % nxb;
        float2 a = two(0), c = two(2);
        a.x += s.tfull[ch] + (diag ? s.s14[ch] : 0.f);
        a.y += s.tfull[ch + 1] + (diag ? s.s14[ch + 1] : 0.f);
        c.x += s.s15[ch] + (diag ? s.t18[ch] : 0.f);
        c.y += s.s15[ch + 1] + (diag ? s.t18[ch + 1] : 0.f);
        put(kTab, a);
        put(kM6, two(1));
        put(kDbc, c);
      }
    }
  }
}

// The maps of tile [xb0, xb0 + nxb): its A rows' and B rows' 16-row tiles
// over the block's warps.  No barrier.
template <typename E, bool kGather>
__device__ __forceinline__ void dT_maps(const TileDT<E, kGather>& d,
                                        int xb0, int nxb) {
  const int RR = nxb * d.P, mt = (RR + 15) / 16;
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int w = threadIdx.x / 32; w < 2 * mt; w += nwarps) {
    const bool brows = w >= mt;
    const int m0 = 16 * (brows ? w - mt : w);
    if (d.ncp == 16)
      dT_maps_mma<2>(d, brows, m0, RR, xb0, nxb, lane);
    else
      dT_maps_mma<1>(d, brows, m0, RR, xb0, nxb, lane);
  }
}

// dT[a, b, c] for every a, the rows b of tile [xb0, xb0 + nxb) and every c,
// four channels of the chunk an item, from the tile's maps: K2 scatters it
// into dstate with float32 atomics, K5 writes it into dT[v], each element
// once, rounded to E once.  A thread keeps (channels, c, b) and walks the
// rows a (a share of them where the block has threads to spare), so the
// lanes of a warp write consecutive c.  No barrier.
template <typename E, bool kGather>
__device__ __forceinline__ void dT_assemble(const TileDT<E, kGather>& d,
                                            int xb0, int nxb) {
  const int P = d.P, ncp = d.ncp, quads = ncp / 4, nth = blockDim.x;
  const int per_a = quads * P * nxb;
  const int parts = max(1, nth / per_a);
  const StreamBuffers& s = d.s;
  const float* tab = s.map(kTab, d.mapw);
  const float* tabT = s.map(kTabT, d.mapw);
  const float* tbc = s.map(kTbc, d.mapw);
  const float* dbc = s.map(kDbc, d.mapw);
  const float* dacT = s.map(kDacT, d.mapw);
  const float* m6 = s.map(kM6, d.mapw);
  const float* m10 = s.map(kM10, d.mapw);
  for (int i = threadIdx.x; i < per_a * parts; i += nth) {
    const int base = i % per_a, part = i / per_a;
    const int q = base % quads, c = (base / quads) % P;
    const int bl = base / (quads * P), b = xb0 + bl;
    if (4 * q >= d.nc) continue;
    const int Bbc = (bl * P + c) * ncp + 4 * q;
    const float4 fbc = load4(tbc + Bbc), f10 = load4(m10 + Bbc);
    const float rc = d.R[c];
    for (int a = part; a < P; a += parts) {
      int n = 0, p1 = 0, p2 = 0;
      if constexpr (kGather) {
        n = d.snbr[a]; p1 = d.spos[a * P + b]; p2 = d.spos[a * P + c];
        if ((n | p1 | p2) < 0) continue;
      }
      const int A = (a * nxb + bl) * ncp + 4 * q;
      const int Bba = (bl * P + a) * ncp + 4 * q;
      float4 val = load4(tab + A);
      const float4 fba = load4(tabT + Bba);
      val.x += fbc.x + fba.x; val.y += fbc.y + fba.y;
      val.z += fbc.z + fba.z; val.w += fbc.w + fba.w;
      fma4(val, rc, load4(m6 + A));
      fma4(val, d.R[a], f10);
      if (c == b) fma4(val, 1.f, load4(dbc + A));
      if (c == a) fma4(val, 1.f, load4(dacT + Bba));
      if constexpr (kGather) {
        float* at = d.dst + (((size_t)n * P + p1) * P + p2) * d.C + d.c0
                    + 4 * q;
        if (d.vec_scatter) {
          atomicAdd(reinterpret_cast<float4*>(at), val);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * q + k < d.nc) atomicAdd(at + k, get4(val, k));
        }
      } else {
        E* at = d.dst + d.v * ((size_t)P * P * P * d.C)
                + ((size_t)(a * P + b) * P + c) * d.C + d.c0 + 4 * q;
        if (d.vec_scatter) {
          store4(at, val);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * q + k < d.nc) risi18::store_value(at + k, get4(val, k));
        }
      }
    }
  }
}

// Where a staged row's columns go (scatter_cells): the cell a column
// stores into (its position, or a cell no column reads), and whether it
// stores its value there (kCellValue) or 0, and adds its value at its
// position in a second pass (kCellAdd: a position repeated in the slot).
constexpr unsigned kCellMask = 0x3fff;
constexpr unsigned kCellValue = 0x4000;
constexpr unsigned kCellAdd = 0x8000;

// The cells of K2's staged scatter for every slot a of the vertex, one
// 16-bit word a column: cells[a*P + c].  The first column c of each
// position j = spos[a*P + c] stores its value at j (kCellValue); every
// other column, absent or repeating a position, stores 0 at one of the
// cells no column reads (there are as many: the k-th such column, in c's
// order, takes the k-th such cell), and a repeating one adds its value at
// j in a second pass (kCellAdd).  So the first pass writes each cell of a
// staged row once, holes included, with no atomics and no zeroing.  A
// warp a slot, its columns 32 at a time (the first of equal positions by
// one match); `cells` holds the words [P*P], and a warp lists a slot's
// free cells in its P words of `scratch` (the staging buffers, not yet
// written).  No barrier.
__device__ inline void scatter_cells(const int* spos, int P,
                                     unsigned short* cells,
                                     unsigned short* scratch) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const unsigned below = (1u << lane) - 1u;
  unsigned short* holes = scratch + (threadIdx.x / 32) * P;
  for (int a = threadIdx.x / 32; a < P; a += nwarps) {
    const int* pa = spos + a * P;
    unsigned short* first = cells + a * P;    // then the slot's words
    for (int j = lane; j < P; j += 32) first[j] = 0xffff;
    __syncwarp();
    // The first column of each position: the lowest of a match, the
    // lower words last.
    for (int k = (P - 1) / 32; k >= 0; --k) {
      const int c = 32 * k + lane;
      const int j = c < P ? pa[c] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, j);
      if (j >= 0 && (same & below) == 0u) first[j] = (unsigned short)c;
      __syncwarp();
    }
    // The cells no column reads, in order.
    int nh = 0;
    for (int j0 = 0; j0 < P; j0 += 32) {
      const bool hole = j0 + lane < P && first[j0 + lane] == 0xffff;
      const unsigned m = __ballot_sync(0xffffffffu, hole);
      if (hole) holes[nh + __popc(m & below)] = (unsigned short)(j0 + lane);
      nh += __popc(m);
    }
    __syncwarp();
    unsigned short word[kMaxColumnWords];
    int nn = 0;
#pragma unroll
    for (int k = 0; k < kMaxColumnWords; ++k) {
      const int c = 32 * k + lane;
      const int j = c < P ? pa[c] : -1;
      const bool head = j >= 0 && first[j] == c;
      const bool other = c < P && !head;
      const unsigned m = __ballot_sync(0xffffffffu, other);
      word[k] = head ? (unsigned short)(j | kCellValue)
                : other ? (unsigned short)(holes[nn + __popc(m & below)] |
                                           (j >= 0 ? kCellAdd : 0u))
                        : (unsigned short)0;
      nn += __popc(m);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kMaxColumnWords; ++k)
      if (32 * k + lane < P) first[32 * k + lane] = word[k];
    __syncwarp();
  }
}

// Column blocks of a staged row whose B maps a warp keeps in registers
// (dT_stage_rows); further blocks read them a row.  (Four left K2's
// cluster kernels 52-396 bytes of spills a thread where two leave 0-160,
// in the same time or 1 % less on an H100; PERF.md.)
constexpr int kCachedBlocks = 2;

// K2's staged scatter of the rows b of tile [xb0, xb0 + nxb), from the
// tile's maps.  For a fixed (a, b) the cells (c, chunk) that dT[a, b, :,
// chunk] adds into are the row dstate[n, p1, 0:P, c0:c0+ncp] (n =
// snbr[a], p1 = spos[a*P + b]) read through pos[a, .]: the tensor-copy
// stream's gathered row, run backwards.  So a warp takes the rows (a, b)
// of one b of the tile and a share of the slots a (none where n or p1 is
// absent), keeping the B maps of its b (T_bc and M10 at (b, c), and R[c])
// in registers, its lanes on (column c, four channels); per row it stores
// each column's dT[a, b, c] into the row's staging buffer at the cell
// scatter_cells gives it (a repeated position's column adds its value in a
// second pass), and its lane 0 adds the row into dstate with one tensor
// reduce: one instruction a row where the atomics took one a cell and four
// channels; the reduce drains while the warp stages its next row and the
// block forms the next tile's maps.  Channels of the box past C are not
// written.  A buffer is written again once the reduce issued sbufs rows
// before has read it.  `issued` counts the warp's rows over the pass.  No
// barrier.
template <typename E>
__device__ __forceinline__ void dT_stage_rows(const TileDT<E, true>& d,
                                              int xb0, int nxb,
                                              int& issued) {
  const int P = d.P, ncp = d.ncp, quads = ncp / 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int q = lane % quads, cpb = 32 / quads, ncb = (P + cpb - 1) / cpb;
  // A warp's b and slots: nwarps / nxb warps a row b (the plan's tiles
  // have at most nwarps / 2 rows), each every wpb-th slot.
  const int wpb = nwarps / nxb;
  if (warp >= nxb * wpb) return;
  const StreamBuffers& s = d.s;
  const float* tab = s.map(kTab, d.mapw);
  const float* tabT = s.map(kTabT, d.mapw);
  const float* tbc = s.map(kTbc, d.mapw);
  const float* dbc = s.map(kDbc, d.mapw);
  const float* dacT = s.map(kDacT, d.mapw);
  const float* m6 = s.map(kM6, d.mapw);
  const float* m10 = s.map(kM10, d.mapw);
  const int bl = warp % nxb, b = xb0 + bl;
  // The B maps of row b at the lane's columns: T_bc, M10, R[c].
  float4 ctbc[kCachedBlocks], cm10[kCachedBlocks];
  float cR[kCachedBlocks];
#pragma unroll
  for (int kb = 0; kb < kCachedBlocks; ++kb) {
    const int c = kb * cpb + lane / quads;
    const bool in = kb < ncb && c < P;
    const int at = (bl * P + (in ? c : 0)) * ncp + 4 * q;
    ctbc[kb] = in ? load4(tbc + at) : make_float4(0.f, 0.f, 0.f, 0.f);
    cm10[kb] = in ? load4(m10 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
    cR[kb] = in ? d.R[c] : 0.f;
  }
  for (int a = warp / nxb; a < P; a += wpb) {
    const int n = d.snbr[a], p1 = d.spos[a * P + b];
    if ((n | p1) < 0) continue;
    PIECE_MARK(t0);
    if (issued >= d.sbufs) {
      if (lane == 0) bulk_wait_read(d.sbufs - 1);
      __syncwarp();
    }
    PIECE_MARK(t1);
    float* buf = d.stage + (warp * d.sbufs + issued % d.sbufs) * d.srow;
    const int A = (a * nxb + bl) * ncp + 4 * q;
    const int Bba = (bl * P + a) * ncp + 4 * q;
    float4 base = load4(tab + A);
    const float4 fba = load4(tabT + Bba);
    base.x += fba.x; base.y += fba.y; base.z += fba.z; base.w += fba.w;
    const float4 f6 = load4(m6 + A), fdb = load4(dbc + A);
    const float4 fda = load4(dacT + Bba);
    const float ra = d.R[a];
    const unsigned short* cells = d.cells + a * P;
    // dT[a, b, c] from the B maps of column c.
    auto value = [&](int c, const float4& fbc, const float4& f10,
                     float rc) {
      float4 v = base;
      v.x += fbc.x; v.y += fbc.y; v.z += fbc.z; v.w += fbc.w;
      fma4(v, rc, f6);
      fma4(v, ra, f10);
      if (c == b) fma4(v, 1.f, fdb);
      if (c == a) fma4(v, 1.f, fda);
      return v;
    };
    auto put = [&](int kb, const float4& fbc, const float4& f10,
                   float rc) {
      const int c = kb * cpb + lane / quads;
      if (c >= P) return 0u;
      const unsigned w = cells[c];
      const float4 v = (w & kCellValue) ? value(c, fbc, f10, rc)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(buf + (w & kCellMask) * ncp + 4 * q) = v;
      return w & kCellAdd;
    };
    unsigned adds = 0;
#pragma unroll
    for (int kb = 0; kb < kCachedBlocks; ++kb)
      if (kb < ncb) adds |= put(kb, ctbc[kb], cm10[kb], cR[kb]);
    for (int kb = kCachedBlocks; kb < ncb; ++kb) {
      const int c = min(kb * cpb + lane / quads, P - 1);
      const int at = (bl * P + c) * ncp + 4 * q;
      adds |= put(kb, load4(tbc + at), load4(m10 + at), d.R[c]);
    }
    // Columns that repeat a position add their value at it.
    if (__any_sync(0xffffffffu, adds)) {
      __syncwarp();
      for (int kb = 0; kb < ncb; ++kb) {
        const int c = kb * cpb + lane / quads;
        if (c >= P || !(cells[c] & kCellAdd)) continue;
        const int at = (bl * P + c) * ncp + 4 * q;
        const float4 v = value(c, load4(tbc + at), load4(m10 + at),
                               d.R[c]);
        float* cell = buf + d.spos[a * P + c] * ncp + 4 * q;
        atomicAdd(cell, v.x);
        atomicAdd(cell + 1, v.y);
        atomicAdd(cell + 2, v.z);
        atomicAdd(cell + 3, v.w);
      }
    }
    fence_proxy_async();
    __syncwarp();
    PIECE_MARK(t2);
    if (lane == 0) {
      tma_reduce_add_2d(d.dmap, buf, d.c0, (n * P + p1) * P);
      bulk_commit();
    }
    ++issued;
    PIECE_MARK(t3);
    PIECE_ADD(kScatterWait, t1 - t0);
    PIECE_ADD(kScatterStage, t2 - t1);
    PIECE_ADD(kScatterIssue, t3 - t2);
    PIECE_ADD(kScatterRows, 1);
  }
}

// dT of the tiles first, first + step, ... of a vertex, one pass a tile:
// the tile's maps, a barrier, its dT, a barrier.  Starts with a barrier
// (on K2's staged scatter, after the slots' columns' cells: the block's
// last reads of G and GAp, over which they lie, are behind the caller's
// barrier), and ends with one (on the staged scatter, once every warp's
// reduces have read their buffers).
template <typename E, bool kGather>
__device__ __forceinline__ void dT_pass(const TileDT<E, kGather>& d,
                                        int first, int step, int tiles,
                                        int X) {
  bool staged = false;
  if constexpr (kGather) staged = d.dmap != nullptr;
  CLOCK_VAR(lap);
  if (staged)
    scatter_cells(d.spos, d.P, d.cells,
                  reinterpret_cast<unsigned short*>(d.stage));
  int issued = 0;   // the warp's staged rows
  for (int tb = first; tb < tiles; tb += step) {
    const int xb0 = tb * X, nxb = min(X, d.P - xb0);
    __syncthreads();                  // the maps' readers are done
    CLOCK_LAP(kDTScatter, lap);
    dT_maps(d, xb0, nxb);
    __syncthreads();
    CLOCK_LAP(kDTMaps, lap);
    if constexpr (kGather) {
      if (staged) {
        dT_stage_rows(d, xb0, nxb, issued);
        continue;
      }
    }
    dT_assemble(d, xb0, nxb);
  }
  if (staged && threadIdx.x % 32 == 0) bulk_wait_read(0);
  __syncthreads();
  CLOCK_LAP(kDTScatter, lap);
}

// backward_block on a row-tiled plan of one block a vertex group
// (L.tiled, L.cluster == 0): a field whose maps and G do not fit one block
// (from P = 33 at Cout = 32), where a cluster plan would be one block on
// the CUDA cores (choose_backward_plan), which measured slower than this
// block.  Per vertex:
//   0. GA and db's sums over every row of geff, read from g (and out);
//   1. per row tile X (rows [x0, x0 + nx)): G, GAp and GR of its rows; its
//      maps (tile_reductions); dK's map and vector cases of its rows, added
//      to the block's sums; its part of the four scalars, added in tile
//      order.  Then dK's scalar cases, the scalars times GA.
//   2. dT.  The reductions' cotangents need G, not T.  Split by the row
//      whose G they come from,
//        dT[a,b,c] = A[a,b] + A6[a,b] R[c] + d(b,c) A15[a,b]        (row a)
//                  + B11[b,a] + Bbc[b,c] + R[a] B9[b,c] + d(a,c) B16[b,a]
//                                                                  (row b),
//      with A = S G K1 + trA G K7 + GAp K9 + dT_a + dTfull + d(a,b) ds14,
//      A6 = G K6, A15 = GAp K16 + dTdbc + ds15 + d(a,b) dt18 (rows a, the
//      whole slots' cases), B11 = GAp K12, Bbc = S G K3 + GAp K13 + dT_b,
//      B9 = G K10, B16 = GAp K17 + dTdac (rows b); K_k is K's k-th slab, G
//      and GAp are taken at the map's own row, and each product is with
//      the slab transposed.  So the block takes the row tiles Xb in turn,
//      forms the B maps of its rows, then, for each tile Xa, the A maps of
//      rows Xa at the columns Xb (GAp of those entries only), and writes
//      dT[Xa, Xb, :] whole: K5 stores each element of its dT once, in a
//      fixed order, with no atomics and no partial sum in device memory
//      (one rounding of a bfloat16 dT); K2 scatters it with atomics, as it
//      does untiled.  Each tile pair reloads G of rows Xa (from L2).
// The products run on the CUDA cores; every other sum as untiled.
template <typename E, bool kGather>
__device__ __forceinline__ void backward_block_tiled(
    const E* __restrict__ in, const int* __restrict__ nbr,
    const int* __restrict__ pos, const float* __restrict__ radj,
    const E* __restrict__ K, const E* __restrict__ gout,
    const E* __restrict__ out,
    std::conditional_t<kGather, float, E>* __restrict__ dst,
    float* __restrict__ partial, int N, const BackwardPlan& L,
    float negslope) {
  extern __shared__ __align__(128) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp, X = sp.rows;
  const int GLD = L.GLD, ALD = L.ALD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  auto group = [] { return kGather ? blockIdx.x : blockIdx.y; };
  auto groups = [] { return kGather ? gridDim.x : gridDim.y; };
  auto chunk = [] { return kGather ? blockIdx.y : blockIdx.x; };
  const int c0 = chunk() * sp.Cc, nc = min(sp.Cc, C - c0);
  const int o0 = blockIdx.z * L.Co, no = min(L.Co, Cout - o0);
  const int n4 = round_up(no, 4) / 4;     // groups of four outputs
  const int tiles = (P + X - 1) / X, quads = ncp / 4;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  int* slots = reinterpret_cast<int*>(smem + L.islots);
  float* G = smem + L.g;
  float* GAp = smem + L.gap;
  float* GR = smem + L.gr;
  float* GA = smem + L.ga;
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* dKv = smem + L.dkv;
  float* dbs = smem + L.dbs;
  float* red = smem + L.red;
  float* sacc = smem + L.sacc;
  float* part = smem + L.part;
  float* tab = s.map(kTab, sp.mapw);
  float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m6 = s.map(kM6, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);

  zero_words(smem + L.g, L.words - L.g);
  __syncthreads();
  for (int i = tid; i < kCases * nc * no; i += nth) {
    const int o = i % no, kf = i / no, f = kf % nc, k = kf / nc;
    Ks[(k * ncp + f) * GLD + o] = risi18::to_float(
        K[(size_t)(k * C + c0 + f) * Cout + o0 + o]);
  }
  // K's slab k, channel f.
  auto kslab = [&](int k, int f) { return Ks + (k * ncp + f) * GLD; };

  // dK's register tile: slab, four channels and eight outputs, for the row
  // quads [q0, q1) of a tile's rows (as the untiled block on the CUDA
  // cores).
  const int nog = (no + 7) / 8, dtiles = kSlabs * quads * nog;
  const int parts = max(1, min(min(nth / dtiles, 8), round_up(X * P, 4) / 4));
  float4 dk[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dk[i][0] = dk[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool vec_scatter = C % 4 == 0 && sp.Cc % 4 == 0 && (kGather ||
                                                            L.wide_g);
  const bool wide_g = Cout % 4 == 0 && L.Co % 4 == 0 && L.wide_g;
  const size_t vT = (size_t)PP * P * C;

  for (size_t v = group(); v < (size_t)N; v += groups()) {
    const E* gv = gout + v * PP * Cout + o0;
    const E* ov = kGather ? out + v * PP * Cout + o0 : nullptr;
    // (The barrier that ended the previous vertex ordered its reads of the
    // structure before these writes.)
    if constexpr (kGather) {
      risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R,
                          smem + L.scal, snbr, spos);
    } else {
      risi18::load_adjacency(radj, v, P, ALD, Ap, R, smem + L.scal);
    }
    const float S = smem[L.scal], trA = smem[L.scal + 1];
    if constexpr (kGather) list_slots(snbr, spos, P, slots);
    const auto src = [&] {
      if constexpr (kGather)
        return GatheredSlots<E>{in, snbr, spos, slots};
      else
        return StoredSlots<E>{in + v * vT};
    }();

    // 0. GA = sum_{x,y} Ap[x,y] G[x,y,:] and db's sums, item (output,
    //    part of the rows), the parts added in order.
    {
      const int gparts = nth / no;
      if (tid < gparts * no) {
        const int o = tid % no, p = tid / no;
        float ga = 0.f, gs = 0.f;
        for (int r = p; r < PP; r += gparts) {
          float gi = risi18::to_float(gv[(size_t)r * Cout + o]);
          if constexpr (kGather)
            if (!(risi18::to_float(ov[(size_t)r * Cout + o]) > 0.f))
              gi *= negslope;
          ga += Ap[(r / P) * ALD + r % P] * gi;
          gs += gi;
        }
        part[tid] = ga;
        part[nth + tid] = gs;
      }
      __syncthreads();
      for (int o = tid; o < no; o += nth) {
        float ga = 0.f, gs = 0.f;
        for (int p = 0; p < gparts; ++p) {
          ga += part[p * no + o];
          gs += part[nth + p * no + o];
        }
        GA[o] = ga;
        if constexpr (kGather) dbs[o] += gs;   // (written by chunk 0's blocks)
      }
      for (int i = tid; i < 4 * ncp; i += nth) sacc[i] = 0.f;
    }

    // G, GAp and GR of the rows [x0, x0 + nx) (GAp of every column).  Ends
    // with a barrier.
    auto tile_g = [&](int x0, int nx) {
      __syncthreads();                    // G's and GAp's readers are done
      load_geff_rows<E, kGather>(gv, ov, x0 * P, nx * P, G, GLD, no, Cout,
                                 wide_g, negslope);
      __syncthreads();
      for (int item = tid; item < nx * P * n4; item += nth) {
        const int og = item % n4, r = item / n4, xl = r / P, e = r % P;
        const float* g = G + xl * P * GLD + 4 * og;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int y = 0; y < P; ++y)
          fma4(acc, Ap[y * ALD + e], load4(g + y * GLD));
        *reinterpret_cast<float4*>(GAp + r * GLD + 4 * og) = acc;
      }
      for (int item = tid; item < nx * n4; item += nth) {
        const int og = item % n4, xl = item / n4;
        const float* g = G + xl * P * GLD + 4 * og;
        float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int y = 0; y < P; ++y) fma4(gr, R[y], load4(g + y * GLD));
        *reinterpret_cast<float4*>(GR + xl * GLD + 4 * og) = gr;
      }
      __syncthreads();
    };

    // 1. The tiles' maps and dK.
    for (int t = 0; t < tiles; ++t) {
      const int x0 = t * X, nx = min(X, P - x0), RR = nx * P;
      tile_g(x0, nx);
      tile_reductions<true, true, false>(src, R, sp, s, t, nx, c0, nc);
      // This tile's part of Tfull, s14, s15 and t18.
      for (int i = tid; i < 4 * ncp; i += nth) {
        const int k = i / ncp, f = i % ncp;
        float a = 0.f;
        for (int xl = 0; xl < nx; ++xl) {
          const int diag = (xl * P + x0 + xl) * ncp + f;
          a += k == 0 ? s.ta[xl * ncp + f] : k == 1 ? tab[diag]
               : k == 2 ? s.tdbc[xl * ncp + f] : dbc[diag];
        }
        sacc[i] += a;
      }
      // dK's map cases over the tile's rows.
      {
        const int nq = round_up(RR, 4) / 4, qpp = (nq + parts - 1) / parts;
        const int item = tid;
        if (item < dtiles * parts) {
          const int tt = item % dtiles, pt = item / dtiles;
          const int og = tt % nog, sq = tt / nog, q = sq % quads;
          const int sl = sq / quads;
          const float* map = s.map(kSlabMap[sl], sp.mapw) + 4 * q;
          const float* gm = (sl >= 5 ? GAp : G) + 8 * og;
          const int kind = kSlabScale[sl];
          const float scale = kind == 1 ? S : kind == 2 ? trA : 1.f;
          const int r1 = min(nq, (pt + 1) * qpp) * 4;
          for (int r = pt * qpp * 4; r < r1; ++r) {
            float4 m = load4(map + r * ncp);
            m.x *= scale; m.y *= scale; m.z *= scale; m.w *= scale;
            const float4 g0 = load4(gm + r * GLD);
            const float4 g1 = load4(gm + r * GLD + 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fma4(dk[i][0], get4(m, i), g0);
              fma4(dk[i][1], get4(m, i), g1);
            }
          }
        }
      }
      // The vector cases of the tile's rows against GR.
      for (int i = tid; i < 4 * nc * no; i += nth) {
        const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
        const float* vec = (j == 0 ? s.ta : j == 1 ? s.tb
                            : j == 2 ? s.tdbc : s.tdac) + f;
        float acc = 0.f;
        for (int xl = 0; xl < nx; ++xl)
          acc += vec[xl * ncp] * GR[xl * GLD + o];
        dKv[(j * ncp + f) * GLD + o] += acc;
      }
      __syncthreads();
    }
    // The scalar cases: the four scalars times GA.  Then the scalars'
    // cotangents, GA against K's slabs 5, 14, 15, 18, over s's scalars.
    for (int i = tid; i < 4 * nc * no; i += nth) {
      const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
      dKv[((4 + j) * ncp + f) * GLD + o] += sacc[j * ncp + f] * GA[o];
    }
    for (int i = tid; i < 4 * ncp; i += nth) {
      const int j = i / ncp, f = i % ncp;
      const int k = j == 0 ? 4 : j == 1 ? 13 : j == 2 ? 14 : 17;
      s.tfull[i] = dot_rows(GA, kslab(k, f), n4);   // tfull, s14, s15, t18
    }

    // 2. dT, tile pair by tile pair.
    for (int tb = 0; tb < tiles; ++tb) {
      const int xb0 = tb * X, nxb = min(X, P - xb0), RRb = nxb * P;
      tile_g(xb0, nxb);
      // dT_b and dTdac of the rows b.
      for (int i = tid; i < nxb * ncp; i += nth) {
        const int f = i % ncp, xl = i / ncp;
        s.tb[i] = dot_rows(GR + xl * GLD, kslab(3, f), n4);
        s.tdac[i] = dot_rows(GR + xl * GLD, kslab(10, f), n4);
      }
      __syncthreads();
      // The B maps of the rows b = xb0 + bl: row bl*P + y.
      for (int i = tid; i < RRb * ncp; i += nth) {
        const int f = i % ncp, r = i / ncp, xl = r / P;
        const float* g = G + r * GLD;
        const float* gp = GAp + r * GLD;
        tabT[i] = dot_rows(gp, kslab(11, f), n4);
        tbc[i] = S * dot_rows(g, kslab(2, f), n4)
                 + dot_rows(gp, kslab(12, f), n4) + s.tb[xl * ncp + f];
        m10[i] = dot_rows(g, kslab(9, f), n4);
        dacT[i] = dot_rows(gp, kslab(16, f), n4) + s.tdac[xl * ncp + f];
      }
      for (int ta = 0; ta < tiles; ++ta) {
        const int xa0 = ta * X, nxa = min(X, P - xa0);
        // G and GR of the rows a; GAp[a, b] for b in Xb only, at row
        // al*X + bl.
        __syncthreads();                  // G's readers are done
        load_geff_rows<E, kGather>(gv, ov, xa0 * P, nxa * P, G, GLD, no,
                                   Cout, wide_g, negslope);
        __syncthreads();
        for (int item = tid; item < nxa * nxb * n4; item += nth) {
          const int og = item % n4, ab = item / n4, bl = ab % nxb;
          const int al = ab / nxb;
          const float* g = G + al * P * GLD + 4 * og;
          const float* ae = Ap + xb0 + bl;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int y = 0; y < P; ++y)
            fma4(acc, ae[y * ALD], load4(g + y * GLD));
          *reinterpret_cast<float4*>(GAp + (al * X + bl) * GLD + 4 * og) =
              acc;
        }
        for (int item = tid; item < nxa * n4; item += nth) {
          const int og = item % n4, xl = item / n4;
          const float* g = G + xl * P * GLD + 4 * og;
          float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int y = 0; y < P; ++y) fma4(gr, R[y], load4(g + y * GLD));
          *reinterpret_cast<float4*>(GR + xl * GLD + 4 * og) = gr;
        }
        __syncthreads();
        for (int i = tid; i < nxa * ncp; i += nth) {
          const int f = i % ncp, xl = i / ncp;
          s.ta[i] = dot_rows(GR + xl * GLD, kslab(1, f), n4);
          s.tdbc[i] = dot_rows(GR + xl * GLD, kslab(7, f), n4);
        }
        __syncthreads();
        // The A maps at (a, b), row al*X + bl.
        for (int i = tid; i < nxa * nxb * ncp; i += nth) {
          const int f = i % ncp, ab = i / ncp, bl = ab % nxb, al = ab / nxb;
          const bool diag = xa0 + al == xb0 + bl;
          const float* g = G + (al * P + xb0 + bl) * GLD;
          const float* gp = GAp + (al * X + bl) * GLD;
          const int at = (al * X + bl) * ncp + f;
          tab[at] = S * dot_rows(g, kslab(0, f), n4)
                    + trA * dot_rows(g, kslab(6, f), n4)
                    + dot_rows(gp, kslab(8, f), n4) + s.ta[al * ncp + f]
                    + s.tfull[f] + (diag ? s.s14[f] : 0.f);
          m6[at] = dot_rows(g, kslab(5, f), n4);
          dbc[at] = dot_rows(gp, kslab(15, f), n4) + s.tdbc[al * ncp + f]
                    + s.s15[f] + (diag ? s.t18[f] : 0.f);
        }
        __syncthreads();
        // dT[a, b, c] for a in Xa, b in Xb, item (a, b, c, four channels).
        for (int item = tid; item < nxa * nxb * P * quads; item += nth) {
          const int q = item % quads, rest = item / quads, c = rest % P;
          const int ab = rest / P, bl = ab % nxb, al = ab / nxb;
          const int a = xa0 + al, b = xb0 + bl;
          if (4 * q >= nc) continue;
          const int A = (al * X + bl) * ncp + 4 * q;
          const int Bba = (bl * P + a) * ncp + 4 * q;
          const int Bbc = (bl * P + c) * ncp + 4 * q;
          float4 val = load4(tab + A);
          const float4 fbc = load4(tbc + Bbc), fba = load4(tabT + Bba);
          val.x += fbc.x + fba.x; val.y += fbc.y + fba.y;
          val.z += fbc.z + fba.z; val.w += fbc.w + fba.w;
          fma4(val, R[c], load4(m6 + A));
          fma4(val, R[a], load4(m10 + Bbc));
          if (c == b) fma4(val, 1.f, load4(dbc + A));
          if (c == a) fma4(val, 1.f, load4(dacT + Bba));
          if constexpr (kGather) {
            const int n = snbr[a], p1 = spos[a * P + b], p2 = spos[a * P + c];
            if ((n | p1 | p2) < 0) continue;
            float* at = dst + (((size_t)n * P + p1) * P + p2) * C + c0 + 4 * q;
            if (vec_scatter) {
              atomicAdd(reinterpret_cast<float4*>(at), val);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (4 * q + i < nc) atomicAdd(at + i, get4(val, i));
            }
          } else {
            E* at = dst + v * vT + ((size_t)(a * P + b) * P + c) * C + c0
                    + 4 * q;
            if (vec_scatter) {
              store4(at, val);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (4 * q + i < nc) risi18::store_value(at + i, get4(val, i));
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // The block's partial row: the k-parts of the map cases summed in order,
  // then every case's rows of this chunk and panel, and db.
  {
    const int item = tid;
    const bool active = item < dtiles * parts;
    const int tt = item % dtiles, pt = item / dtiles;
    const int og = tt % nog, sq = tt / nog, q = sq % quads, sl = sq / quads;
    for (int p = 0; p < parts; ++p) {
      if (active && pt == p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* at = red + (sl * ncp + 4 * q + i) * GLD + 8 * og;
          const float4 a0 = load4(at), a1 = load4(at + 4);
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
  float* part_row = partial + group() * (nK + (kGather ? Cout : 0));
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
  if (kGather && chunk() == 0)
    for (int o = tid; o < no; o += nth) part_row[nK + o0 + o] = dbs[o];
}

// K2 kernel 1 (kGather: slots gathered from the state, G = geff through
// LeakyReLU', db, dT scattered into dstate) and K5 kernel 1 (slots stored
// in T, G = g itself, dT written) on a cluster plan (L.cluster > 0; fields
// from P = 33 at Cout = 32): the row tiles of each vertex spread over a
// cluster of L.cluster blocks (grid (vertex groups * L.cluster, chunks,
// panels), cluster (L.cluster, 1, 1)), block `rank` taking the tiles rank,
// rank + cluster, ...; the cluster walks the vertices of its group.  Per
// vertex:
//   0. GA from kernel 0's row sums (backward_sums_kernel: GAp and the row
//      sums of G once a vertex, in `gap` and `sums`), and this block's part
//      of db's sums over its tiles' rows;
//   1. per own tile X: its maps (tile_reductions, a warp copying the row
//      it reduces: stream_rows, or for K2 on the tensor-copy route (kTma,
//      for a plan with sp.tma) one tensor copy a row through `map`, issued
//      by a producer warp, read through the slot's permutation or against
//      its weights: stream_rows_producer), then G of its rows and their
//      GAp and GR from the scratch (the ring may lie over G and GAp:
//      L.ring), dK's map cases of its rows (on the tensor cores where the
//      plan has `mma`:
//      dk_maps_mma over the tile's rows, the sums kept in registers over
//      tiles and vertices), its vector cases, and its part of the four
//      scalars; then dK's scalar cases, that part times GA;
//   2. the scalars' cotangents (GA against K's slabs 5, 14, 15, 18) and dT
//      for the rows b of its own tiles, one pass a tile (dT_pass): the
//      tile's A and B maps on the tensor cores from rows of G, GAp and GR
//      (dT_maps), then dT[:, Xb, :]: K2 stages each gathered row (a, b)
//      in the neighbour's storage order and adds it into dstate with one
//      tensor reduce (dT_stage_rows; plan scatter kScatterTmaReduce), or
//      scatters it with float32 atomics (dT_assemble; kScatterAtomic); K5
//      writes dT[v, a, b, :] for every a and the rows b of its tiles
//      (dT_assemble), so every element of dT has one writer, the block
//      that owns row b's tile, and is written once, rounded to E once.
// When the cluster has walked its vertices, the blocks' dK rows (and db)
// are added in distributed shared memory in rank order, each block
// writing a share of the group's one partial row: kernel 2 sums as many
// rows as without clusters (vertex_groups).  dK and db have no atomics and
// a fixed order of sums, so K5's dT and dK repeat bit for bit; K2's
// dstate is added in float32 (a row's reduce or a cell's atomic) in an
// order that changes from run to run, as untiled.
template <typename E, bool kMma, bool kGather, bool kTma = false>
__device__ __forceinline__ void backward_block_cluster(
    const E* __restrict__ in, const int* __restrict__ nbr,
    const int* __restrict__ pos, const float* __restrict__ radj,
    const E* __restrict__ K, const E* __restrict__ gout,
    const E* __restrict__ out, const float* __restrict__ gap,
    const float* __restrict__ sums,
    std::conditional_t<kGather, float, E>* __restrict__ dst,
    float* __restrict__ partial, int N, const BackwardPlan& L,
    float negslope, const CUtensorMap* map = nullptr,
    const CUtensorMap* dmap = nullptr) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp, X = sp.rows;
  const int GLD = L.GLD, ALD = L.ALD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int CL = L.cluster, rank = (int)cluster.block_rank();
  const int group = blockIdx.x / CL, groups = gridDim.x / CL;
  const int c0 = blockIdx.y * sp.Cc, nc = min(sp.Cc, C - c0);
  const int o0 = blockIdx.z * L.Co, no = min(L.Co, Cout - o0);
  const int n4 = round_up(no, 4) / 4;     // groups of four outputs
  const int tiles = (P + X - 1) / X, quads = ncp / 4;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  int* slots = reinterpret_cast<int*>(smem + L.islots);
  float* G = smem + L.g;
  float* GAp = smem + L.gap;
  float* GR = smem + L.gr;
  float* GA = smem + L.ga;
  const StreamBuffers s = stream_buffers(
      smem + L.stream, sp, L.ring >= 0 ? smem + L.ring : nullptr,
      smem + L.bars, L.lists >= 0 ? smem + L.lists : nullptr);
  float* Ks = smem + L.ks;
  float* dKv = smem + L.dkv;
  float* dbs = smem + L.dbs;
  float* red = smem + L.red;
  float* sacc = smem + L.sacc;
  const float* tab = s.map(kTab, sp.mapw);
  const float* dbc = s.map(kDbc, sp.mapw);

  STAGE_CLOCK_START();
  zero_words(smem + L.g, L.words - L.g);
  __syncthreads();
  for (int i = tid; i < kCases * nc * no; i += nth) {
    const int o = i % no, kf = i / no, f = kf % nc, k = kf / nc;
    Ks[(k * ncp + f) * GLD + o] = risi18::to_float(
        K[(size_t)(k * C + c0 + f) * Cout + o0 + o]);
  }
  auto kslab = [&](int k, int f) { return Ks + (k * ncp + f) * GLD; };

  // dK's map cases.  On the CUDA cores: a thread's register tile (slab,
  // four channels, eight outputs) over its part of a tile's row quads.
  const int nog = (no + 7) / 8, dtiles = kSlabs * quads * nog;
  const int parts = max(1, min(min(nth / dtiles, 8), round_up(X * P, 4) / 4));
  float4 dk[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dk[i][0] = dk[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  // On the tensor cores: a warp owns 16 channels of one slab or of two (as
  // backward_block) over its part of a tile's rows, all outputs of them.
  const int mtiles = ncp == 16 ? kSlabs : 6;
  const int mparts = max(1, nth / 32 / mtiles);
  const int mt = warp % mtiles, mpart = warp / mtiles;
  const int sl_lo = ncp == 16 ? mt : 5 * (mt / 3) + 2 * (mt % 3);
  const int sl_hi = ncp == 16 ? mt : (mt % 3 < 2 ? sl_lo + 1 : -1);
  float dkm[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dkm[nt][i] = 0.f;

  // Four channels of one element in one access (a float4 atomic in K2, a
  // store of four in K5).
  const bool vec_scatter = C % 4 == 0 && sp.Cc % 4 == 0 &&
                           (kGather || L.wide_g);
  const bool wide_g = Cout % 4 == 0 && L.Co % 4 == 0 && L.wide_g;
  const bool wide_s = Cout % 4 == 0 && L.Co % 4 == 0;   // the scratch's rows
  const size_t vT = (size_t)PP * P * C;      // elements of one vertex's T
  // K2's staged scatter: the warps' staging buffers over G and GAp, then
  // the slots' columns' cells.
  const bool staged = kGather && L.scatter == kScatterTmaReduce;
  float* stage = staged ? smem + L.stage : nullptr;
  unsigned short* cells = staged ? reinterpret_cast<unsigned short*>(
                                       stage + (kThreads / 32) * L.sbufs *
                                                   L.srow)
                                 : nullptr;
  STAGE(0);   // set-up and K's staging

  for (size_t v = group; v < (size_t)N; v += groups) {
    const E* gv = gout + v * PP * Cout + o0;
    const E* ov = kGather ? out + v * PP * Cout + o0 : nullptr;
    // (The barrier that ended the previous vertex ordered its reads of the
    // structure before these writes.)
    if constexpr (kGather) {
      risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R,
                          smem + L.scal, snbr, spos);
      list_slots(snbr, spos, P, slots);
    } else {
      risi18::load_adjacency(radj, v, P, ALD, Ap, R, smem + L.scal);
    }
    const float S = smem[L.scal], trA = smem[L.scal + 1];
    const auto src = [&] {
      if constexpr (kGather)
        return GatheredSlots<E>{in, snbr, spos, slots, map};
      else
        return StoredSlots<E>{in + v * vT};
    }();
    using Src = std::remove_const_t<decltype(src)>;

    // 0. GA = sum_x GAx[x], every row, and this block's part of db's sums
    //    over the rows of its tiles, from kernel 0's row sums.
    const float* gapv = gap + v * PP * Cout + o0;
    const float* sv = sums + v * 3 * P * Cout + o0;    // GR, GAx, GSx
    for (int o = tid; o < no; o += nth) {
      float ga = 0.f;
      for (int x = 0; x < P; ++x) ga += sv[(size_t)(P + x) * Cout + o];
      GA[o] = ga;
      if constexpr (kGather) {
        float gs = 0.f;
        for (int t = rank; t < tiles; t += CL)
          for (int x = t * X; x < min(P, (t + 1) * X); ++x)
            gs += sv[(size_t)(2 * P + x) * Cout + o];
        dbs[o] += gs;          // (written by chunk 0's blocks)
      }
    }
    for (int i = tid; i < 4 * ncp; i += nth) sacc[i] = 0.f;
    __syncthreads();
    STAGE(1);   // the structure, GA and db's sums

    // G of the rows [x0, x0 + nx) from g (and out), GAp (of every column)
    // and GR of them from kernel 0's sums.  Ends with a barrier.
    auto tile_g = [&](int x0, int nx) {
      __syncthreads();                    // G's and GAp's readers are done
      load_geff_rows<E, kGather>(gv, ov, x0 * P, nx * P, G, GLD, no, Cout,
                                 wide_g, negslope);
      load_geff_rows<float, false>(gapv, nullptr, x0 * P, nx * P, GAp, GLD,
                                   no, Cout, wide_s, 0.f);
      load_geff_rows<float, false>(sv, nullptr, x0, nx, GR, GLD, no, Cout,
                                   wide_s, 0.f);
      __syncthreads();
    };

    // 1. The own tiles' maps and dK.
    for (int t = rank; t < tiles; t += CL) {
      const int x0 = t * X, nx = min(X, P - x0), RR = nx * P;
      // The tile's stream, then G of its rows: where the ring lies over G
      // and GAp, zeroed first, as the stream reads the channels past nc of
      // a cell that no copy writes (the last tile's barrier ordered G's
      // readers before); a tensor copy writes every channel of its box.
      if (L.ring >= 0 && !kTma) zero_words(smem + L.ring, ring_words(sp));
      tile_reductions<true, true, false, Src, true, kTma>(src, R, sp, s, t,
                                                          nx, c0, nc);
      tile_g(x0, nx);
      STAGE(2);   // the tile's stream and G of its rows
      // This tile's part of Tfull, s14, s15 and t18.
      for (int i = tid; i < 4 * ncp; i += nth) {
        const int k = i / ncp, f = i % ncp;
        float a = 0.f;
        for (int xl = 0; xl < nx; ++xl) {
          const int diag = (xl * P + x0 + xl) * ncp + f;
          a += k == 0 ? s.ta[xl * ncp + f] : k == 1 ? tab[diag]
               : k == 2 ? s.tdbc[xl * ncp + f] : dbc[diag];
        }
        sacc[i] += a;
      }
      // dK's map cases over the tile's rows.
      if constexpr (kMma) {
        // Rows past RR of a short last tile are zeros of the maps.
        const int r8 = round_up(RR, 8);
        const int rpp = round_up((r8 / 8 + mparts - 1) / mparts * 8, 8);
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
                      scale_of(sl_hi), sl_lo >= 5 ? GAp : G, mpart * rpp,
                      min(r8, (mpart + 1) * rpp), (no + 7) / 8, ncp, GLD,
                      lane);
        }
      } else {
        const int nq = round_up(RR, 4) / 4, qpp = (nq + parts - 1) / parts;
        const int item = tid;
        if (item < dtiles * parts) {
          const int tt = item % dtiles, pt = item / dtiles;
          const int og = tt % nog, sq = tt / nog, q = sq % quads;
          const int sl = sq / quads;
          const float* map = s.map(kSlabMap[sl], sp.mapw) + 4 * q;
          const float* gm = (sl >= 5 ? GAp : G) + 8 * og;
          const int kind = kSlabScale[sl];
          const float scale = kind == 1 ? S : kind == 2 ? trA : 1.f;
          const int r1 = min(nq, (pt + 1) * qpp) * 4;
          for (int r = pt * qpp * 4; r < r1; ++r) {
            float4 m = load4(map + r * ncp);
            m.x *= scale; m.y *= scale; m.z *= scale; m.w *= scale;
            const float4 g0 = load4(gm + r * GLD);
            const float4 g1 = load4(gm + r * GLD + 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fma4(dk[i][0], get4(m, i), g0);
              fma4(dk[i][1], get4(m, i), g1);
            }
          }
        }
      }
      // The vector cases of the tile's rows against GR.
      for (int i = tid; i < 4 * nc * no; i += nth) {
        const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
        const float* vec = (j == 0 ? s.ta : j == 1 ? s.tb
                            : j == 2 ? s.tdbc : s.tdac) + f;
        float acc = 0.f;
        for (int xl = 0; xl < nx; ++xl)
          acc += vec[xl * ncp] * GR[xl * GLD + o];
        dKv[(j * ncp + f) * GLD + o] += acc;
      }
      __syncthreads();
      STAGE(3);   // dK of the tile
    }
    // The scalar cases: this block's part of the four scalars times GA.
    // Then the scalars' cotangents, GA against K's slabs 5, 14, 15, 18,
    // over s's scalars.
    for (int i = tid; i < 4 * nc * no; i += nth) {
      const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
      dKv[((4 + j) * ncp + f) * GLD + o] += sacc[j * ncp + f] * GA[o];
    }
    for (int i = tid; i < 4 * ncp; i += nth) {
      const int j = i / ncp, f = i % ncp;
      const int k = j == 0 ? 4 : j == 1 ? 13 : j == 2 ? 14 : 17;
      s.tfull[i] = dot_rows(GA, kslab(k, f), n4);   // tfull, s14, s15, t18
    }

    STAGE(4);   // the scalars' cotangents
    // 2. dT of the rows b of the own tiles, one pass a tile (dT_pass).
    //    The pass's parameters lie in shared memory (L.part), read where
    //    they are used: held in registers beside the stream's and dK's,
    //    they made the block spill 160-216 bytes a thread and run 6-12 %
    //    slower on an H100 (PERF.md).
    static_assert(sizeof(TileDT<E, kGather>) <= sizeof(float) *
                                                   kTilePartWords,
                  "the dT pass's parameters fit the part words");
    auto* dp = reinterpret_cast<TileDT<E, kGather>*>(smem + L.part);
    if (tid == 0)
      *dp = TileDT<E, kGather>{gv, ov, gapv, sv, Ks, R, snbr, spos, s, dst,
                               v, P, C, Cout, no, ncp, nc, c0, GLD,
                               sp.mapw, S, trA, negslope,
                               L.wide_g && Cout % 2 == 0, Cout % 2 == 0,
                               vec_scatter, staged ? dmap : nullptr, stage,
                               cells, L.sbufs, L.srow};
    __syncthreads();
    dT_pass(*dp, rank, CL, tiles, X);
    STAGE(6);   // dT: the tiles' maps and the scatter (K2) or dT (K5)
  }
  // The staged scatter's reduces have read their rows (dT_pass); their
  // adds into dstate complete before the block ends.
  if (staged && lane == 0) bulk_wait_all();

  // The block's dK rows: the k-parts of the map cases summed in order.
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
    const bool active = item < dtiles * parts;
    const int tt = item % dtiles, pt = item / dtiles;
    const int og = tt % nog, sq = tt / nog, q = sq % quads, sl = sq / quads;
    for (int p = 0; p < parts; ++p) {
      if (active && pt == p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* at = red + (sl * ncp + 4 * q + i) * GLD + 8 * og;
          const float4 a0 = load4(at), a1 = load4(at + 4);
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
  // The group's partial row: every entry the blocks' values added in rank
  // order from distributed shared memory, block `rank` writing the entries
  // rank * nth + tid, + CL * nth, ...
  cluster.sync();
  const size_t nK = (size_t)kCases * C * Cout;
  float* part_row = partial + group * (nK + (kGather ? Cout : 0));
  const int nm = kSlabs * nc * no, nv = 8 * nc * no;
  const int total = nm + nv + (kGather && blockIdx.y == 0 ? no : 0);
  for (int i = rank * nth + tid; i < total; i += CL * nth) {
    const float* from;
    size_t to;
    if (i < nm) {
      const int o = i % no, jf = i / no, f = jf % nc, j = jf / nc;
      from = red + (j * ncp + f) * GLD + o;
      to = (size_t)(kSlabCase[j] * C + c0 + f) * Cout + o0 + o;
    } else if (i < nm + nv) {
      const int k = i - nm, o = k % no, jf = k / no, f = jf % nc;
      const int j = jf / nc;
      from = dKv + (j * ncp + f) * GLD + o;
      to = (size_t)(kVectorCase[j] * C + c0 + f) * Cout + o0 + o;
    } else {
      const int o = i - nm - nv;
      from = dbs + o;
      to = nK + o0 + o;
    }
    float sum = 0.f;
    for (int r = 0; r < CL; ++r) sum += *cluster.map_shared_rank(from, r);
    part_row[to] = sum;
  }
  cluster.sync();   // every value read: a block may now end
  STAGE(5);   // the partial row
}

}  // namespace level
}  // namespace risi18
