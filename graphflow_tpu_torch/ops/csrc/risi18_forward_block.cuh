// The block of the forward kernels: the fused level (risi18_level.cu, K1),
// the bank over a materialised T (risi18_bank.cu, K4) and the bank's
// ablation variants (risi18_bank_ablate.cu, K6).  One block of 512 threads
// per vertex and panel of output channels, one block an SM; the design and
// its algebra are described in risi18_level.cu.  K1 streams its slots
// gathered from the state, K4 and K6 from T (risi18_level_common.cuh:
// GatheredSlots, StoredSlots); K1 adds the bias and LeakyReLU in the
// epilogue, K4 writes Z as it is.  forward_block_tiled (K4, K6) and
// forward_block_cluster (K1) are the same function for a field whose maps
// do not fit one block, in row tiles: one block a vertex, or the tiles
// spread over a cluster of blocks.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "risi18_level_common.cuh"

namespace risi18 {
namespace level {

// What a forward block computes.  kLevel is K1; kBank is K4 and K6's full.
// The others are K6's variants of K4 (risi18_bank_ablate.cu), each K4's
// block with one part left out:
//   kNoGroupD     without the adjacency-weighted cases 6, 9, 10, 12, 13, 16,
//                 17: no M6 and M10 in the stream, no W and no adjacency in
//                 the epilogue; two map slabs (T_ab, T_bc) into Z;
//   kNoSelect     every pick of a diagonal replaced by the full sum
//                 (picks_as_sums), wrong as a contraction by design;
//   kTwoProducts  the stream and the reductions without M6 and M10, then two
//                 products: Z = (T_ab + T_bc + W17) K[0:C]
//                 + (D_bc + D_ac) K[C:2C], W17[x,y] = D_ac[y,x] (= dacT).
enum ForwardPart { kLevel = 0, kBank, kNoGroupD, kNoSelect, kTwoProducts };

__host__ __device__ constexpr bool has_group_d(int part) {
  return part == kLevel || part == kBank || part == kNoSelect;
}

// A forward block's shared memory, offsets in 4-byte words.
struct ForwardPlan {
  StreamPlan sp;
  int Cout;
  int Co;      // output channels of one block's panel
  int ZLD;     // Co rounded up to 4: row stride of Zs, Ws and Us
  int KLD;     // row stride of Ks: ZLD, or ZLD + 2 for the tensor cores
  int ALD;     // P + 1
  int mma;     // 1: the map products run on the tensor cores, a warp
               // keeping 16 rows x all outputs of Z and of W in registers
               // over the chunks (mma_products); Zs and Ws then lie over the
               // ring and the maps, which are dead when the accumulators are
               // written out.  0: register tiles of 8 rows x 4 outputs on
               // the CUDA cores, added to Zs and Ws once per chunk.
  int tiled;   // 1: the rows of Z are walked in tiles of sp.rows rows
               // (forward_block_tiled, forward_block_cluster)
  int cluster; // blocks a cluster of the cluster plan (K1's row tiles,
               // forward_block_cluster), 0 for a plan of one block a vertex
  int tiles_per_block;  // the row tiles one block of the cluster takes
  int ap, r, scal, inbr, ipos, islots, stream, ks, zs, ws, us, ss, part,
      words;
};

// `gather`: the block gathers its slots (K1) and keeps the vertex's
// neighbour ids, positions and listed slots; else they take no room.
// `rows`: the rows of a row tile (a tiled plan), 0 for none.  `cluster`:
// a row-tiled plan for forward_block_cluster (K1), whose products run on
// the tensor cores where a tile's rows allow it; else forward_block_tiled's
// (K4, K6), on the CUDA cores.
inline ForwardPlan make_forward_plan(int P, int C, int Cout, int Cc, int D,
                                     int Co, int es, int aligned,
                                     bool gather, int rows = 0, int G = 1,
                                     bool cluster = false) {
  ForwardPlan L;
  if (rows > 0 && cluster) rows = balanced_rows(P, rows);
  L.sp = make_stream_plan(P, C, Cc, D, es, aligned, rows, G);
  L.Cout = Cout; L.Co = Co; L.ZLD = round_up(Co, 4); L.ALD = P + 1;
  L.tiled = rows > 0;
  const int tiles = (P + L.sp.rows - 1) / L.sp.rows;
  L.cluster = L.tiled && cluster ? cluster_blocks(tiles) : 0;
  L.tiles_per_block = L.cluster ? tiles_a_block(tiles) : 1;
  const int zw = L.sp.rows * P * L.ZLD, stream = stream_words(L.sp);
  // The tensor cores take 16-channel chunks of 16-row tiles, a warp a tile,
  // and up to four 8-wide tiles of outputs (which rules out a wide stream:
  // its chunks have four channels).  A cluster plan's row tile (its rows of
  // the maps, sp.rows * P, a multiple of 16 and at most a 16-row tile a
  // warp) takes them with chunks of 8 or 16 channels.
  const int rr = L.sp.rows * P;
  L.mma = (!L.tiled && L.sp.ncp == 16 && (P * P) % 16 == 0 &&
           P * P / 16 <= kThreads / 32 && L.ZLD % 8 == 0 && L.ZLD <= 32 &&
           2 * zw <= stream) ||
          (L.cluster && (L.sp.ncp == 8 || L.sp.ncp == 16) && rr % 16 == 0 &&
           rr / 16 <= kThreads / 32 && L.ZLD % 8 == 0 && L.ZLD <= 32 &&
           2 * zw <= stream);
  // Rows of K two words further apart than a multiple of eight: the four
  // rows that the lanes of a tensor-core tile read fall on different banks.
  L.KLD = L.mma ? L.ZLD + 2 : L.ZLD;
  int w = 0;
  auto take = [&w](int n) { int at = w; w += round_up(n, 4); return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.inbr = take(gather ? P : 0);
  L.ipos = take(gather ? P * P : 0);
  L.islots = take(gather ? P + 1 : 0);
  L.stream = take(stream);
  L.ks = take(kCases * L.sp.ncp * L.KLD);
  L.zs = L.mma ? L.stream : take(zw);
  L.ws = L.mma ? L.stream + zw : take(zw);
  L.us = take(L.sp.rows * L.ZLD);
  L.ss = take(L.ZLD);
  L.part = take(L.tiled ? kTilePartWords : 0);
  L.words = w;
  return L;
}


// The plan that fits one block with the widest panel, then the largest
// chunk, then the deepest ring; one whose stream keeps a thread's cells in
// registers before a wide one (a field of more than 32 rows has only wide
// ones).  Where no plan keeps all P*P rows of the maps (from P = 36 at
// Cout = 32), a row-tiled one: the widest panel, then the most rows a tile,
// then the largest chunk, the most pieces a ring buffer and the deepest
// ring.  With `cluster` (K1) the row-tiled plan is a cluster plan
// (forward_block_cluster), and one whose tiles keep their cells in
// registers (tile_regs: every warp reduces a row of each stage) comes
// before any other; every plan that fits without it fits with it, so the
// fields served are the same.  words == 0 if none fits.
inline ForwardPlan choose_forward_plan(int P, int C, int Cout, int es,
                                       int aligned, bool gather,
                                       bool cluster = false) {
  for (int wide = 0; wide <= 1; ++wide) {
    for (int Co = Cout;; Co = round_up((Co + 1) / 2, 4)) {
      for (int Cc : {kMaxChunk, 8, 4}) {
        Cc = Cc < C ? Cc : C;
        for (int D = 3; D >= 2; --D) {
          const ForwardPlan L = make_forward_plan(P, C, Cout, Cc, D, Co, es,
                                                  aligned, gather);
          if (L.sp.wide == wide &&
              sizeof(float) * (size_t)L.words <= kMaxSmemBytes)
            return L;
        }
      }
      if (Co <= 4) break;
    }
  }
  for (int regs = cluster ? 1 : 0; regs >= 0; --regs) {
    for (int Co = Cout;; Co = round_up((Co + 1) / 2, 4)) {
      for (int rows : kTileRows) {
        if (rows >= P) continue;
        for (int Cc : {kMaxChunk, 8, 4}) {
          Cc = Cc < C ? Cc : C;
          for (int G = kThreads / 32; G >= 1; G /= 2) {
            for (int D = 4; D >= 2; --D) {
              const ForwardPlan L =
                  make_forward_plan(P, C, Cout, Cc, D, Co, es, aligned,
                                    gather, rows, G, cluster);
              if ((!regs || tile_regs(L.sp)) &&
                  sizeof(float) * (size_t)L.words <= kMaxSmemBytes)
                return L;
            }
          }
        }
      }
      if (Co <= 4) break;
    }
  }
  ForwardPlan none{};
  return none;
}

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs) in
// tiles of one row (P > 1; all of it at P = 1).
inline long long min_forward_smem_bytes(int P, int Cout, bool gather) {
  const int Co = Cout < 4 ? Cout : 4;
  return (long long)sizeof(float) *
         make_forward_plan(P, 1, Cout, 1, 2, Co, (int)sizeof(float), 16,
                           gather, P > 1 ? 1 : 0).words;
}

// K's slabs of the direct product (into Z) and of the adjacency-weighted
// one (into W), with the map each multiplies.  Slab 0 is staged as
// S K1 + trA K7 and slab 2 as S K3.  kNoGroupD keeps the first two direct
// slabs; kTwoProducts multiplies T_ab + T_bc + W17 (summed into T_ab's map)
// by K's slab 0 and D_bc + D_ac (into D_bc's) by slab 1, both staged as
// they are.
__constant__ int kDirectSlab[4] = {0, 2, 5, 9};
__constant__ int kDirectMap[4] = {kTab, kTbc, kM6, kM10};
__constant__ int kWeightedSlab[5] = {8, 11, 12, 15, 16};
__constant__ int kWeightedMap[5] = {kTab, kTabT, kTbc, kDbc, kDacT};
__constant__ int kTwoSlab[2] = {0, 1};
__constant__ int kTwoMap[2] = {kTab, kDbc};

constexpr int kBatch = 9;   // rows of K a warp loads before it stores them

// One product tile of a chunk on the CUDA cores: acc[i] (row rows[i],
// outputs 4*og..) += the maps' channels times K's slabs (kPart's direct ones
// into Z, the five weighted ones into W).
template <int kPart>
__device__ __forceinline__ void tile_product(float4 (&acc)[8],
                                             const int (&rows)[8],
                                             bool weighted, int og,
                                             const StreamBuffers& s,
                                             const float* Ks, int mapw,
                                             int ncp, int KLD) {
  const int nslab = weighted ? 5 : has_group_d(kPart) ? 4 : 2;
  const int* slab = weighted ? kWeightedSlab
                    : kPart == kTwoProducts ? kTwoSlab : kDirectSlab;
  const int* which = weighted ? kWeightedMap
                     : kPart == kTwoProducts ? kTwoMap : kDirectMap;
  for (int j = 0; j < nslab; ++j) {
    const float* map = s.map(which[j], mapw);
    const float* ks = Ks + slab[j] * ncp * KLD + 4 * og;
    for (int f4 = 0; f4 < ncp; f4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(map + rows[i] * ncp + f4);
#pragma unroll
      for (int ff = 0; ff < 4; ++ff) {
        const float4 k4 = load4(ks + (f4 + ff) * KLD);
#pragma unroll
        for (int i = 0; i < 8; ++i) fma4(acc[i], get4(a[i], ff), k4);
      }
    }
  }
}

// The products of `nslab` maps of a chunk of kNcp = 16 (or 8) channels
// with their slabs of K on the tensor cores: acc[nt] (rows row0 + g and
// row0 + g + 8, outputs 8 nt + 2t, 2t + 1; g = lane / 4, t = lane % 4) +=
// map[16 rows x kNcp] times K's slab [kNcp x 8 nt..], for nt < nnt.  Every
// float is split in two TF32 values and every product takes three passes
// (mma_3xtf32): float32 products, as on the CUDA cores.  The order of the
// channels in a k-step is free as long as both operands follow it: a lane
// reads the kNcp / 4 channels from kNcp / 4 * t of its two rows in one
// load each (a float4, or a float2 at kNcp = 8) and feeds each pair of
// them to one k-step, and reads K's rows to match.
template <int kNcp = 16>
__device__ __forceinline__ void mma_products(float (&acc)[4][4],
                                             const int* slab,
                                             const int* which, int nslab,
                                             int row0, int nnt,
                                             const StreamBuffers& s,
                                             const float* Ks, int mapw,
                                             int KLD, int lane) {
  static_assert(kNcp == 16 || kNcp == 8, "a chunk of 8 or 16 channels");
  constexpr int kLane = kNcp / 4;      // channels a lane reads of a row
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int j = 0; j < nslab; ++j) {
    const float* map =
        s.map(which[j], mapw) + (row0 + g) * kNcp + kLane * t;
    float top[kLane], bottom[kLane];
    if constexpr (kNcp == 16) {
      const float4 a = load4(map), b = load4(map + 8 * kNcp);
      top[0] = a.x; top[1] = a.y; top[2] = a.z; top[3] = a.w;
      bottom[0] = b.x; bottom[1] = b.y; bottom[2] = b.z; bottom[3] = b.w;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(map);
      const float2 b = *reinterpret_cast<const float2*>(map + 8 * kNcp);
      top[0] = a.x; top[1] = a.y; bottom[0] = b.x; bottom[1] = b.y;
    }
    const float* kb = Ks + (slab[j] * kNcp + kLane * t) * KLD + g;
#pragma unroll
    for (int st = 0; st < kNcp / 8; ++st) {
      unsigned ah[4], al[4];
      split_tf32(top[2 * st], ah[0], al[0]);
      split_tf32(bottom[2 * st], ah[1], al[1]);
      split_tf32(top[2 * st + 1], ah[2], al[2]);
      split_tf32(bottom[2 * st + 1], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < nnt) {
          unsigned bh[2], bl[2];
          split_tf32(kb[(2 * st) * KLD + 8 * nt], bh[0], bl[0]);
          split_tf32(kb[(2 * st + 1) * KLD + 8 * nt], bh[1], bl[1]);
          mma_3xtf32(acc[nt], ah, al, bh, bl);
        }
      }
    }
  }
}

// K's rows of the chunk [c0, c0 + nc) and the panel [o0, o0 + no) into
// Ks[(k*ncp + f)*KLD + o], zero beyond nc and no, slab 0 as S K1 + trA K7
// and slab 2 as S K3 (kTwoProducts: as they are): a warp a row, the loads of
// kBatch rows in flight together.  No barrier.  (forward_block keeps the
// same loop inline: calling this from it cost K1 2 % on an H100.)
template <int kPart, typename E>
__device__ __forceinline__ void stage_k(const E* __restrict__ K, float* Ks,
                                        const ForwardPlan& L, int C, int c0,
                                        int nc, int o0, int no, float S,
                                        float trA) {
  const int ncp = L.sp.ncp, ZLD = L.ZLD, KLD = L.KLD, Cout = L.Cout;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int o = lane; o < ZLD; o += 32) {
    for (int kf0 = warp; kf0 < kCases * ncp; kf0 += kBatch * nwarps) {
      float val[kBatch], val6[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int kf = kf0 + i * nwarps, f = kf % ncp, k = kf / ncp;
        const bool staged = k < kCases && f < nc && o < no;
        const size_t col = (size_t)o0 + o;
        val[i] = staged ? to_float(K[(size_t)(k * C + c0 + f) * Cout + col])
                        : 0.f;
        val6[i] = staged && k == 0 && kPart != kTwoProducts
                      ? to_float(K[(size_t)(6 * C + c0 + f) * Cout + col])
                      : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int kf = kf0 + i * nwarps, k = kf / ncp;
        if (k >= kCases) break;
        if constexpr (kPart == kTwoProducts)
          Ks[kf * KLD + o] = val[i];
        else
          Ks[kf * KLD + o] = k == 0 ? S * val[i] + trA * val6[i]
                             : k == 2 ? S * val[i] : val[i];
      }
    }
  }
}

// One forward block: vertex blockIdx.x, output panel blockIdx.y.  E is the
// type of the slots' source, K, bias and out: float or __nv_bfloat16.
// kMma: the plan's `mma`; kWide: the plan's stream is wide; kPart: what
// the block computes (ForwardPart).  K1 (kLevel) reads `in` as the state
// [N,P,P,C] with nbr, pos, and adds bias; the others read `in` as T
// [N,P,P,P,C] and take neither nbr, pos nor bias.  radj is the float32
// adjacency [N,P,P]; out is [N,P*P,Cout].
template <typename E, bool kMma, bool kWide, int kPart>
__device__ __forceinline__ void forward_block(
    const E* __restrict__ in, const int* __restrict__ nbr,
    const int* __restrict__ pos, const float* __restrict__ radj,
    const E* __restrict__ K, const E* __restrict__ bias, E* __restrict__ out,
    int N, const ForwardPlan& L, float negslope) {
  constexpr bool kGather = kPart == kLevel;
  constexpr bool kGroupD = has_group_d(kPart);
  constexpr bool kSelect = kPart != kNoSelect;
  // The vector and scalar cases (U and s) and the adjacency-weighted W.
  constexpr bool kVectors = kPart != kTwoProducts;
  constexpr bool kWeighted = kGroupD;
  extern __shared__ __align__(16) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp;
  const int ZLD = L.ZLD, KLD = L.KLD, ALD = L.ALD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nth / 32;
  const size_t v = blockIdx.x;
  const int o0 = blockIdx.y * L.Co, no = min(L.Co, Cout - o0);

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  int* slots = reinterpret_cast<int*>(smem + L.islots);
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;
  float* Ws = smem + L.ws;
  float* Us = smem + L.us;
  float* Ss = smem + L.ss;

  STAGE_CLOCK_START();
  // Zero the ring and the maps (their padding is read), K's staging and
  // the accumulators; everything from L.stream on.
  zero_words(smem + L.stream, L.words - L.stream);
  if constexpr (kGather) {
    load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal, snbr,
                spos);
  } else {
    load_adjacency(radj, v, P, ALD, Ap, R, smem + L.scal);
  }
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  if constexpr (kGather) list_slots(snbr, spos, P, slots);
  const auto src = [&] {
    if constexpr (kGather)
      return GatheredSlots<E>{in, snbr, spos, slots};
    else
      return StoredSlots<E>{in + v * PP * P * C};
  }();
  STAGE(0);   // set-up

  // Product tiles on the CUDA cores, item (matrix, row group, output
  // group): 8 rows rg, rg + nrg, ... x 4 outputs of Z or of W.
  const int nrg = (PP + 7) / 8, nog = ZLD / 4, tiles = nrg * nog;
  // On the tensor cores: warp w keeps rows 16w..16w+15 of Z and of W.
  float accz[4][4], accw[4][4];
  const bool has_tile = warp < PP / 16;
  if constexpr (kMma) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) accz[nt][i] = accw[nt][i] = 0.f;
  }
  // The direct products' slabs and maps.
  const int* dslab = kPart == kTwoProducts ? kTwoSlab : kDirectSlab;
  const int* dmap = kPart == kTwoProducts ? kTwoMap : kDirectMap;
  const int ndirect = kGroupD ? 4 : 2;

  for (int c0 = 0; c0 < C; c0 += sp.Cc) {
    const int nc = min(sp.Cc, C - c0);
    // The first slots' copies fly while K's rows of the chunk are staged:
    // Ks[(k*ncp + f)*KLD + o], zero beyond nc and no, a warp a row, the
    // loads of kBatch rows in flight together.  (The previous chunk's
    // products ended with a barrier, and the stream's barriers order these
    // writes before this chunk's products.)
    stream_prologue(src, sp, s, c0, nc);
    STAGE(1);   // the first copies' start
    for (int o = lane; o < ZLD; o += 32) {
      for (int kf0 = warp; kf0 < kCases * ncp; kf0 += kBatch * nwarps) {
        float val[kBatch], val6[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kf = kf0 + i * nwarps, f = kf % ncp, k = kf / ncp;
          const bool staged = k < kCases && f < nc && o < no;
          const size_t col = (size_t)o0 + o;
          val[i] = staged ? to_float(K[(size_t)(k * C + c0 + f) * Cout + col])
                          : 0.f;
          val6[i] = staged && k == 0 && kPart != kTwoProducts
                        ? to_float(K[(size_t)(6 * C + c0 + f) * Cout + col])
                        : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kf = kf0 + i * nwarps, k = kf / ncp;
          if (k >= kCases) break;
          if constexpr (kPart == kTwoProducts)
            Ks[kf * KLD + o] = val[i];
          else
            Ks[kf * KLD + o] = k == 0 ? S * val[i] + trA * val6[i]
                               : k == 2 ? S * val[i] : val[i];
        }
      }
    }
    STAGE(2);   // K's staging
    if constexpr (kWide)
      stream_reductions_wide<kGroupD, kSelect>(src, R, sp, s, c0, nc);
    else
      stream_reductions<kGroupD, kSelect>(src, R, sp, s, c0, nc);
    STAGE(3);   // the stream

    if constexpr (kVectors) {
      // U and s of the vector and scalar cases; each entry has one owner.
      for (int i = tid; i < P * ZLD; i += nth) {
        const int o = i % ZLD, x = i / ZLD;
        float u = 0.f;
#pragma unroll 4
        for (int f = 0; f < nc; ++f) {
          u += s.ta[x * ncp + f] * Ks[(1 * ncp + f) * KLD + o]
               + s.tb[x * ncp + f] * Ks[(3 * ncp + f) * KLD + o]
               + s.tdbc[x * ncp + f] * Ks[(7 * ncp + f) * KLD + o]
               + s.tdac[x * ncp + f] * Ks[(10 * ncp + f) * KLD + o];
        }
        Us[i] += u;
      }
      for (int o = tid; o < ZLD; o += nth) {
        float u = 0.f;
#pragma unroll 4
        for (int f = 0; f < nc; ++f) {
          u += s.tfull[f] * Ks[(4 * ncp + f) * KLD + o]
               + s.s14[f] * Ks[(13 * ncp + f) * KLD + o]
               + s.s15[f] * Ks[(14 * ncp + f) * KLD + o]
               + s.t18[f] * Ks[(17 * ncp + f) * KLD + o];
        }
        Ss[o] += u;
      }
    } else {
      // The two products' maps: T_ab + T_bc + W17 over T_ab's map, D_bc +
      // D_ac over D_bc's; each entry has one owner.
      float* tab = s.map(kTab, sp.mapw);
      float* dbc = s.map(kDbc, sp.mapw);
      const float* tbc = s.map(kTbc, sp.mapw);
      const float* dacT = s.map(kDacT, sp.mapw);
      for (int i = tid; i < PP * ncp; i += nth) {
        const int f = i % ncp, r = i / ncp, x = r / P, y = r % P;
        tab[i] += tbc[i] + dacT[i];
        dbc[i] += dacT[(y * P + x) * ncp + f];
      }
      __syncthreads();
    }

    STAGE(4);   // U and s
    // The map products, accumulated over the chunks in registers on the
    // tensor cores, else in shared memory.
    if constexpr (kMma) {
      if (has_tile) {
        mma_products(accz, dslab, dmap, ndirect, 16 * warp, ZLD / 8, s, Ks,
                     sp.mapw, KLD, lane);
        if constexpr (kWeighted)
          mma_products(accw, kWeightedSlab, kWeightedMap, 5, 16 * warp,
                       ZLD / 8, s, Ks, sp.mapw, KLD, lane);
      }
    } else {
      for (int item = tid; item < (kWeighted ? 2 : 1) * tiles; item += nth) {
        const bool w = item >= tiles;
        const int t = w ? item - tiles : item, g = t % nog, r0 = t / nog;
        float* acc_at = (w ? Ws : Zs) + 4 * g;
        float4 acc[8];
        int rows[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rows[i] = min(r0 + i * nrg, PP - 1);
          acc[i] = load4(acc_at + rows[i] * ZLD);
        }
        tile_product<kPart>(acc, rows, w, g, s, Ks, sp.mapw, ncp, KLD);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (r0 + i * nrg < PP)
            *reinterpret_cast<float4*>(acc_at + rows[i] * ZLD) = acc[i];
      }
    }
    __syncthreads();
    STAGE(5);   // the products
  }
  if constexpr (kMma) {
    // The last barrier freed the ring and the maps: Zs and Ws lie there.
    if (has_tile) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < ZLD / 8) {
          const int at = (16 * warp + g) * ZLD + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(Zs + at) =
              make_float2(accz[nt][0], accz[nt][1]);
          *reinterpret_cast<float2*>(Zs + at + 8 * ZLD) =
              make_float2(accz[nt][2], accz[nt][3]);
          if constexpr (kWeighted) {
            *reinterpret_cast<float2*>(Ws + at) =
                make_float2(accw[nt][0], accw[nt][1]);
            *reinterpret_cast<float2*>(Ws + at + 8 * ZLD) =
                make_float2(accw[nt][2], accw[nt][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue, item (row, four outputs): the adjacency-weighted part, the
  // vector and scalar cases, (for the level) bias and LeakyReLU, one
  // rounding.
  E* outv = out + v * PP * Cout;
  for (int item = tid; item < PP * nog; item += nth) {
    const int g = item % nog, r = item / nog, x = r / P, y = r % P;
    float4 z = load4(Zs + r * ZLD + 4 * g);
    if constexpr (kWeighted) {
      const float* w = Ws + x * P * ZLD + 4 * g;
      const float* ay = Ap + y * ALD;
#pragma unroll 4
      for (int e = 0; e < P; ++e) fma4(z, ay[e], load4(w + e * ZLD));
    }
    if constexpr (kVectors) {
      fma4(z, R[y], load4(Us + x * ZLD + 4 * g));
      fma4(z, Ap[x * ALD + y], load4(Ss + 4 * g));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 4 * g + i;
      if (o < no) {
        float t = get4(z, i);
        if constexpr (kGather) {
          t += to_float(bias[o0 + o]);
          t = t > 0.f ? t : negslope * t;
        }
        store_value(outv + (size_t)r * Cout + o0 + o, t);
      }
    }
  }
  STAGE(6);   // the epilogue
}

// The ablation variant dma for vertex blockIdx.x, on K4's plan: the stream
// of T[v] with its loads alone (stream_loads), chunk after chunk, summed
// into sink[v] so that the loads cannot be dropped; then Z[v] = T[v] viewed
// as [P*P, P*C], its first Cout columns (Cout <= P*C).
template <typename E>
__device__ __forceinline__ void dma_block(const E* __restrict__ T,
                                          E* __restrict__ Z,
                                          float* __restrict__ sink,
                                          const ForwardPlan& L) {
  extern __shared__ __align__(16) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;
  const E* Tv = T + v * PP * P * C;
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  const StoredSlots<E> src{Tv};
  float* total = smem + L.scal;
  if (tid == 0) *total = 0.f;
  __syncthreads();
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += sp.Cc) {
    const int nc = min(sp.Cc, C - c0);
    stream_prologue(src, sp, s, c0, nc);
    acc += stream_loads(src, sp, s, c0, nc);
    __syncthreads();   // every warp is done with the ring
  }
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (tid % 32 == 0) atomicAdd(total, acc);
  __syncthreads();
  if (tid == 0) sink[v] = *total;

  E* zv = Z + v * PP * Cout;
  const int PC = P * C;
  for (int i = tid; i < PP * Cout; i += nth)
    zv[i] = Tv[(size_t)(i / Cout) * PC + i % Cout];
}

// The bank's forward_block (K4, K6: slots stored in T [N,P,P,P,C], Z as it
// is) on a row-tiled plan (L.tiled): a field whose maps and Z do not fit
// one block (from P = 36 at Cout = 32).  Per vertex and panel:
//   0. the scalar cases' sums over every slot (Tfull, s14, s15, t18), in a
//      stream of their own, so that s is whole before the first tile's
//      epilogue; Ss = their product with K's scalar slabs;
//   then per row tile X = [x0, x0 + nx), nx <= sp.rows:
//   1. per chunk, K's rows staged; the tile's maps, row sums and vectors
//      (tile_reductions: the rows X of every slot, the whole slots in X);
//      U of the tile's rows; the nine map slabs into Z and W of the tile's
//      rows, on the CUDA cores, added up over the chunks in shared memory;
//   2. the epilogue of the tile's rows: W against the adjacency, R U, Ap s,
//      one rounding.
// Every sum is in float32 and none uses an atomic: Z is the same from run
// to run.  The slots are streamed about three times over (twice by the
// tiles, once for the scalars) and K is staged once per tile and chunk.
template <typename E, int kPart>
__device__ __forceinline__ void forward_block_tiled(
    const E* __restrict__ in, const float* __restrict__ radj,
    const E* __restrict__ K, E* __restrict__ out, const ForwardPlan& L) {
  static_assert(kPart != kLevel, "K1 runs forward_block_cluster");
  constexpr bool kGroupD = has_group_d(kPart);
  constexpr bool kSelect = kPart != kNoSelect;
  constexpr bool kVectors = kPart != kTwoProducts;
  constexpr bool kWeighted = kGroupD;
  extern __shared__ __align__(16) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp, X = sp.rows;
  const int ZLD = L.ZLD, KLD = L.KLD, ALD = L.ALD, quads = ncp / 4;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nth / 32;
  const size_t v = blockIdx.x;
  const int o0 = blockIdx.y * L.Co, no = min(L.Co, Cout - o0);
  const int tiles = (P + X - 1) / X, nog = ZLD / 4;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;
  float* Ws = smem + L.ws;
  float* Us = smem + L.us;
  float* Ss = smem + L.ss;
  float* part = smem + L.part;

  zero_words(smem + L.stream, L.words - L.stream);
  load_adjacency(radj, v, P, ALD, Ap, R, smem + L.scal);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  const StoredSlots<E> src{in + v * (size_t)P * P * P * C};

  // 0. The scalar cases: each thread adds up the cells it reads, four
  //    channels q of a slot's (b, c), then the block sums per channel in a
  //    fixed order (the lanes of a warp by shuffles, then the warps).
  if constexpr (kVectors) {
    for (int c0 = 0; c0 < C; c0 += sp.Cc) {
      const int nc = min(sp.Cc, C - c0);
      float4 acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      const RowItems cells = row_items(sp, quads);
      stream_pieces(src, sp, s, c0, nc, src.count(P) * tiles,
                    [&](int j, int& a, int& b0) {
                      a = src.slot(j / tiles);
                      b0 = (j % tiles) * X;
                    },
                    [&](int, int a, int b0, const char* buf) {
        for_row_items(sp, cells, min(X, P - b0), [&](int bl, int c, int q) {
          const int b = b0 + bl;
          const float4 x = load4(reinterpret_cast<const E*>(
              buf + bl * sp.rowb + (c * ncp + 4 * q) * (int)sizeof(E)));
          fma4(acc[0], 1.f, x);                        // sum T
          if (b == a) fma4(acc[1], 1.f, x);            // T[a,a,c]
          if (c == b) fma4(acc[2], 1.f, x);            // T[a,b,b]
          if (a == b && b == c) fma4(acc[3], 1.f, x);  // T[a,a,a]
        });
      });
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        for (int m = quads; m < 32; m *= 2) {
          acc[k].x += __shfl_xor_sync(0xffffffffu, acc[k].x, m);
          acc[k].y += __shfl_xor_sync(0xffffffffu, acc[k].y, m);
          acc[k].z += __shfl_xor_sync(0xffffffffu, acc[k].z, m);
          acc[k].w += __shfl_xor_sync(0xffffffffu, acc[k].w, m);
        }
      }
      // part[((warp*quads + q)*4 + k)*4 + i]: the warp's sums.
      if (lane < quads)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<float4*>(part + ((warp * quads + lane) * 4 + k)
                                                * 4) = acc[k];
      __syncthreads();
      for (int i = tid; i < 4 * ncp; i += nth) {
        const int k = i / ncp, f = i % ncp;
        float t = 0.f;
        for (int w = 0; w < nwarps; ++w)
          t += part[((w * quads + f / 4) * 4 + k) * 4 + f % 4];
        s.tfull[i] = t;        // tfull, s14, s15, t18 lie in this order
      }
      __syncthreads();
      for (int o = tid; o < ZLD; o += nth) {
        float u = 0.f;
        if (o < no) {
          for (int f = 0; f < nc; ++f) {
            const size_t col = (size_t)o0 + o;
            // Without the picks (novpu) every scalar is the full sum.
            const float tf = s.tfull[f];
            u += tf * to_float(K[(size_t)(4 * C + c0 + f) * Cout + col])
                 + (kSelect ? s.s14[f] : tf)
                       * to_float(K[(size_t)(13 * C + c0 + f) * Cout + col])
                 + (kSelect ? s.s15[f] : tf)
                       * to_float(K[(size_t)(14 * C + c0 + f) * Cout + col])
                 + (kSelect ? s.t18[f] : tf)
                       * to_float(K[(size_t)(17 * C + c0 + f) * Cout + col]);
          }
        }
        Ss[o] += u;
      }
      __syncthreads();
    }
  }

  for (int t = 0; t < tiles; ++t) {
    const int x0 = t * X, nx = min(X, P - x0), RR = nx * P;
    for (int i = tid; i < X * P * ZLD; i += nth) Zs[i] = Ws[i] = 0.f;
    for (int i = tid; i < X * ZLD; i += nth) Us[i] = 0.f;
    for (int c0 = 0; c0 < C; c0 += sp.Cc) {
      const int nc = min(sp.Cc, C - c0);
      // (The previous chunk's products ended with a barrier; the stream's
      // first barrier orders K's staging before this chunk's products.)
      stage_k<kPart>(K, Ks, L, C, c0, nc, o0, no, S, trA);
      tile_reductions<kGroupD, kSelect, kPart == kTwoProducts>(
          src, R, sp, s, t, nx, c0, nc);
      if constexpr (kVectors) {
        for (int i = tid; i < nx * ZLD; i += nth) {
          const int o = i % ZLD, xl = i / ZLD;
          float u = 0.f;
          for (int f = 0; f < nc; ++f) {
            u += s.ta[xl * ncp + f] * Ks[(1 * ncp + f) * KLD + o]
                 + s.tb[xl * ncp + f] * Ks[(3 * ncp + f) * KLD + o]
                 + s.tdbc[xl * ncp + f] * Ks[(7 * ncp + f) * KLD + o]
                 + s.tdac[xl * ncp + f] * Ks[(10 * ncp + f) * KLD + o];
          }
          Us[i] += u;
        }
      } else {
        // The two products' maps: T_ab + T_bc + W17 over T_ab's, D_bc +
        // D_ac over D_bc's (D_ac of the whole slots lies in M6's map).
        float* tab = s.map(kTab, sp.mapw);
        float* dbc = s.map(kDbc, sp.mapw);
        const float* tbc = s.map(kTbc, sp.mapw);
        const float* dacT = s.map(kDacT, sp.mapw);
        const float* dac = s.map(kM6, sp.mapw);
        for (int i = tid; i < RR * ncp; i += nth) {
          tab[i] += tbc[i] + dacT[i];
          dbc[i] += dac[i];
        }
        __syncthreads();
      }
      // The map products on the CUDA cores, item (matrix, row group,
      // output group) over the tile's rows.
      const int nrg = (RR + 7) / 8, items = nrg * nog;
      for (int item = tid; item < (kWeighted ? 2 : 1) * items; item += nth) {
        const bool w = item >= items;
        const int it = w ? item - items : item, g = it % nog, r0 = it / nog;
        float* acc_at = (w ? Ws : Zs) + 4 * g;
        float4 acc[8];
        int rows[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rows[i] = min(r0 + i * nrg, RR - 1);
          acc[i] = load4(acc_at + rows[i] * ZLD);
        }
        tile_product<kPart>(acc, rows, w, g, s, Ks, sp.mapw, ncp, KLD);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (r0 + i * nrg < RR)
            *reinterpret_cast<float4*>(acc_at + rows[i] * ZLD) = acc[i];
      }
      __syncthreads();
    }

    // The epilogue of the tile's rows.
    E* outv = out + (v * P + x0) * P * Cout;
    for (int item = tid; item < RR * nog; item += nth) {
      const int g = item % nog, r = item / nog, xl = r / P, y = r % P;
      float4 z = load4(Zs + r * ZLD + 4 * g);
      if constexpr (kWeighted) {
        const float* w = Ws + xl * P * ZLD + 4 * g;
        const float* ay = Ap + y * ALD;
        for (int e = 0; e < P; ++e) fma4(z, ay[e], load4(w + e * ZLD));
      }
      if constexpr (kVectors) {
        fma4(z, R[y], load4(Us + xl * ZLD + 4 * g));
        fma4(z, Ap[(x0 + xl) * ALD + y], load4(Ss + 4 * g));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = 4 * g + i;
        if (o < no) store_value(outv + (size_t)r * Cout + o0 + o, get4(z, i));
      }
    }
    __syncthreads();
  }
}

// K1 on a cluster plan (L.cluster > 0; fields from P = 36 at Cout = 32):
// the row tiles of vertex v and output panel blockIdx.y spread over a
// cluster of L.cluster blocks (grid (N * L.cluster, panels), cluster
// (L.cluster, 1, 1)), block `rank` taking the tiles rank, rank + cluster,
// ...  Per tile X = [x0, x0 + nx), per chunk: K's rows staged, the tile's
// maps (tile_reductions: the rows X of every slot, the whole slots in X),
// U of its rows, this block's part of the four scalars and of s (below),
// and the nine map slabs into Z and W of its rows, on the tensor cores
// where the plan has `mma` (a warp keeps 16 rows of each over the chunks,
// three TF32 passes a product) or on the CUDA cores.  Then the tile's
// pre-activation Z + W Ap^T + R U, float32, into `pre` [N, P*P, Cout]
// (out itself in float32), which the block reads back when s is whole.
//
// The scalar cases are sums over the slots a of per-slot sums: Tfull =
// sum_a T_a[a], s14 = sum_a T_ab[a,a], s15 = sum_a Tdbc[a], t18 = sum_a
// D_bc[a,a], and the whole slots of a tile are rows of its maps.  So each
// block adds its tiles' rows into its part of s (Tfull K5 + s14 K14 + s15
// K15 + t18 K18), the cluster meets, and every block adds the parts from
// distributed shared memory in rank order: s is whole without a pass of
// its own over the slots, and the same in every block.  A second meeting
// keeps each block's part alive until the others have read it.  Then the
// epilogue of the block's rows: pre + Ap[x,y] s + b, LeakyReLU, one
// rounding.  Every sum is float32 and in a fixed order, with no atomics:
// Z is the same from run to run.
template <typename E, bool kMma>
__device__ __forceinline__ void forward_block_cluster(
    const E* __restrict__ state, const int* __restrict__ nbr,
    const int* __restrict__ pos, const float* __restrict__ radj,
    const E* __restrict__ K, const E* __restrict__ bias, E* __restrict__ out,
    float* __restrict__ pre, int N, const ForwardPlan& L, float negslope) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, ncp = sp.ncp, X = sp.rows;
  const int ZLD = L.ZLD, KLD = L.KLD, ALD = L.ALD;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int CL = L.cluster, rank = (int)cluster.block_rank();
  const size_t v = blockIdx.x / CL;
  const int o0 = blockIdx.y * L.Co, no = min(L.Co, Cout - o0);
  const int tiles = (P + X - 1) / X, nog = ZLD / 4;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);
  int* slots = reinterpret_cast<int*>(smem + L.islots);
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;
  float* Ws = smem + L.ws;
  float* Us = smem + L.us;
  float* Ss = smem + L.ss;
  float* Sp = smem + L.part;     // [ZLD]: this block's part of s
  const float* tab = s.map(kTab, sp.mapw);
  const float* dbc = s.map(kDbc, sp.mapw);

  STAGE_CLOCK_START();
  zero_words(smem + L.stream, L.words - L.stream);
  load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal, snbr,
              spos);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  list_slots(snbr, spos, P, slots);
  const GatheredSlots<E> src{state, snbr, spos, slots};
  STAGE(0);   // set-up
  float accz[4][4], accw[4][4];
  const bool has_tile = kMma && warp < X * P / 16;

  for (int t = rank; t < tiles; t += CL) {
    const int x0 = t * X, nx = min(X, P - x0), RR = nx * P;
    for (int i = tid; i < X * ZLD; i += nth) Us[i] = 0.f;
    if constexpr (kMma) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) accz[nt][i] = accw[nt][i] = 0.f;
    } else {
      for (int i = tid; i < X * P * ZLD; i += nth) Zs[i] = Ws[i] = 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += sp.Cc) {
      const int nc = min(sp.Cc, C - c0);
      // (The previous chunk's products ended with a barrier; the stream's
      // first barrier orders K's staging before this chunk's readers.)
      stage_k<kLevel>(K, Ks, L, C, c0, nc, o0, no, S, trA);
      tile_reductions<true, true, false, GatheredSlots<E>, true>(
          src, R, sp, s, t, nx, c0, nc);
      STAGE(1);   // K's staging and the tile's stream
      for (int i = tid; i < nx * ZLD; i += nth) {
        const int o = i % ZLD, xl = i / ZLD;
        float u = 0.f;
        for (int f = 0; f < nc; ++f) {
          u += s.ta[xl * ncp + f] * Ks[(1 * ncp + f) * KLD + o]
               + s.tb[xl * ncp + f] * Ks[(3 * ncp + f) * KLD + o]
               + s.tdbc[xl * ncp + f] * Ks[(7 * ncp + f) * KLD + o]
               + s.tdac[xl * ncp + f] * Ks[(10 * ncp + f) * KLD + o];
        }
        Us[i] += u;
      }
      // This block's part of s: the tile's whole slots x0 + xl.
      for (int o = tid; o < ZLD; o += nth) {
        float u = 0.f;
        for (int f = 0; f < nc; ++f) {
          float tf = 0.f, s14 = 0.f, s15 = 0.f, t18 = 0.f;
          for (int xl = 0; xl < nx; ++xl) {
            const int diag = (xl * P + x0 + xl) * ncp + f;
            tf += s.ta[xl * ncp + f];
            s14 += tab[diag];
            s15 += s.tdbc[xl * ncp + f];
            t18 += dbc[diag];
          }
          u += tf * Ks[(4 * ncp + f) * KLD + o]
               + s14 * Ks[(13 * ncp + f) * KLD + o]
               + s15 * Ks[(14 * ncp + f) * KLD + o]
               + t18 * Ks[(17 * ncp + f) * KLD + o];
        }
        Sp[o] += u;
      }
      // The map products, over the tile's rows (on the tensor cores, rows
      // past RR of a short last tile are zeros of the maps).
      if constexpr (kMma) {
        if (has_tile) {
          if (ncp == 16) {
            mma_products<16>(accz, kDirectSlab, kDirectMap, 4, 16 * warp,
                             ZLD / 8, s, Ks, sp.mapw, KLD, lane);
            mma_products<16>(accw, kWeightedSlab, kWeightedMap, 5,
                             16 * warp, ZLD / 8, s, Ks, sp.mapw, KLD, lane);
          } else {
            mma_products<8>(accz, kDirectSlab, kDirectMap, 4, 16 * warp,
                            ZLD / 8, s, Ks, sp.mapw, KLD, lane);
            mma_products<8>(accw, kWeightedSlab, kWeightedMap, 5, 16 * warp,
                            ZLD / 8, s, Ks, sp.mapw, KLD, lane);
          }
        }
      } else {
        const int nrg = (RR + 7) / 8, items = nrg * nog;
        for (int item = tid; item < 2 * items; item += nth) {
          const bool w = item >= items;
          const int it = w ? item - items : item, g = it % nog;
          const int r0 = it / nog;
          float* acc_at = (w ? Ws : Zs) + 4 * g;
          float4 acc[8];
          int rows[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            rows[i] = min(r0 + i * nrg, RR - 1);
            acc[i] = load4(acc_at + rows[i] * ZLD);
          }
          tile_product<kLevel>(acc, rows, w, g, s, Ks, sp.mapw, ncp, KLD);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (r0 + i * nrg < RR)
              *reinterpret_cast<float4*>(acc_at + rows[i] * ZLD) = acc[i];
        }
      }
      __syncthreads();
      STAGE(2);   // U, the part of s and the products
    }
    if constexpr (kMma) {
      // The last barrier freed the ring and the maps: Zs and Ws lie there.
      if (has_tile) {
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ZLD / 8) {
            const int at = (16 * warp + g) * ZLD + 8 * nt + 2 * t4;
            *reinterpret_cast<float2*>(Zs + at) =
                make_float2(accz[nt][0], accz[nt][1]);
            *reinterpret_cast<float2*>(Zs + at + 8 * ZLD) =
                make_float2(accz[nt][2], accz[nt][3]);
            *reinterpret_cast<float2*>(Ws + at) =
                make_float2(accw[nt][0], accw[nt][1]);
            *reinterpret_cast<float2*>(Ws + at + 8 * ZLD) =
                make_float2(accw[nt][2], accw[nt][3]);
          }
        }
      }
      __syncthreads();
    }
    // The tile's pre-activation: Z + W against the adjacency + R U.
    float* prev = pre + (v * P + x0) * P * Cout + o0;
    for (int item = tid; item < RR * nog; item += nth) {
      const int g = item % nog, r = item / nog, xl = r / P, y = r % P;
      float4 z = load4(Zs + r * ZLD + 4 * g);
      const float* w = Ws + xl * P * ZLD + 4 * g;
      const float* ay = Ap + y * ALD;
      for (int e = 0; e < P; ++e) fma4(z, ay[e], load4(w + e * ZLD));
      fma4(z, R[y], load4(Us + xl * ZLD + 4 * g));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * g + i < no) prev[(size_t)r * Cout + 4 * g + i] = get4(z, i);
    }
    __syncthreads();
    STAGE(3);   // the pre-activation
  }

  // s: the blocks' parts in rank order, from distributed shared memory.
  cluster.sync();
  for (int o = tid; o < ZLD; o += nth) {
    float t = 0.f;
    for (int r = 0; r < CL; ++r) t += cluster.map_shared_rank(Sp, r)[o];
    Ss[o] = t;
  }
  cluster.sync();   // every part read: a block may now end
  STAGE(4);   // the cluster's exchange of s

  // The epilogue of the block's rows: + Ap[x,y] s, bias, LeakyReLU.
  for (int t = rank; t < tiles; t += CL) {
    const int x0 = t * X, RR = min(X, P - x0) * P;
    const float* prev = pre + (v * P + x0) * P * Cout + o0;
    E* outv = out + (v * P + x0) * P * Cout + o0;
    for (int item = tid; item < RR * no; item += nth) {
      const int o = item % no, r = item / no, x = x0 + r / P, y = r % P;
      float tv = prev[(size_t)r * Cout + o] + Ap[x * ALD + y] * Ss[o]
                 + to_float(bias[o0 + o]);
      tv = tv > 0.f ? tv : negslope * tv;
      store_value(outv + (size_t)r * Cout + o, tv);
    }
  }
  STAGE(5);   // the epilogue
}

// dma_block on a row-tiled plan: T[v] streamed a piece of sp.rows rows at a
// time (tile_loads), then the same copy into Z.
template <typename E>
__device__ __forceinline__ void dma_block_tiled(const E* __restrict__ T,
                                                E* __restrict__ Z,
                                                float* __restrict__ sink,
                                                const ForwardPlan& L) {
  extern __shared__ __align__(16) float smem[];
  const StreamPlan& sp = L.sp;
  const int P = sp.P, C = sp.C, Cout = L.Cout, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;
  const E* Tv = T + v * PP * P * C;
  const StreamBuffers s = stream_buffers(smem + L.stream, sp);
  const StoredSlots<E> src{Tv};
  float* total = smem + L.scal;
  if (tid == 0) *total = 0.f;
  __syncthreads();
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += sp.Cc)
    acc += tile_loads(src, sp, s, c0, min(sp.Cc, C - c0));
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (tid % 32 == 0) atomicAdd(total, acc);
  __syncthreads();
  if (tid == 0) sink[v] = *total;

  E* zv = Z + v * PP * Cout;
  const int PC = P * C;
  for (int i = tid; i < PP * Cout; i += nth)
    zv[i] = Tv[(size_t)(i / Cout) * PC + i % Cout];
}

}  // namespace level
}  // namespace risi18
