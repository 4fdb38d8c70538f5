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
// and LeakyReLU (ops/risi_level.py:risi18_level_factored_reference is this
// algebra in plain PyTorch).  All sums are in float32.
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

#include "risi18_level_common.cuh"

namespace {

using risi18::level::kThreads;
using risi18::level::StreamPlan;
namespace lv = risi18::level;

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
  int ap, r, scal, inbr, ipos, islots, stream, ks, zs, ws, us, ss, words;
};

ForwardPlan make_forward_plan(int P, int C, int Cout, int Cc, int D, int Co,
                              int es, int aligned) {
  ForwardPlan L;
  L.sp = lv::make_stream_plan(P, C, Cc, D, es, aligned);
  L.Cout = Cout; L.Co = Co; L.ZLD = lv::round_up(Co, 4); L.ALD = P + 1;
  const int zw = P * P * L.ZLD, stream = lv::stream_words(L.sp);
  // The tensor cores take 16-channel chunks of 16-row tiles, a warp a tile,
  // and up to four 8-wide tiles of outputs (which rules out a wide stream:
  // its chunks have four channels).
  L.mma = L.sp.ncp == 16 && (P * P) % 16 == 0 &&
          P * P / 16 <= kThreads / 32 && L.ZLD % 8 == 0 && L.ZLD <= 32 &&
          2 * zw <= stream;
  // Rows of K two words further apart than a multiple of eight: the four
  // rows that the lanes of a tensor-core tile read fall on different banks.
  L.KLD = L.mma ? L.ZLD + 2 : L.ZLD;
  int w = 0;
  auto take = [&w](int n) { int at = w; w += lv::round_up(n, 4); return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
  L.inbr = take(P);
  L.ipos = take(P * P);
  L.islots = take(P + 1);
  L.stream = take(stream);
  L.ks = take(risi18::kCases * L.sp.ncp * L.KLD);
  L.zs = L.mma ? L.stream : take(zw);
  L.ws = L.mma ? L.stream + zw : take(zw);
  L.us = take(P * L.ZLD);
  L.ss = take(L.ZLD);
  L.words = w;
  return L;
}

// The plan that fits one block with the widest panel, then the largest
// chunk, then the deepest ring; one whose stream keeps a thread's cells in
// registers before a wide one (a field of more than 32 rows has only wide
// ones); words == 0 if none fits.
ForwardPlan choose_forward_plan(int P, int C, int Cout, int es, int aligned) {
  for (int wide = 0; wide <= 1; ++wide) {
    for (int Co = Cout;; Co = lv::round_up((Co + 1) / 2, 4)) {
      for (int Cc : {lv::kMaxChunk, 8, 4}) {
        Cc = Cc < C ? Cc : C;
        for (int D = 3; D >= 2; --D) {
          const ForwardPlan L = make_forward_plan(P, C, Cout, Cc, D, Co, es,
                                                  aligned);
          if (L.sp.wide == wide &&
              sizeof(float) * (size_t)L.words <= risi18::kMaxSmemBytes)
            return L;
        }
      }
      if (Co <= 4) break;
    }
  }
  ForwardPlan none{};
  return none;
}

// K's slabs of the direct product (into Z) and of the adjacency-weighted
// one (into W), with the map each multiplies.  Slab 0 is staged as
// S K1 + trA K7 and slab 2 as S K3.
__constant__ int kDirectSlab[4] = {0, 2, 5, 9};
__constant__ int kDirectMap[4] = {lv::kTab, lv::kTbc, lv::kM6, lv::kM10};
__constant__ int kWeightedSlab[5] = {8, 11, 12, 15, 16};
__constant__ int kWeightedMap[5] = {lv::kTab, lv::kTabT, lv::kTbc,
                                    lv::kDbc, lv::kDacT};

constexpr int kBatch = 9;   // rows of K a warp loads before it stores them

// One product tile of a chunk: acc[i] (row rows[i], outputs 4*og..) +=
// the maps' channels times K's slabs (4 into Z, 5 into W).
__device__ __forceinline__ void tile_product(float4 (&acc)[8],
                                             const int (&rows)[8],
                                             bool weighted, int og,
                                             const lv::StreamBuffers& s,
                                             const float* Ks, int mapw,
                                             int ncp, int KLD) {
  const int nslab = weighted ? 5 : 4;
  const int* slab = weighted ? kWeightedSlab : kDirectSlab;
  const int* which = weighted ? kWeightedMap : kDirectMap;
  for (int j = 0; j < nslab; ++j) {
    const float* map = s.map(which[j], mapw);
    const float* ks = Ks + slab[j] * ncp * KLD + 4 * og;
    for (int f4 = 0; f4 < ncp; f4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = lv::load4(map + rows[i] * ncp + f4);
#pragma unroll
      for (int ff = 0; ff < 4; ++ff) {
        const float4 k4 = lv::load4(ks + (f4 + ff) * KLD);
#pragma unroll
        for (int i = 0; i < 8; ++i) lv::fma4(acc[i], lv::get4(a[i], ff), k4);
      }
    }
  }
}

// The products of `nslab` maps of a 16-channel chunk with their slabs of K
// on the tensor cores: acc[nt] (rows row0 + g and row0 + g + 8, outputs
// 8 nt + 2t, 2t + 1; g = lane / 4, t = lane % 4) += map[16 rows x 16] times
// K's slab [16 x 8 nt..], for nt < nnt.  Every float is split in two TF32
// values and every product takes three passes (lv::mma_3xtf32): float32
// products, as on the CUDA cores.  The order of the channels in a k-step is
// free as long as both operands follow it: a lane reads the four channels
// 4t..4t+3 of its two rows as one float4 each and feeds 4t, 4t + 1 to the
// first step and 4t + 2, 4t + 3 to the second, and reads K's rows to match.
__device__ __forceinline__ void mma_products(float (&acc)[4][4],
                                             const int* slab,
                                             const int* which, int nslab,
                                             int row0, int nnt,
                                             const lv::StreamBuffers& s,
                                             const float* Ks, int mapw,
                                             int KLD, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int j = 0; j < nslab; ++j) {
    const float* map = s.map(which[j], mapw) + (row0 + g) * 16 + 4 * t;
    const float4 top = lv::load4(map), bottom = lv::load4(map + 8 * 16);
    const float* kb = Ks + (slab[j] * 16 + 4 * t) * KLD + g;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      unsigned ah[4], al[4];
      lv::split_tf32(st ? top.z : top.x, ah[0], al[0]);
      lv::split_tf32(st ? bottom.z : bottom.x, ah[1], al[1]);
      lv::split_tf32(st ? top.w : top.y, ah[2], al[2]);
      lv::split_tf32(st ? bottom.w : bottom.y, ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < nnt) {
          unsigned bh[2], bl[2];
          lv::split_tf32(kb[(2 * st) * KLD + 8 * nt], bh[0], bl[0]);
          lv::split_tf32(kb[(2 * st + 1) * KLD + 8 * nt], bh[1], bl[1]);
          lv::mma_3xtf32(acc[nt], ah, al, bh, bl);
        }
      }
    }
  }
}


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
  const lv::StreamBuffers s = lv::stream_buffers(smem + L.stream, sp);
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;
  float* Ws = smem + L.ws;
  float* Us = smem + L.us;
  float* Ss = smem + L.ss;

  STAGE_CLOCK_START();
  // Zero the ring and the maps (their padding is read), K's staging and
  // the accumulators; everything from L.stream on.
  lv::zero_words(smem + L.stream, L.words - L.stream);
  risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal,
                      snbr, spos);
  const float S = smem[L.scal], trA = smem[L.scal + 1];
  lv::list_slots(snbr, spos, P, slots);
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

  for (int c0 = 0; c0 < C; c0 += sp.Cc) {
    const int nc = min(sp.Cc, C - c0);
    // The first slots' copies fly while K's rows of the chunk are staged:
    // Ks[(k*ncp + f)*KLD + o], zero beyond nc and no, a warp a row, the
    // loads of kBatch rows in flight together.  (The previous chunk's
    // products ended with a barrier, and the stream's barriers order these
    // writes before this chunk's products.)
    lv::stream_prologue(state, snbr, spos, slots, sp, s, c0, nc);
    STAGE(1);   // the first copies' start
    for (int o = lane; o < ZLD; o += 32) {
      for (int kf0 = warp; kf0 < risi18::kCases * ncp; kf0 += kBatch * nwarps) {
        float val[kBatch], val6[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kf = kf0 + i * nwarps, f = kf % ncp, k = kf / ncp;
          const bool staged = k < risi18::kCases && f < nc && o < no;
          const size_t col = (size_t)o0 + o;
          val[i] = staged ? risi18::to_float(
                                K[(size_t)(k * C + c0 + f) * Cout + col])
                          : 0.f;
          val6[i] = staged && k == 0
                        ? risi18::to_float(
                              K[(size_t)(6 * C + c0 + f) * Cout + col])
                        : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kf = kf0 + i * nwarps, k = kf / ncp;
          if (k >= risi18::kCases) break;
          Ks[kf * KLD + o] = k == 0 ? S * val[i] + trA * val6[i]
                             : k == 2 ? S * val[i] : val[i];
        }
      }
    }
    STAGE(2);   // K's staging
    if constexpr (kWide)
      lv::stream_reductions_wide(state, snbr, spos, slots, R, sp, s, c0, nc);
    else
      lv::stream_reductions(state, snbr, spos, slots, R, sp, s, c0, nc);
    STAGE(3);   // the stream

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

    STAGE(4);   // U and s
    // The map products, accumulated over the chunks in registers on the
    // tensor cores, else in shared memory.
    if constexpr (kMma) {
      if (has_tile) {
        mma_products(accz, kDirectSlab, kDirectMap, 4, 16 * warp, ZLD / 8, s,
                     Ks, sp.mapw, KLD, lane);
        mma_products(accw, kWeightedSlab, kWeightedMap, 5, 16 * warp,
                     ZLD / 8, s, Ks, sp.mapw, KLD, lane);
      }
    } else {
      for (int item = tid; item < 2 * tiles; item += nth) {
        const bool w = item >= tiles;
        const int t = w ? item - tiles : item, g = t % nog, r0 = t / nog;
        float* acc_at = (w ? Ws : Zs) + 4 * g;
        float4 acc[8];
        int rows[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rows[i] = min(r0 + i * nrg, PP - 1);
          acc[i] = lv::load4(acc_at + rows[i] * ZLD);
        }
        tile_product(acc, rows, w, g, s, Ks, sp.mapw, ncp, KLD);
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
          *reinterpret_cast<float2*>(Ws + at) =
              make_float2(accw[nt][0], accw[nt][1]);
          *reinterpret_cast<float2*>(Ws + at + 8 * ZLD) =
              make_float2(accw[nt][2], accw[nt][3]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue, item (row, four outputs): the adjacency-weighted part, the
  // vector and scalar cases, bias and LeakyReLU, one rounding.
  E* outv = out + v * PP * Cout;
  for (int item = tid; item < PP * nog; item += nth) {
    const int g = item % nog, r = item / nog, x = r / P, y = r % P;
    float4 z = lv::load4(Zs + r * ZLD + 4 * g);
    const float* w = Ws + x * P * ZLD + 4 * g;
    const float* ay = Ap + y * ALD;
#pragma unroll 4
    for (int e = 0; e < P; ++e) lv::fma4(z, ay[e], lv::load4(w + e * ZLD));
    lv::fma4(z, R[y], lv::load4(Us + x * ZLD + 4 * g));
    lv::fma4(z, Ap[x * ALD + y], lv::load4(Ss + 4 * g));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 4 * g + i;
      if (o < no) {
        const float t = lv::get4(z, i) + risi18::to_float(bias[o0 + o]);
        risi18::store_value(outv + (size_t)r * Cout + o0 + o,
                            t > 0.f ? t : negslope * t);
      }
    }
  }
  STAGE(6);   // the epilogue
}

// The bytes a pointer is aligned to, up to 16.
int alignment_of(const void* p) {
  const size_t a = (size_t)p;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

// Launches the level for element type E; returns a cudaError_t.
template <typename E>
int launch_level(const void* state, const void* nbr, const void* pos,
                 const void* radj, const void* K, const void* b, void* out,
                 int N, int P, int C, int Cout, float negslope,
                 void* stream) {
  if (N <= 0) return cudaSuccess;
  if (P <= 0 || C <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  // The stream indexes the state's [N,P,P] elements with an int.
  if ((long long)N * P * P >= (1LL << 31)) return cudaErrorInvalidValue;
  const ForwardPlan L = choose_forward_plan(P, C, Cout, (int)sizeof(E),
                                            alignment_of(state));
  if (L.words == 0) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)L.words;
  auto kernel = L.sp.wide ? risi18_level_kernel<E, false, true>
                : L.mma   ? risi18_level_kernel<E, true, false>
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
// and out in float32 (_f32) or bfloat16 (_bf16).
int risi18_level_forward_f32(const void* state, const void* nbr,
                             const void* pos, const void* radj,
                             const void* K, const void* b, void* out,
                             int N, int P, int C, int Cout, float negslope,
                             void* stream) {
  return launch_level<float>(state, nbr, pos, radj, K, b, out, N, P, C, Cout,
                             negslope, stream);
}

int risi18_level_forward_bf16(const void* state, const void* nbr,
                              const void* pos, const void* radj,
                              const void* K, const void* b, void* out,
                              int N, int P, int C, int Cout, float negslope,
                              void* stream) {
  return launch_level<__nv_bfloat16>(state, nbr, pos, radj, K, b, out, N, P,
                                     C, Cout, negslope, stream);
}

// The least shared memory one block needs: the plan for one float32 channel
// (a chunk of one, the shallowest ring, the narrowest panel of outputs).
long long risi18_level_min_smem_bytes(int P, int Cout) {
  const int Co = Cout < 4 ? Cout : 4;
  return (long long)sizeof(float) *
         make_forward_plan(P, 1, Cout, 1, 2, Co, (int)sizeof(float), 16).words;
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
