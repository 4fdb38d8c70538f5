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
// code in risi18_common.cuh, shared with the backward risi18_level_bwd.cu).
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

using risi18::kCases;
using risi18::kMaxSmemBytes;

constexpr int kThreads = 256;
constexpr size_t kTargetSmemBytes = 113 * 1024;  // two blocks per SM

// Offsets (in 4-byte words) of the block's shared-memory arrays.
struct Layout {
  int P, C, Cout, Cc;
  int LD;    // P*P + 1: padded stride of one channel plane of a [P,P] map
  int ALD;   // P + 1: padded row stride of Ap
  int ZLD;   // P*P + 1: padded stride of one output channel of Z
  int ap, r, scal, tab, tbc, dbc, dac, m6, m10, ta, tb, tdbc, tdac;
  int tfull, s14, s15, t18, ks, zs, inbr, ipos, words;
};

Layout make_layout(int P, int C, int Cout, int Cc) {
  Layout L;
  L.P = P; L.C = C; L.Cout = Cout; L.Cc = Cc;
  L.LD = P * P + 1; L.ALD = P + 1; L.ZLD = P * P + 1;
  int w = 0;
  auto take = [&w](int n) { int at = w; w += n; return at; };
  L.ap = take(P * L.ALD);
  L.r = take(P);
  L.scal = take(2);
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
  L.ks = take(kCases * Cc * Cout);
  L.zs = take(Cout * L.ZLD);
  L.inbr = take(P);
  L.ipos = take(P * P);
  L.words = w;
  return L;
}

size_t smem_bytes(const Layout& L) { return sizeof(float) * (size_t)L.words; }

__global__ void __launch_bounds__(kThreads)
risi18_level_kernel(const float* __restrict__ state,
                    const int* __restrict__ nbr,
                    const int* __restrict__ pos,
                    const float* __restrict__ radj,
                    const float* __restrict__ K,
                    const float* __restrict__ bias,
                    float* __restrict__ out,
                    int N, Layout L, float negslope) {
  extern __shared__ float smem[];
  const int P = L.P, C = L.C, Cout = L.Cout, Cc = L.Cc;
  const int LD = L.LD, ALD = L.ALD, ZLD = L.ZLD, PP = P * P;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t v = blockIdx.x;

  float* Ap = smem + L.ap;
  float* R = smem + L.r;
  const risi18::ChunkMaps m{
      smem + L.tab, smem + L.tbc, smem + L.dbc, smem + L.dac, smem + L.m6,
      smem + L.m10, smem + L.ta, smem + L.tb, smem + L.tdbc, smem + L.tdac,
      smem + L.tfull, smem + L.s14, smem + L.s15, smem + L.t18};
  const float *Tab = m.tab, *Tbc = m.tbc, *Dbc = m.dbc, *Dac = m.dac;
  const float *M6 = m.m6, *M10 = m.m10, *Ta = m.ta, *Tb = m.tb;
  const float *Tdbc = m.tdbc, *Tdac = m.tdac, *Tfull = m.tfull;
  const float *S14 = m.s14, *S15 = m.s15, *T18 = m.t18;
  float* Ks = smem + L.ks;
  float* Zs = smem + L.zs;
  int* snbr = reinterpret_cast<int*>(smem + L.inbr);
  int* spos = reinterpret_cast<int*>(smem + L.ipos);

  for (int i = tid; i < Cout * ZLD; i += nth) Zs[i] = 0.f;
  risi18::load_vertex(nbr, pos, radj, v, N, P, ALD, Ap, R, smem + L.scal,
                      snbr, spos);
  const float S = smem[L.scal], trA = smem[L.scal + 1];

  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int nc = min(Cc, C - c0);
    for (int i = tid; i < kCases * nc * Cout; i += nth) {
      const int o = i % Cout, kf = i / Cout, f = kf % nc, k = kf / nc;
      Ks[(k * Cc + f) * Cout + o] = K[(size_t)(k * C + c0 + f) * Cout + o];
    }
    // 1-3. The shared reductions of this chunk (risi18_common.cuh).
    risi18::chunk_reductions(state, snbr, spos, R, P, C, c0, nc, LD, m);

    // 4. Assemble the 18 cases of each output row (x, y) and multiply them
    //    into this chunk's rows of K.
    for (int r = tid; r < PP; r += nth) {
      const int x = r / P, y = r % P;
      const float Ry = R[y], Axy = Ap[x * ALD + y];
      const float* Ay = Ap + y * ALD;
      for (int f = 0; f < nc; ++f) {
        const float* tab = Tab + f * LD;
        const float* tbc = Tbc + f * LD;
        const float* dbc = Dbc + f * LD;
        const float* dac = Dac + f * LD;
        float m9 = 0.f, m12 = 0.f, m13 = 0.f, m16 = 0.f, m17 = 0.f;
        for (int e = 0; e < P; ++e) {
          const float a = Ay[e];          // Ap[y, e]
          m9 += tab[x * P + e] * a;       // sum_e T_ab[x,e] Ap[y,e]
          m12 += tab[e * P + x] * a;      // sum_e T_ab[e,x] Ap[y,e]
          m13 += tbc[x * P + e] * a;      // sum_e T_bc[x,e] Ap[y,e]
          m16 += dbc[x * P + e] * a;      // sum_e T[x,e,e] Ap[y,e]
          m17 += dac[e * P + x] * a;      // sum_e T[e,x,e] Ap[y,e]
        }
        float yk[kCases];
        yk[0] = tab[r] * S;                 // 1  (a,b)
        yk[1] = Ta[f * P + x] * Ry;         // 2  (a,d)
        yk[2] = tbc[r] * S;                 // 3  (b,c)
        yk[3] = Tb[f * P + x] * Ry;         // 4  (b,d)
        yk[4] = Axy * Tfull[f];             // 5  (d,e)
        yk[5] = M6[f * LD + r];             // 6  (a,b) c==d
        yk[6] = tab[r] * trA;               // 7  (a,b) d==e
        yk[7] = Tdbc[f * P + x] * Ry;       // 8  (a,d) b==c
        yk[8] = m9;                         // 9  (a,d) b==e
        yk[9] = M10[f * LD + r];            // 10 (b,c) a==d
        yk[10] = Tdac[f * P + x] * Ry;      // 11 (b,d) a==c
        yk[11] = m12;                       // 12 (b,d) a==e
        yk[12] = m13;                       // 13 (b,d) c==e
        yk[13] = Axy * S14[f];              // 14 (d,e) a==b
        yk[14] = Axy * S15[f];              // 15 (d,e) b==c
        yk[15] = m16;                       // 16 (a,d) b==c==e
        yk[16] = m17;                       // 17 (b,d) a==c==e
        yk[17] = Axy * T18[f];              // 18 (d,e) a==b==c
        const float* kf = Ks + f * Cout;
        for (int o = 0; o < Cout; ++o) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < kCases; ++k) acc += yk[k] * kf[k * Cc * Cout + o];
          Zs[o * ZLD + r] += acc;
        }
      }
    }
    __syncthreads();
  }

  // 5. Bias and LeakyReLU; neighbouring threads write neighbouring words.
  float* outv = out + v * PP * Cout;
  for (int i = tid; i < PP * Cout; i += nth) {
    const int r = i / Cout, o = i % Cout;
    const float z = Zs[o * ZLD + r] + bias[o];
    outv[i] = z > 0.f ? z : negslope * z;
  }
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
  const int Cc = choose_chunk(P, C, Cout);
  if (Cc == 0) return cudaErrorInvalidValue;
  const Layout L = make_layout(P, C, Cout, Cc);
  const size_t bytes = smem_bytes(L);
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

const char* risi18_level_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
