// The aligned neighbour tensor of a second-order level, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_v3 of
// graphflow_tpu/ops/risi_fused_pallas.py as risi18_aligned_t2 runs it (the
// DMA and alignment front end, save_t2=True): for every vertex v and slot i
//   T[v,i,p1,p2,:] = state[nbr[v,i], pos[v,i,p1], pos[v,i,p2], :]
// with state [N,P,P,C], nbr [N,P], pos [N,P,P] and T [N,P,P,P,C], all float32
// and contiguous.  A slot whose id lies outside [0, N), or a row or column
// whose position lies outside [0, P), reads zeros: the rules of GatherSlots
// (risi18_common.cuh), so that this kernel and K1 agree on what is absent.
//
// Design.  One block per row group (v, i): it loads nbr[v,i] and
// pos[v,i,:] into shared memory once, then its threads walk (p1, p2, c) of
// the group's [P,P,C] slab of T with c fastest, so that every store is
// coalesced and the whole slab is written in one sweep.  Each element is one
// copied value: no arithmetic, so T equals the take-gather exactly.  With
// C % 4 == 0 (and 16-byte aligned pointers) a thread moves 16 bytes at once
// (float4); otherwise one float.
// The state is read through the read-only path (__ldg).  The TPU kernel's
// one-hot alignment matmuls, channel-major tile padding and the
// contraction and assembly it runs against a zero K are not carried over.
//
// What bounds it.  Writing T: N*P^3*C*4 bytes, 134 MB at N=256, P=16, C=32.
// The state it reads (8.4 MB there) stays in the 50 MB L2.  At the card's
// 3.35 TB/s the write alone takes ~40 us.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
risi_aligned_t2_kernel(const float* __restrict__ state,
                       const int* __restrict__ nbr,
                       const int* __restrict__ pos, float* __restrict__ T,
                       int N, int P, int C) {
  extern __shared__ int spos[];      // [P] positions of slot i, -1 if absent
  __shared__ int snbr;               // nbr[v,i], -1 if absent
  const size_t vi = blockIdx.x;      // v*P + i
  const int tid = threadIdx.x, nth = blockDim.x;
  constexpr int W = sizeof(V) / sizeof(float);   // floats per access
  const int CW = C / W;

  if (tid == 0) {
    const int n = nbr[vi];
    snbr = (n >= 0 && n < N) ? n : -1;
  }
  for (int p = tid; p < P; p += nth) {
    const int q = pos[vi * P + p];
    spos[p] = (q >= 0 && q < P) ? q : -1;
  }
  __syncthreads();

  const int n = snbr;
  const V* src = reinterpret_cast<const V*>(state);
  V* out = reinterpret_cast<V*>(T + vi * (size_t)P * P * C);
  const int total = P * P * CW;
  for (int idx = tid; idx < total; idx += nth) {
    const int c = idx % CW;
    const int p2 = (idx / CW) % P;
    const int p1 = idx / (CW * P);
    const int q1 = spos[p1], q2 = spos[p2];
    V val{};
    if (n >= 0 && q1 >= 0 && q2 >= 0)
      val = __ldg(src + (((size_t)n * P + q1) * P + q2) * CW + c);
    out[idx] = val;
  }
}

template <typename V>
int launch(const float* state, const int* nbr, const int* pos, float* T,
           int N, int P, int C, cudaStream_t stream) {
  risi_aligned_t2_kernel<V><<<N * P, kThreads, P * sizeof(int), stream>>>(
      state, nbr, pos, T, N, P, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C] f32, nbr [N,P] i32, pos [N,P,P] i32 -> T [N,P,P,P,C] f32,
// all contiguous.
int risi_aligned_t2_f32(const void* state, const void* nbr, const void* pos,
                        void* T, int N, int P, int C, void* stream) {
  if (N < 0 || P <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const float* s = (const float*)state;
  const int* n = (const int*)nbr;
  const int* p = (const int*)pos;
  float* t = (float*)T;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte accesses need C % 4 == 0 and a 16-byte aligned state (T is
  // freshly allocated); a contiguous view may start anywhere.
  if (C % 4 == 0 && (uintptr_t)state % 16 == 0 && (uintptr_t)T % 16 == 0)
    return launch<float4>(s, n, p, t, N, P, C, st);
  return launch<float>(s, n, p, t, N, P, C, st);
}

const char* risi_aligned_t2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
