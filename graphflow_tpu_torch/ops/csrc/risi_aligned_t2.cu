// The aligned neighbour tensor of a second-order level, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_v3 of
// graphflow_tpu/ops/risi_fused_pallas.py as risi18_aligned_t2 runs it (the
// DMA and alignment front end, save_t2=True): for every vertex v and slot i
//   T[v,i,p1,p2,:] = state[nbr[v,i], pos[v,i,p1], pos[v,i,p2], :]
// with state [N,P,P,C], nbr [N,P], pos [N,P,P] and T [N,P,P,P,C], state and
// T in float32 or bfloat16 (one type), all contiguous.  A slot whose id lies
// outside [0, N), or a row or column whose position lies outside [0, P),
// reads zeros: the rules of GatherSlots (risi18_common.cuh), so that this
// kernel and K1 agree on what is absent.
//
// Design.  One block per row group (v, i): it loads nbr[v,i] and
// pos[v,i,:] into shared memory once, then its threads walk (p1, p2, c) of
// the group's [P,P,C] slab of T with c fastest, so that every store is
// coalesced and the whole slab is written in one sweep.  Each element is one
// copied value: no arithmetic, so T equals the take-gather exactly in either
// type.  Where a channel row is a whole number of 16-byte words (C % 4 == 0
// in float32, C % 8 == 0 in bfloat16) and the pointers are 16-byte aligned,
// a thread moves 16 bytes at once (uint4); otherwise one element.
// The state is read through the read-only path (__ldg).  The TPU kernel's
// one-hot alignment matmuls, channel-major tile padding and the
// contraction and assembly it runs against a zero K are not carried over.
//
// What bounds it.  Writing T: N*P^3*C elements, 134 MB in float32 at N=256,
// P=16, C=32 and 67 MB in bfloat16.  The state it reads (8.4 or 4.2 MB
// there) stays in the 50 MB L2.  At the card's 3.35 TB/s the write alone
// takes ~40 us in float32 and ~20 us in bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// E is the element type (float or __nv_bfloat16), V the type of one access:
// E itself, or uint4 for sizeof(uint4) / sizeof(E) elements at once.
template <typename E, typename V>
__global__ void __launch_bounds__(kThreads)
risi_aligned_t2_kernel(const E* __restrict__ state,
                       const int* __restrict__ nbr,
                       const int* __restrict__ pos, E* __restrict__ T,
                       int N, int P, int C) {
  extern __shared__ int spos[];      // [P] positions of slot i, -1 if absent
  __shared__ int snbr;               // nbr[v,i], -1 if absent
  const size_t vi = blockIdx.x;      // v*P + i
  const int tid = threadIdx.x, nth = blockDim.x;
  constexpr int W = sizeof(V) / sizeof(E);       // elements per access
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

template <typename E, typename V>
int launch(const E* state, const int* nbr, const int* pos, E* T, int N,
           int P, int C, cudaStream_t stream) {
  risi_aligned_t2_kernel<E, V><<<N * P, kThreads, P * sizeof(int), stream>>>(
      state, nbr, pos, T, N, P, C);
  return cudaGetLastError();
}

// 16-byte accesses need a channel row of whole 16-byte words and 16-byte
// aligned pointers (T is freshly allocated; a contiguous view of a state
// may start at any element); otherwise one element a thread.
template <typename E>
int dispatch(const void* state, const void* nbr, const void* pos, void* T,
             int N, int P, int C, void* stream) {
  if (N < 0 || P <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const E* s = (const E*)state;
  const int* n = (const int*)nbr;
  const int* p = (const int*)pos;
  E* t = (E*)T;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int W = sizeof(uint4) / sizeof(E);
  if (C % W == 0 && (uintptr_t)state % 16 == 0 && (uintptr_t)T % 16 == 0)
    return launch<E, uint4>(s, n, p, t, N, P, C, st);
  return launch<E, E>(s, n, p, t, N, P, C, st);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// state [N,P,P,C], nbr [N,P] i32, pos [N,P,P] i32 -> T [N,P,P,P,C], all
// contiguous; state and T in float32 (_f32) or bfloat16 (_bf16).
int risi_aligned_t2_f32(const void* state, const void* nbr, const void* pos,
                        void* T, int N, int P, int C, void* stream) {
  return dispatch<float>(state, nbr, pos, T, N, P, C, stream);
}

int risi_aligned_t2_bf16(const void* state, const void* nbr, const void* pos,
                         void* T, int N, int P, int C, void* stream) {
  return dispatch<__nv_bfloat16>(state, nbr, pos, T, N, P, C, stream);
}

const char* risi_aligned_t2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
