// Device code of the two level kernels (risi18_level.cu, K1, and
// risi18_level_bwd.cu, K2 kernel 1): the asynchronous slot stream with the
// shared reductions of one channel chunk, and the small helpers both use.
// The vertex's structure (load_vertex) and the element types come from
// risi18_common.cuh, which the bank kernels K4, K5 and K6 go on using whole.
//
// The stream.  Slot a of a vertex, for the chunk's channels [c0, c0 + nc),
// is state[nbr[a], pos[a,b], pos[a,c], c0:c0+nc] for every (b, c): P*P runs
// of nc contiguous elements.  Every thread of the block copies runs with
// cp.async (16 bytes a copy where the chunk and C allow it, else 8 or 4; a
// run that is absent is zero-filled by a copy of source size 0) into a ring
// of D slot buffers in shared memory, so that D - 1 slots are in flight
// while one is reduced.  A warp copies the rows it reduces, so a warp waits
// for its own copies and meets no other warp at a slot: the warps drift
// apart and hide one another's latencies.  A bfloat16 state whose rows are
// no multiple of 4 bytes, or that starts at an odd element, is loaded
// element by element into the same ring.  A buffer holds [b][c][ncp]
// elements.  A chunk is as
// wide as shared memory allows, up to 16 channels: a run of 16 float32
// channels is two 32-byte sectors of one line, and the cost of a slot
// (barrier, address arithmetic, reduction) is paid once for twice the data.
//
// The reductions of a staged slot need no atomics and no shared
// read-modify-write.  A warp takes one row b; its lane (h, q) owns four
// channels q of the columns h, h + H, ... and loads each owned cell once,
// as one float4 (see stream_reductions):
//   T_bc and M10 (sums over the slots) accumulate in registers and are
//   written once per chunk;
//   T_ab and M6 (sums over c) are summed over the warp's lanes by
//   shuffles that halve what each lane holds, seven or eight a slot;
//   the picks D_bc, D_ac are stored by the lane that holds them.
// T_ab and D_ac are also written transposed (tabT, dacT), which is how the
// products read them (cases 12 and 17).  The block meets at a barrier when
// the empty slots' maps are zeroed, when the maps are complete, and after
// the row sums and the scalars: a number that does not grow with P.
// A field of more than 32 rows gives a thread more cells of a staged slot
// than it keeps registers for; the forward then sums T_bc and M10 in shared
// memory, every cell by its one owner (stream_reductions_wide).
//
// Maps are kept as [row r = x*P + y][channel], ncp = nc rounded up to 4, 8
// or 16 floats a row, so that a product reads four channels of a row, and
// the backward's scatter four channels of one state element, as one float4.
// Channels [nc, ncp) hold zeros or stale finite values; K's rows there are
// staged as zeros.

#pragma once

#include "risi18_common.cuh"

namespace risi18 {
namespace level {

// The stage clock, for tools/stage_clock.py, which builds the kernels with
// -DRISI18_STAGE_CLOCK: at each STAGE(i) the block waits at a barrier and
// the first thread of block (0, 0, 0) adds the cycles since its last mark
// to stage_cycles[i].  Compiled out of every other build.
#ifdef RISI18_STAGE_CLOCK
__device__ long long stage_cycles[16];
#define STAGE_CLOCK_START() long long stage_last = clock64()
#define STAGE(i)                                                         \
  do {                                                                   \
    __syncthreads();                                                     \
    if (!(blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x)) {         \
      const long long now = clock64();                                   \
      risi18::level::stage_cycles[i] += now - stage_last;                \
      stage_last = now;                                                  \
    }                                                                    \
  } while (0)
// Copies the 16 sums to `host` and zeroes them; returns a cudaError_t.
inline int read_stage_cycles(long long* host) {
  const long long zeros[16] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(host, stage_cycles, sizeof(zeros));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(stage_cycles, zeros, sizeof(zeros));
}
#else
#define STAGE_CLOCK_START()
#define STAGE(i)
#endif


constexpr int kThreads = 512;   // one block per SM
constexpr int kMaxA = 2;        // pass A items a thread may own
constexpr int kMaxChunk = 16;   // channels a chunk may hold

// Index of each map in the block's map area.
enum Map { kTab = 0, kTabT, kTbc, kDbc, kDacT, kM6, kM10, kMaps };

// What the stream needs to know, computed on the host.
struct StreamPlan {
  int P, C;
  int Cc;      // channels per chunk
  int ncp;     // Cc rounded up to 4, 8 or 16: channels per row of a map or
               // ring cell
  int D;       // ring depth, 2 to 4
  int unit;    // bytes per cp.async (16, 8 or 4); 0: element-wise loads
  int rowb;    // bytes between rows b of a ring buffer
  int slotb;   // bytes of one ring buffer
  int mapw;    // words of one map, padded
  int wide;    // 1: a thread's cells of a staged slot outnumber the
               // registers kept for them (a field of more than 32 rows):
               // stream_reductions_wide sums them in shared memory
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Whether the cells of a staged slot that a thread owns fit the registers
// it keeps for them: a warp takes a row b (kThreads / 32 rows a round), a
// lane every H-th column, H = 32 / (ncp / 4).
inline bool stream_fits_registers(const StreamPlan& sp) {
  const int H = 32 / (sp.ncp / 4), nwarps = kThreads / 32;
  return ((sp.P + nwarps - 1) / nwarps) * ((sp.P + H - 1) / H) <= kMaxA;
}

// The plan of the stream for element size `es`.  `aligned`: the bytes the
// state's base address is a multiple of (16, 8, 4 or 2).
inline StreamPlan make_stream_plan(int P, int C, int Cc, int D, int es,
                                   int aligned) {
  StreamPlan sp;
  sp.P = P; sp.C = C; sp.Cc = Cc; sp.D = D;
  sp.ncp = Cc <= 4 ? 4 : Cc <= 8 ? 8 : 16;
  int unit = 16;
  while (unit >= 4 && ((C * es) % unit || (Cc * es) % unit || aligned % unit))
    unit /= 2;
  sp.unit = unit >= 4 ? unit : 0;
  sp.rowb = round_up(P * sp.ncp * es, 16);   // a copy's target is aligned
  sp.slotb = P * sp.rowb;
  sp.mapw = round_up(P * P, 4) * sp.ncp + 8;
  sp.wide = !stream_fits_registers(sp);
  return sp;
}

// Words of the ring, the maps, the vectors and the scalars of a chunk.
inline int stream_words(const StreamPlan& sp) {
  return sp.D * sp.slotb / 4 + kMaps * sp.mapw + 4 * sp.P * sp.ncp
         + 4 * sp.ncp;
}

// A block's pointers into its stream area.
struct StreamBuffers {
  char* ring;
  float* maps;     // [kMaps][mapw]
  float* ta;       // [P][ncp]: T_a, then T_b, sum_b T[x,b,b], sum_a T[a,x,a]
  float* tb;
  float* tdbc;
  float* tdac;
  float* tfull;    // [ncp]: sum T, s14, s15, t18
  float* s14;
  float* s15;
  float* t18;
  __device__ float* map(int which, int mapw) const {
    return maps + which * mapw;
  }
};

__device__ inline StreamBuffers stream_buffers(float* at,
                                               const StreamPlan& sp) {
  StreamBuffers s;
  s.ring = reinterpret_cast<char*>(at);
  s.maps = at + sp.D * sp.slotb / 4;
  float* v = s.maps + kMaps * sp.mapw;
  const int n = sp.P * sp.ncp;
  s.ta = v; s.tb = v + n; s.tdbc = v + 2 * n; s.tdac = v + 3 * n;
  float* c = v + 4 * n;
  s.tfull = c; s.s14 = c + sp.ncp; s.s15 = c + 2 * sp.ncp;
  s.t18 = c + 3 * sp.ncp;
  return s;
}

// -- small helpers ----------------------------------------------------------

__device__ inline void cp_async(void* dst, const void* src, int unit,
                                bool present) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = present ? unit : 0;    // source size 0: the copy writes zeros
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's copy groups are in flight.
__device__ inline void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ inline void zero_value(float* p) { *p = 0.f; }
__device__ inline void zero_value(__nv_bfloat16* p) {
  *p = __float2bfloat16_rn(0.f);
}

__device__ inline void fma4(float4& acc, float a, const float4& b) {
  acc.x += a * b.x; acc.y += a * b.y; acc.z += a * b.z; acc.w += a * b.w;
}
__device__ inline float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ inline float get4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ inline void zero_words(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// -- tensor cores -----------------------------------------------------------

// A float as two TF32 values (a 10-bit mantissa each): hi is x with the 13
// low bits of its mantissa cleared, which is how the tensor cores read a
// float; lo is the rest, exact as a float, of which they read the leading
// 11 bits: hi + lo is x to 2^-20 of it.  A product of two floats split so,
// a_lo b_hi + a_hi b_lo + a_hi b_hi, leaves out a_lo b_lo (2^-20 of the
// product): three passes of the tensor cores give the product to 2^-19,
// where one pass would give 2^-10.  Masks and a subtraction, no cvt: the
// conversion unit takes a quarter of a warp a cycle, and a split per
// operand would make it the bound of the product.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: mma.sync m16n8k8, TF32 operands, float32
// accumulators.  With g = lane / 4 and t = lane % 4 a lane holds
//   a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]     (A is 16 x 8)
//   b[0..1] = B[t][g], B[t+4][g]                             (B is 8 x 8)
//   d[0..3] = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1] (D is 16 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Three passes: d += a b for operands split by split_tf32, the small terms
// first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// -- the stream -------------------------------------------------------------

// The slots of a vertex that hold anything: slots[0..n) are the a whose
// neighbour is present and that have a position set, in order, and
// slots[P] = n.  An empty slot reads zeros everywhere, so it is neither
// copied nor reduced (a prepared graph pads every field to P slots).  After
// load_vertex; ends with a barrier.
__device__ inline void list_slots(const int* snbr, const int* spos, int P,
                                  int* slots) {
  for (int a = threadIdx.x; a < P; a += blockDim.x) {
    bool any = false;
    for (int b = 0; b < P; ++b) any |= spos[a * P + b] >= 0;
    slots[a] = snbr[a] >= 0 && any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int a = 0; a < P; ++a)
      if (slots[a]) slots[n++] = a;     // n <= a: read before overwritten
    slots[P] = n;
  }
  __syncthreads();
}


// The copies one thread starts per slot.  A warp copies the rows b of a
// slot that it reduces (b = warp, warp + nwarps, ...: stream_reductions), so
// that a staged row is written and read by one warp and the ring needs no
// barrier of the block; a row's P * upc copies go round the warp's lanes.
// Item k of a thread -> (row b, column c, unit u) does not depend on the
// slot, so the first kMaxA items are decoded once per chunk (b < 0: none).
struct CopyItems {
  int b[kMaxA], c[kMaxA];
  int dst[kMaxA];   // byte offset in a ring buffer
  int src[kMaxA];   // byte offset from the element (n, p1, p2, 0)
  int upc;          // copies per (b, c)
  int per_lane;     // copies of one row per lane
  int items;        // items of a thread, over its rows
  int c0;           // first channel of the chunk
};

// Item k of this thread: false if it is none.
template <typename E>
__device__ __forceinline__ bool copy_item(const StreamPlan& sp,
                                          const CopyItems& ci, int k, int& b,
                                          int& c, int& dst, int& src) {
  const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
  const int nwarps = blockDim.x / 32;
  const int idx = threadIdx.x % 32 + 32 * (k % ci.per_lane);
  const int u = idx % ci.upc;
  b = threadIdx.x / 32 + nwarps * (k / ci.per_lane);
  c = idx / ci.upc;
  dst = b * sp.rowb + c * sp.ncp * es + u * step;
  src = ci.c0 * es + u * step;
  return b < sp.P && c < sp.P;
}

template <typename E>
__device__ inline CopyItems copy_items(const StreamPlan& sp, int c0, int nc) {
  const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
  const int nwarps = blockDim.x / 32;
  CopyItems ci;
  ci.upc = nc * es / step;
  ci.per_lane = (sp.P * ci.upc + 31) / 32;
  ci.items = (sp.P + nwarps - 1) / nwarps * ci.per_lane;
  ci.c0 = c0;
#pragma unroll
  for (int j = 0; j < kMaxA; ++j) {
    const bool any = copy_item<E>(sp, ci, j, ci.b[j], ci.c[j], ci.dst[j],
                                  ci.src[j]);
    if (!any || j >= ci.items) ci.b[j] = -1;
  }
  return ci;
}

// One copy of slot a (neighbour n, positions row `pos_a`): `step` bytes of
// the run (b, c) to buf + dst, or zeros when absent.
template <typename E>
__device__ __forceinline__ void copy_run(const E* __restrict__ state,
                                         const int* pos_a,
                                         const StreamPlan& sp, char* buf,
                                         int n, int b, int c, int dst,
                                         int src) {
  const int p1 = pos_a[b], p2 = pos_a[c];
  const bool present = (n | p1 | p2) >= 0;
  const char* from = reinterpret_cast<const char*>(state);
  // The element's index fits an int (the state has under 2^31 elements a
  // channel); one widening multiply makes the byte offset.
  if (present)
    from += (size_t)((n * sp.P + p1) * sp.P + p2) * (sp.C * sizeof(E)) + src;
  if (sp.unit) {
    cp_async(buf + dst, from, sp.unit, present);
  } else {
    E* to = reinterpret_cast<E*>(buf + dst);
    if (present) *to = __ldg(reinterpret_cast<const E*>(from));
    else zero_value(to);
  }
}

// Starts the copy of slot a's chunk into the ring buffer `buf`.
template <typename E>
__device__ __forceinline__ void issue_slot(const E* __restrict__ state,
                                           const int* snbr, const int* spos,
                                           const StreamPlan& sp, char* buf,
                                           int a, const CopyItems& ci) {
  const int n = snbr[a];
  const int* pos_a = spos + a * sp.P;
#pragma unroll
  for (int j = 0; j < kMaxA; ++j)
    if (ci.b[j] >= 0)
      copy_run(state, pos_a, sp, buf, n, ci.b[j], ci.c[j], ci.dst[j],
               ci.src[j]);
  for (int k = kMaxA; k < ci.items; ++k) {
    int b, c, dst, src;
    if (copy_item<E>(sp, ci, k, b, c, dst, src))
      copy_run(state, pos_a, sp, buf, n, b, c, dst, src);
  }
}

// Starts the copies of the first D - 1 slots of a chunk.  The caller may
// do other work before stream_reductions, which waits for them.
template <typename E>
__device__ inline void stream_prologue(const E* __restrict__ state,
                                       const int* snbr, const int* spos,
                                       const int* slots,
                                       const StreamPlan& sp,
                                       const StreamBuffers& s, int c0,
                                       int nc) {
  const CopyItems ci = copy_items<E>(sp, c0, nc);
  const int n = slots[sp.P];
  for (int i = 0; i < sp.D - 1; ++i) {
    if (i < n)
      issue_slot(state, snbr, spos, sp, s.ring + i * sp.slotb, slots[i], ci);
    cp_async_commit();
  }
}

// The sum over the H = 32 / quads lanes of a warp that share q = lane %
// quads, of the eight values (t, w).  Three steps halve what a lane keeps
// (it sends the half its partner keeps), so that seven shuffles do the work
// of twenty-four; further steps add the one value left.  Returns the total
// of value `which` = 4 * bit0 + 2 * bit1 + bit2 of h = lane / quads
// (0..3: t.x..t.w, 4..7: w.x..w.w), the same in lanes that differ in h's
// higher bits.
__device__ __forceinline__ float reduce_over_columns(const float4& t,
                                                     const float4& w,
                                                     int h, int quads) {
  const bool b0 = h & 1, b1 = h & 2, b2 = h & 4;
  // keep + what the partner `mask` lanes away sends.
  auto step = [](float keep, float send, int mask) {
    return keep + __shfl_xor_sync(0xffffffffu, send, mask);
  };
  const float u0 = step(b0 ? w.x : t.x, b0 ? t.x : w.x, quads);
  const float u1 = step(b0 ? w.y : t.y, b0 ? t.y : w.y, quads);
  const float u2 = step(b0 ? w.z : t.z, b0 ? t.z : w.z, quads);
  const float u3 = step(b0 ? w.w : t.w, b0 ? t.w : w.w, quads);
  const float p0 = step(b1 ? u2 : u0, b1 ? u0 : u2, 2 * quads);
  const float p1 = step(b1 ? u3 : u1, b1 ? u1 : u3, 2 * quads);
  float z = step(b2 ? p1 : p0, b2 ? p0 : p1, 4 * quads);
  for (int m = 8 * quads; m < 32; m *= 2) z = step(z, z, m);
  return z;
}

// The vectors and scalars of a chunk from its complete maps; the caller's
// barrier stands between the maps' writers and this.  Ends with a barrier.
__device__ inline void stream_row_sums(const StreamPlan& sp,
                                       const StreamBuffers& s) {
  const int P = sp.P, ncp = sp.ncp;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* tab = s.map(kTab, sp.mapw);
  const float* tabT = s.map(kTabT, sp.mapw);
  const float* dbc = s.map(kDbc, sp.mapw);
  const float* dacT = s.map(kDacT, sp.mapw);
  // Row sums: T_a[x] = sum_b T_ab[x,b], T_b[x] = sum_a T_ab[a,x],
  // sum_b T[x,b,b], sum_a T[a,x,a].
  for (int item = tid; item < P * ncp; item += nth) {
    const int f = item % ncp, x = item / ncp;
    float ta = 0.f, tb = 0.f, td = 0.f, te = 0.f;
#pragma unroll 4
    for (int y = 0; y < P; ++y) {
      const int at = (x * P + y) * ncp + f;
      ta += tab[at]; tb += tabT[at]; td += dbc[at]; te += dacT[at];
    }
    s.ta[item] = ta; s.tb[item] = tb; s.tdbc[item] = td; s.tdac[item] = te;
  }
  __syncthreads();
  // Per-channel scalars.
  for (int f = tid; f < ncp; f += nth) {
    float tf = 0.f, s14 = 0.f, s15 = 0.f, t18 = 0.f;
    for (int x = 0; x < P; ++x) {
      tf += s.ta[x * ncp + f];
      s14 += tab[(x * P + x) * ncp + f];   // sum_{a,c} T[a,a,c]
      s15 += s.tdbc[x * ncp + f];          // sum_{a,b} T[a,b,b]
      t18 += dbc[(x * P + x) * ncp + f];   // sum_a T[a,a,a]
    }
    s.tfull[f] = tf; s.s14[f] = s14; s.s15[f] = s15; s.t18[f] = t18;
  }
  __syncthreads();
}

// Streams the listed slots of one vertex for the chunk [c0, c0 + nc), after
// stream_prologue, and leaves the chunk's maps, vectors and scalars in `s`.
// The caller has loaded snbr, spos and R (load_vertex), listed the slots
// (list_slots), and no thread still reads s's maps.  Ends with a barrier.
//
// A warp takes one row b of a staged slot (a second one, 16 further, where
// P > 16): its lane h * quads + q owns four channels q of the columns h,
// h + H, ... (H = 32 / quads).  One float4 load per owned cell feeds both
// passes: T_bc and M10 add up in registers over the slots (pass A); T_ab
// and M6 are the cell's sum over the warp's columns (pass B), and the lane
// that holds column b or column a stores D_bc or D_ac as it is.
template <typename E>
__device__ inline void stream_reductions(const E* __restrict__ state,
                                         const int* snbr, const int* spos,
                                         const int* slots, const float* R,
                                         const StreamPlan& sp,
                                         const StreamBuffers& s, int c0,
                                         int nc) {
  const int P = sp.P, ncp = sp.ncp, D = sp.D, n = slots[P];
  const int tid = threadIdx.x, nth = blockDim.x, nwarps = nth / 32;
  const int quads = ncp / 4, H = 32 / quads;
  const int lane = tid & 31, q = lane & (quads - 1), h = lane / quads;
  float* tab = s.map(kTab, sp.mapw);
  float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m6 = s.map(kM6, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);
  const CopyItems ci = copy_items<E>(sp, c0, nc);

  // The cells this thread owns: k -> (round rd, column j), row b = warp +
  // nwarps * rd, column c = h + H * j (stream_fits_registers: they fit).
  const int jn = (P + H - 1) / H, rounds = (P + nwarps - 1) / nwarps;
  float4 acc_tbc[kMaxA], acc_m10[kMaxA];
  int cell[kMaxA];          // byte offset in a ring buffer, -1: none
  int cell_b[kMaxA], cell_c[kMaxA];
  float cell_r[kMaxA];      // R[c]
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    acc_tbc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_m10[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int b = tid / 32 + nwarps * (k / jn), c = h + H * (k % jn);
    const bool owned = k < rounds * jn && b < P && c < P;
    cell_b[k] = b; cell_c[k] = c;
    cell[k] = owned ? b * sp.rowb + (c * ncp + 4 * q) * (int)sizeof(E) : -1;
    cell_r[k] = owned ? R[c] : 0.f;
  }
  // The value of (t, w) that this lane ends up with in the reduction.
  const int which = 4 * (h & 1) + (h & 2) + ((h & 4) >> 2);

  // The slot-indexed maps of the empty slots are zeros (the barrier orders
  // these writes before the listed slots').
  if (n < P) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < P * P * quads; i += nth) {
      *reinterpret_cast<float4*>(tab + 4 * i) = zero;
      *reinterpret_cast<float4*>(tabT + 4 * i) = zero;
      *reinterpret_cast<float4*>(m6 + 4 * i) = zero;
      *reinterpret_cast<float4*>(dbc + 4 * i) = zero;
      *reinterpret_cast<float4*>(dacT + 4 * i) = zero;
    }
    __syncthreads();
  }

  int stage = 0, ahead = (D - 1) % D;    // ring buffers of slots i, i + D - 1
  for (int i = 0; i < n; ++i) {
    // Slot i has landed for this thread; the warp's barrier makes its lanes'
    // copies of the warp's rows visible to one another and frees the rows
    // that slot i - 1 was read from.  No other warp touches these rows.
    cp_async_wait(D - 2);
    __syncwarp();
    if (i + D - 1 < n)
      issue_slot(state, snbr, spos, sp, s.ring + ahead * sp.slotb,
                 slots[i + D - 1], ci);
    cp_async_commit();
    const int a = slots[i];
    const char* buf = s.ring + stage * sp.slotb;
    stage = stage + 1 == D ? 0 : stage + 1;
    ahead = ahead + 1 == D ? 0 : ahead + 1;

    const float ra = R[a];
    float4 t[kMaxA], w[kMaxA];
#pragma unroll
    for (int k = 0; k < kMaxA; ++k) {
      t[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      w[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cell[k] >= 0) {
        const float4 x = load4(reinterpret_cast<const E*>(buf + cell[k]));
        // Pass A: T_bc[b,c] += T[a,b,c], M10[b,c] += R[a] T[a,b,c].
        fma4(acc_tbc[k], 1.f, x);
        fma4(acc_m10[k], ra, x);
        // Pass B: this cell's part of T_ab[a,b] and M6[a,b]; the picks
        // D_bc[a,b] = T[a,b,b] and D_ac[a,b] = T[a,b,a].
        t[k] = x;
        fma4(w[k], cell_r[k], x);
        const int b = cell_b[k], c = cell_c[k];
        if (c == b)
          *reinterpret_cast<float4*>(dbc + (a * P + b) * ncp + 4 * q) = x;
        if (c == a)
          *reinterpret_cast<float4*>(dacT + (b * P + a) * ncp + 4 * q) = x;
      }
    }
    for (int rd = 0; rd < rounds; ++rd) {
      const int b = tid / 32 + nwarps * rd;
      if (b >= P) break;                      // the whole warp leaves
      float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), ws = ts;
#pragma unroll
      for (int k = 0; k < kMaxA; ++k) {
        if (k / jn == rd) { fma4(ts, 1.f, t[k]); fma4(ws, 1.f, w[k]); }
      }
      const float z = reduce_over_columns(ts, ws, h, quads);
      if (h < 8) {
        const int ch = 4 * q + (which & 3);
        const int ab = (a * P + b) * ncp + ch, ba = (b * P + a) * ncp + ch;
        if (which < 4) { tab[ab] = z; tabT[ba] = z; } else m6[ab] = z;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    if (cell[k] >= 0) {
      const int at = (cell_b[k] * P + cell_c[k]) * ncp + 4 * q;
      *reinterpret_cast<float4*>(tbc + at) = acc_tbc[k];
      *reinterpret_cast<float4*>(m10 + at) = acc_m10[k];
    }
  }
  __syncthreads();

  stream_row_sums(sp, s);
}

// stream_reductions for a plan that is `wide`: a warp takes the rows b =
// warp, warp + nwarps, ... of a staged slot and its lane the columns h,
// h + H, ..., as many as the field has, and each thread adds its cells to
// T_bc and M10 in shared memory, where every cell has one owner, instead of
// in registers.  A slower loop for fields that few graphs have; the forward
// has a kernel of its own for it, so that no other kernel's registers
// depend on it.
template <typename E>
__device__ inline void stream_reductions_wide(
    const E* __restrict__ state, const int* snbr, const int* spos,
    const int* slots, const float* R, const StreamPlan& sp,
    const StreamBuffers& s, int c0, int nc) {
  const int P = sp.P, ncp = sp.ncp, D = sp.D, n = slots[P];
  const int tid = threadIdx.x, nth = blockDim.x, nwarps = nth / 32;
  const int quads = ncp / 4, H = 32 / quads;
  const int lane = tid & 31, q = lane & (quads - 1), h = lane / quads;
  float* tab = s.map(kTab, sp.mapw);
  float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m6 = s.map(kM6, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);
  const CopyItems ci = copy_items<E>(sp, c0, nc);
  const int which = 4 * (h & 1) + (h & 2) + ((h & 4) >> 2);

  for (int i = tid; i < kMaps * sp.mapw; i += nth) s.maps[i] = 0.f;
  __syncthreads();

  int stage = 0, ahead = (D - 1) % D;
  for (int i = 0; i < n; ++i) {
    cp_async_wait(D - 2);
    __syncwarp();
    if (i + D - 1 < n)
      issue_slot(state, snbr, spos, sp, s.ring + ahead * sp.slotb,
                 slots[i + D - 1], ci);
    cp_async_commit();
    const int a = slots[i];
    const char* buf = s.ring + stage * sp.slotb;
    stage = stage + 1 == D ? 0 : stage + 1;
    ahead = ahead + 1 == D ? 0 : ahead + 1;
    const float ra = R[a];
    for (int b = tid / 32; b < P; b += nwarps) {   // the whole warp together
      float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), ws = ts;
      for (int c = h; c < P; c += H) {
        const float4 x = load4(reinterpret_cast<const E*>(
            buf + b * sp.rowb + (c * ncp + 4 * q) * (int)sizeof(E)));
        const int at = (b * P + c) * ncp + 4 * q;
        float4 sum = load4(tbc + at), weighted = load4(m10 + at);
        fma4(sum, 1.f, x);
        fma4(weighted, ra, x);
        *reinterpret_cast<float4*>(tbc + at) = sum;
        *reinterpret_cast<float4*>(m10 + at) = weighted;
        fma4(ts, 1.f, x);
        fma4(ws, R[c], x);
        if (c == b)
          *reinterpret_cast<float4*>(dbc + (a * P + b) * ncp + 4 * q) = x;
        if (c == a)
          *reinterpret_cast<float4*>(dacT + (b * P + a) * ncp + 4 * q) = x;
      }
      const float z = reduce_over_columns(ts, ws, h, quads);
      if (h < 8) {
        const int ch = 4 * q + (which & 3);
        const int ab = (a * P + b) * ncp + ch, ba = (b * P + a) * ncp + ch;
        if (which < 4) { tab[ab] = z; tabT[ba] = z; } else m6[ab] = z;
      }
    }
  }
  __syncthreads();
  stream_row_sums(sp, s);
}

}  // namespace level
}  // namespace risi18
