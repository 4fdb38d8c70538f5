// Device code of the stream that every block of the package runs: the
// forward block (risi18_forward_block.cuh: K1, K4, K6) and the backward
// block (risi18_backward_block.cuh: K2 kernel 1, K5 kernel 1).  The
// asynchronous slot stream with the shared reductions of one channel chunk,
// the tensor cores' three-pass product, and the small helpers they use.  The
// vertex's structure (load_vertex, load_adjacency) and the element types
// come from risi18_common.cuh.
//
// The stream.  Slot a of a vertex, for the chunk's channels [c0, c0 + nc),
// is P*P runs of nc contiguous elements, one per (b, c): gathered
// (GatheredSlots, K1 and K2) from state[nbr[a], pos[a,b], pos[a,c],
// c0:c0+nc], or materialised (StoredSlots, K4, K5, K6) as T[v,a,b,c,
// c0:c0+nc].  Every thread of the block copies runs with
// cp.async (16 bytes a copy where the chunk and C allow it, else 8 or 4; a
// run that is absent is zero-filled by a copy of source size 0) into a ring
// of D slot buffers in shared memory, so that D - 1 slots are in flight
// while one is reduced.  A warp copies the rows it reduces, so a warp waits
// for its own copies and meets no other warp at a slot: the warps drift
// apart and hide one another's latencies.  A bfloat16 source whose rows are
// no multiple of 4 bytes, or that starts at an odd element, is loaded
// element by element into the same ring.  A buffer holds [b][c][ncp]
// elements.  A chunk is as
// wide as shared memory allows, up to 16 channels: a run of 16 float32
// channels is two 32-byte sectors of one line, and the cost of a slot
// (barrier, address arithmetic, reduction) is paid once for twice the data.
// A gathered stream reads the state from L2 (8 MB at N=256); a
// materialised one reads T from device memory (134 MB at N=256 in float32),
// which L2 does not hold.
//
// The tensor-copy route (sp.tma: a cluster plan of K1 or K2 whose chunk
// and C are multiples of 16 bytes, whose state is 16-byte aligned and whose
// row tile has fewer rows than the block has warps: make_stream_plan).  Row
// b of gathered slot a is state[n, p1, pos[a, c], c0:c0+nc] for c =
// 0..P-1 (n = nbr[a], p1 = pos[a, b]): a permutation of the columns of one
// contiguous row of the neighbour's block, state[n, p1, 0:P, c0:c0+ncp], P
// cells at a stride of C elements, the same permutation pos[a, .] for every
// row b of the slot.  So the row is copied in storage order by one TMA copy
// of a {ncp, P} box of the state seen as [N*P*P rows, C channels] (channels
// past C come back as zeros), and its reader applies the permutation.  One
// producer warp issues every row's copy, up to D stages ahead, through a
// ring of D buffers with a full and an empty mbarrier each; the other warps
// only reduce (stream_rows_producer, tile_reductions).  A row whose p1 is
// absent is not copied and adds nothing.  Where the cp.async route pays the
// index arithmetic, the absence tests and the issue of one 16-byte copy per
// cell (128 copies a row of 64 cells of 8 float32 channels), this route
// issues one instruction a row, in a warp of its own.

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

#include <cuda.h>   // CUtensorMap (its encoder is reached through the runtime)
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "risi18_common.cuh"

namespace risi18 {
namespace level {

// The stage clock, for tools/stage_clock.py, which builds the kernels with
// -DRISI18_STAGE_CLOCK: at each STAGE(i) the block waits at a barrier and
// the first thread of block (0, 0, 0) adds the cycles since its last mark
// to stage_cycles[i].  Compiled out of every other build.
#ifdef RISI18_STAGE_CLOCK
__device__ long long stage_cycles[24];
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
// Copies the 24 sums to `host` and zeroes them; returns a cudaError_t.
inline int read_stage_cycles(long long* host) {
  const long long zeros[24] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(host, stage_cycles, sizeof(zeros));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(stage_cycles, zeros, sizeof(zeros));
}
// The row-tiled stream (stream_pieces) adds, without a barrier of its
// own, the cycles thread 0 of block (0, 0, 0) spends per stage (a ring
// buffer's pieces) waiting for the stage's copies and the block, issuing
// the next stage's copies and reducing the stage, to
// stage_cycles[kPieceWait..kPieceReduce], and the stages to
// stage_cycles[kPieces].
// On the tensor-copy route (stream_rows_producer) thread 0 is a consumer:
// it adds its cycles a stage waiting on the full mbarrier and reducing, and
// those it spends arriving on the empty one to stage_cycles[
// kConsumerRelease]; lane 0 of the producer warp adds its cycles waiting on
// the empty mbarrier and issuing the stage's copies, and its stages, to
// stage_cycles[kProducerWait..kProducerStages].
// The cluster plans' dT pass (dT_pass) adds thread 0's cycles in the
// tiles' maps (to the barrier after them) and in their scatter or dT
// written (to the next barrier) to stage_cycles[kDTMaps], [kDTScatter];
// on the staged scatter (dT_stage_rows) thread 0, which issues its warp's
// rows, adds its cycles waiting for a staging buffer, staging its rows and
// issuing their tensor reduces, and its rows, to [kScatterWait ..
// kScatterRows].
enum { kPieceWait = 10, kPieceIssue, kPieceReduce, kPieces,
       kConsumerRelease, kProducerWait, kProducerIssue, kProducerStages,
       kDTMaps, kDTScatter, kScatterWait, kScatterStage, kScatterIssue,
       kScatterRows };
#define PIECE_MARK(t) const long long t = clock64()
#define PIECE_ADD(i, d)                                                  \
  do {                                                                   \
    if (!(blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x))           \
      risi18::level::stage_cycles[i] += (d);                             \
  } while (0)
#define PRODUCER_ADD(i, d)                                               \
  do {                                                                   \
    if (!(blockIdx.x | blockIdx.y | blockIdx.z) &&                       \
        threadIdx.x == 32 * risi18::level::kProducerWarp)                \
      risi18::level::stage_cycles[i] += (d);                             \
  } while (0)
// A lap clock of thread 0 of block (0, 0, 0): CLOCK_LAP(i, v) adds the
// cycles since v (CLOCK_VAR) or the last lap to stage_cycles[i].
#define CLOCK_VAR(v) long long v = clock64()
#define CLOCK_LAP(i, v)                                                  \
  do {                                                                   \
    const long long lap_now = clock64();                                 \
    PIECE_ADD(i, lap_now - (v));                                         \
    (v) = lap_now;                                                       \
  } while (0)
#else
#define STAGE_CLOCK_START()
#define STAGE(i)
#define PIECE_MARK(t)
#define PIECE_ADD(i, d)
#define PRODUCER_ADD(i, d)
#define CLOCK_VAR(v)
#define CLOCK_LAP(i, v)
#endif

// The SASS marks, for tools/sass_count.py, which builds K1 with
// -DRISI18_SASS_MARK: a NANOSLEEP where a tensor-copy consumer's row
// reduction starts and one where its sum over the lanes starts, so that the
// instructions of its cells can be counted in cuobjdump's listing between
// them.  Compiled out of every other build.
#ifdef RISI18_SASS_MARK
#define SASS_MARK() asm volatile("nanosleep.u32 0;\n" ::: "memory")
#else
#define SASS_MARK()
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
  int rows;    // rows of the maps: P, or the rows X of a row tile (a
               // row-tiled plan: see tile_reductions)
  int tma;     // 1: a gathered row arrives by one tensor copy that a
               // producer warp issues (stream_rows_producer); 0: by
               // cp.async, cell by cell
  int no_producer;  // 1: the tensor-copy route but for a warp left for
                    // its producer (a row tile of a row a warp): the
                    // planners pass such a tile over for a smaller one
  // A ring buffer holds pieces(sp) pieces of `rows` rows: 1, or in a
  // row-tiled plan whose warps keep their cells of T_bc and M10 in
  // registers, up to kThreads / 32 / rows (tile_reductions; on the
  // tensor-copy route up to (kThreads / 32 - 1) / rows, one warp being the
  // producer).  It is kept in slotb, so that the untiled blocks' plan keeps
  // its layout.
};

__host__ __device__ inline int pieces(const StreamPlan& sp) {
  return sp.slotb / (sp.rows * sp.rowb);
}

constexpr int kMaxCells = 4;   // cells of a row a lane keeps in registers

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The bytes a pointer is aligned to, up to 16.
inline int alignment_of(const void* p) {
  const size_t a = (size_t)p;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

// Whether the cells of a staged slot that a thread owns fit the registers
// it keeps for them: a warp takes a row b (kThreads / 32 rows a round), a
// lane every H-th column, H = 32 / (ncp / 4).
inline bool stream_fits_registers(const StreamPlan& sp) {
  const int H = 32 / (sp.ncp / 4), nwarps = kThreads / 32;
  return ((sp.P + nwarps - 1) / nwarps) * ((sp.P + H - 1) / H) <= kMaxA;
}

// Whether a row-tiled plan's warps keep their cells of T_bc and M10 in
// registers (tile_reductions): then a warp reduces one row of each stage.
__host__ __device__ inline bool tile_regs(const StreamPlan& sp);

// Bytes a tensor copy's destination is aligned to in shared memory.
constexpr int kTmaAlign = 128;

// The plan of the stream for element size `es`.  `aligned`: the bytes the
// state's base address is a multiple of (16, 8, 4 or 2).  `rows`: the rows
// of a row tile, 0 for none (every row: a buffer holds a whole slot).
// `gathered_rows`: the block gathers its slots and a warp reduces whole
// rows (a cluster plan of K1 or K2); the stream then takes the tensor-copy
// route where the plan allows it (tile_regs: a warp reduces a row; fewer
// rows a tile than warps, so that one warp can be the producer; a row's box
// of ncp channels and the state's rows of C channels multiples of 16
// bytes; the state 16-byte aligned), whatever the data.  A tile of a row a
// warp that meets the rest is marked no_producer, and the planners take a
// smaller one: K1 at (64,64,8,4) in float32 took 0.71 ms on cp.async in
// tiles of 16 rows, 0.30 on the tensor copies in tiles of 4 (an H100;
// PERF.md).
inline StreamPlan make_stream_plan(int P, int C, int Cc, int D, int es,
                                   int aligned, int rows = 0, int G = 0,
                                   bool gathered_rows = false) {
  StreamPlan sp;
  sp.P = P; sp.C = C; sp.Cc = Cc; sp.D = D;
  sp.rows = rows > 0 ? rows : P;
  sp.ncp = Cc <= 4 ? 4 : Cc <= 8 ? 8 : 16;
  const int nwarps = kThreads / 32, H = 32 / (sp.ncp / 4);
  const bool copies = gathered_rows && rows > 0 && tile_regs(sp) &&
                      (sp.ncp * es) % 16 == 0 && (C * es) % 16 == 0 &&
                      aligned % 16 == 0;
  sp.tma = copies && rows < nwarps;
  sp.no_producer = copies && !sp.tma;
  // A row tile of at most one row a warp whose lanes keep their cells of a
  // row (every H-th column, H = 32 / (ncp / 4)) in registers: a ring
  // buffer can then hold a piece for every group of `rows` reducing warps,
  // G of them (0: all); on the tensor-copy route one warp is the producer.
  const int most = rows > 0 && rows <= nwarps && (P + H - 1) / H <= kMaxCells
                       ? (sp.tma ? nwarps - 1 : nwarps) / rows : 1;
  G = G > 0 && G < most ? G : most;
  int unit = 16;
  while (unit >= 4 && ((C * es) % unit || (Cc * es) % unit || aligned % unit))
    unit /= 2;
  sp.unit = unit >= 4 ? unit : 0;
  // A copy's target is aligned: 16 bytes for cp.async, 128 for a tensor
  // copy.
  sp.rowb = round_up(P * sp.ncp * es, sp.tma ? kTmaAlign : 16);
  sp.slotb = G * sp.rows * sp.rowb;
  sp.mapw = round_up(sp.rows * P, 4) * sp.ncp + 8;
  sp.wide = !stream_fits_registers(sp);
  return sp;
}

// Words of the tensor-copy route's piece list and whole slots' weights
// (tile_reductions), 0 on the cp.async route: a tile streams fewer than 2P
// pieces (P slots' rows X, and the other rows of at most `rows` slots), and
// a whole slot has a weight pair a storage column.
__host__ __device__ inline int producer_words(const StreamPlan& sp) {
  return sp.tma ? 2 * sp.P + 2 * sp.rows * sp.P : 0;
}

// Words of the ring, the maps, the vectors and the scalars of a chunk (and
// producer_words).
inline int stream_words(const StreamPlan& sp) {
  return sp.D * sp.slotb / 4 + kMaps * sp.mapw + 4 * sp.rows * sp.ncp
         + 4 * sp.ncp + producer_words(sp);
}

// A block's pointers into its stream area.
struct StreamBuffers {
  char* ring;
  float* maps;     // [kMaps][mapw]
  float* ta;       // [rows][ncp]: T_a, then T_b, sum_b T[x,b,b],
                   // sum_a T[a,x,a]
  float* tb;
  float* tdbc;
  float* tdac;
  float* tfull;    // [ncp]: sum T, s14, s15, t18
  float* s14;
  float* s15;
  float* t18;
  int* plist;      // [< 2P]: the tile's pieces (tma; piece_entry)
  float2* wts;     // [rows][P]: a whole slot's weights a storage column
                   // (tma; tile_reductions)
  uint64_t* bars;  // [2][D]: the ring's full and empty mbarriers (tma)
  __device__ float* map(int which, int mapw) const {
    return maps + which * mapw;
  }
};

// The ring's words.
__host__ __device__ inline int ring_words(const StreamPlan& sp) {
  return sp.D * sp.slotb / 4;
}

// Words of the mbarriers of a stream on the tensor-copy route (a full and
// an empty one for each ring buffer), 0 on the cp.async route.
__host__ __device__ inline int barrier_words(const StreamPlan& sp) {
  return sp.tma ? 4 * sp.D : 0;
}

// The buffers of a stream area at `at`: the ring, then the maps, vectors,
// scalars (and the piece list and weights); or, with `ring` given, the ring
// there and the rest at `at` (stream_words(sp) - ring_words(sp) words);
// with `lists` given, the piece list and weights there (producer_words(sp)
// words fewer at `at`).  `bars`: the ring's mbarriers (barrier_words),
// where the stream takes the tensor copies.
__device__ inline StreamBuffers stream_buffers(float* at,
                                               const StreamPlan& sp,
                                               float* ring = nullptr,
                                               float* bars = nullptr,
                                               float* lists = nullptr) {
  StreamBuffers s;
  s.bars = reinterpret_cast<uint64_t*>(bars);
  s.ring = reinterpret_cast<char*>(ring ? ring : at);
  s.maps = ring ? at : at + ring_words(sp);
  float* v = s.maps + kMaps * sp.mapw;
  const int n = sp.rows * sp.ncp;
  s.ta = v; s.tb = v + n; s.tdbc = v + 2 * n; s.tdac = v + 3 * n;
  float* c = v + 4 * n;
  s.tfull = c; s.s14 = c + sp.ncp; s.s15 = c + 2 * sp.ncp;
  s.t18 = c + 3 * sp.ncp;
  s.plist = reinterpret_cast<int*>(lists ? lists : c + 4 * sp.ncp);
  s.wts = reinterpret_cast<float2*>(s.plist + 2 * sp.P);
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

// -- tensor copies and mbarriers (the tensor-copy route) --------------------

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// An mbarrier that completes a phase at `count` arrivals and the bytes they
// expect.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_address(bar)), "r"(count) : "memory");
}

// Frees the mbarrier's word for other use; nothing may be pending on it.
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n"
               :: "r"(smem_address(bar)) : "memory");
}

// Makes the initialised mbarriers visible to the tensor copies.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier writes to shared memory before the tensor
// copies (the async proxy) that a later barrier lets start.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_address(bar)) : "memory");
}

// One arrival that also expects `bytes` of tensor copies (0: none).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_address(bar)), "r"(bytes) : "memory");
}

// Waits until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned at = smem_address(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(at), "r"(parity) : "memory");
  }
}

// The box of `map` at (column x, row y) added element by element into the
// tensor from `src` (kTmaAlign-aligned; each element's add is atomic, as a
// relaxed reduction at gpu scope), in this thread's open bulk group.
// Elements of the box outside the tensor are not written.  The caller has
// fenced the writes to `src` (fence_proxy_async) behind a barrier.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int x,
                                                  int y) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(src)),
         "r"(x), "r"(y)
      : "memory");
}

// Closes this thread's open bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0 to 3) of this thread's bulk groups
// still read their shared memory.
__device__ __forceinline__ void bulk_wait_read(int pending) {
  if (pending >= 3)
    asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until every bulk group of this thread has completed, its writes
// to global memory included.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The box of `map` at (column x, row y) into `dst` (kTmaAlign-aligned),
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_address(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_address(bar)), "r"(x), "r"(y)
      : "memory");
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

// One copy of `step` bytes from `from` to buf + dst, or zeros when absent.
template <typename E>
__device__ __forceinline__ void copy_unit(const StreamPlan& sp, char* buf,
                                          int dst, const char* from,
                                          bool present) {
  if (sp.unit) {
    cp_async(buf + dst, from, sp.unit, present);
  } else {
    E* to = reinterpret_cast<E*>(buf + dst);
    if (present) *to = __ldg(reinterpret_cast<const E*>(from));
    else zero_value(to);
  }
}

// Items (row bl, column c, part u) of a piece of sp.rows rows, sub parts a
// cell, item i = (bl * P + c) * sub + u: a thread's first kRowItems items
// (i = tid, tid + blockDim.x, ...) decoded once per stream, so that the
// loops over a piece need no division.  bl = kNoRow: no item.
constexpr int kRowItems = 4;
constexpr int kNoRow = 1 << 30;

struct RowItems {
  int sub;
  int bl[kRowItems], c[kRowItems], u[kRowItems];
};

__device__ inline RowItems row_items(const StreamPlan& sp, int sub) {
  RowItems it;
  it.sub = sub;
  const int total = sp.rows * sp.P * sub;
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    const int i = threadIdx.x + blockDim.x * k;
    it.u[k] = i % sub;
    it.c[k] = i / sub % sp.P;
    it.bl[k] = i < total ? i / sub / sp.P : kNoRow;
  }
  return it;
}

// fn(bl, c, u) for this thread's items of a piece of nb rows.
template <typename Fn>
__device__ __forceinline__ void for_row_items(const StreamPlan& sp,
                                              const RowItems& it, int nb,
                                              Fn fn) {
#pragma unroll
  for (int k = 0; k < kRowItems; ++k)
    if (it.bl[k] < nb) fn(it.bl[k], it.c[k], it.u[k]);
  for (int i = threadIdx.x + blockDim.x * kRowItems; i < nb * sp.P * it.sub;
       i += blockDim.x)
    fn(i / it.sub / sp.P, i / it.sub % sp.P, i % it.sub);
}

// The copy units of a run of nc elements of type E.
template <typename E>
__device__ inline int units_of(const StreamPlan& sp, int nc) {
  const int es = (int)sizeof(E);
  return nc * es / (sp.unit ? sp.unit : es);
}

// -- where the slots come from ----------------------------------------------
// A source of slots gives the number of slots a stream walks (count), the a
// of the i-th (slot) and starts the copies of slot a's chunk into a ring
// buffer (issue).

// Gathered from the state (K1, K2): slot a is state[nbr[a], pos[a,b],
// pos[a,c], :] for every (b, c), zero where the neighbour or a position is
// absent; only the listed slots (list_slots) are streamed.
template <typename E>
struct GatheredSlots {
  using Elem = E;
  const E* __restrict__ state;
  const int* snbr;
  const int* spos;
  const int* slots;
  const CUtensorMap* map;   // the state as [N*P*P, C] (sp.tma), else null

  __device__ int count(int P) const { return slots[P]; }
  __device__ int slot(int i) const { return slots[i]; }

  // One copy of the run (b, c) of slot a (neighbour n, positions `pos_a`).
  __device__ __forceinline__ void copy_run(const int* pos_a,
                                           const StreamPlan& sp, char* buf,
                                           int n, int b, int c, int dst,
                                           int src) const {
    const int p1 = pos_a[b], p2 = pos_a[c];
    const bool present = (n | p1 | p2) >= 0;
    const char* from = reinterpret_cast<const char*>(state);
    // The element's index fits an int (the state has under 2^31 elements a
    // channel); one widening multiply makes the byte offset.
    if (present)
      from += (size_t)((n * sp.P + p1) * sp.P + p2) * (sp.C * sizeof(E))
              + src;
    copy_unit<E>(sp, buf, dst, from, present);
  }

  __device__ __forceinline__ void issue(const StreamPlan& sp, char* buf,
                                        int a, const CopyItems& ci) const {
    const int n = snbr[a];
    const int* pos_a = spos + a * sp.P;
#pragma unroll
    for (int j = 0; j < kMaxA; ++j)
      if (ci.b[j] >= 0)
        copy_run(pos_a, sp, buf, n, ci.b[j], ci.c[j], ci.dst[j], ci.src[j]);
    for (int k = kMaxA; k < ci.items; ++k) {
      int b, c, dst, src;
      if (copy_item<E>(sp, ci, k, b, c, dst, src))
        copy_run(pos_a, sp, buf, n, b, c, dst, src);
    }
  }

  // The rows b0 .. b0 + sp.rows - 1 (those < P) of slot a, every thread of
  // the block copying its items `it` (row_items with units_of parts; a
  // row-tiled plan, see stream_pieces).
  __device__ __forceinline__ void issue_rows(const StreamPlan& sp, char* buf,
                                             int a, int b0, int c0,
                                             const RowItems& it) const {
    const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
    const int n = snbr[a];
    const int* pos_a = spos + a * sp.P;
    for_row_items(sp, it, min(sp.rows, sp.P - b0), [&](int b, int c, int u) {
      copy_run(pos_a, sp, buf, n, b0 + b, c,
               b * sp.rowb + c * sp.ncp * es + u * step, c0 * es + u * step);
    });
  }

  // Row b of slot a into `row`, `sub` copies a cell, the lanes of one
  // warp copying it (stream_rows).
  __device__ __forceinline__ void issue_row(const StreamPlan& sp, char* row,
                                            int a, int b, int c0, int sub,
                                            int lane) const {
    const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
    const int n = snbr[a];
    const int* pos_a = spos + a * sp.P;
    for (int i = lane; i < sp.P * sub; i += 32) {
      const int c = i / sub, u = i - c * sub;
      copy_run(pos_a, sp, row, n, b, c, c * sp.ncp * es + u * step,
               c0 * es + u * step);
    }
  }

  // Whether row b of slot a holds anything: its neighbour and p1 present.
  __device__ __forceinline__ bool row_present(const StreamPlan& sp, int a,
                                              int b) const {
    return (snbr[a] | spos[a * sp.P + b]) >= 0;
  }

  // The tensor map's row of row b of slot a, present: the first of the P
  // rows of state[n, p1, 0:P, :] (stream_rows_producer copies them).
  __device__ __forceinline__ int row_y(const StreamPlan& sp, int a,
                                       int b) const {
    return (snbr[a] * sp.P + spos[a * sp.P + b]) * sp.P;
  }
};

// Materialised (K4, K5, K6): slot a is T[v,a,:,:,:] of the vertex's slots
// T[v] [P,P,P,C], runs of nc elements at stride C (one contiguous P*C run a
// row b where the chunk is all of C).  The take-gather that built T wrote
// zeros where a slot is absent, so every slot is streamed as it is stored.
template <typename E>
struct StoredSlots {
  using Elem = E;
  const E* __restrict__ T;   // T[v]

  __device__ int count(int P) const { return P; }
  __device__ int slot(int i) const { return i; }

  __device__ __forceinline__ void issue(const StreamPlan& sp, char* buf,
                                        int a, const CopyItems& ci) const {
    // Slot a holds P*P runs of C elements; its byte offset fits an int.
    const char* slot = reinterpret_cast<const char*>(T)
                       + (size_t)(a * sp.P * sp.P) * (sp.C * sizeof(E));
    const int run = sp.C * (int)sizeof(E);
#pragma unroll
    for (int j = 0; j < kMaxA; ++j)
      if (ci.b[j] >= 0)
        copy_unit<E>(sp, buf, ci.dst[j],
                     slot + (ci.b[j] * sp.P + ci.c[j]) * run + ci.src[j],
                     true);
    for (int k = kMaxA; k < ci.items; ++k) {
      int b, c, dst, src;
      if (copy_item<E>(sp, ci, k, b, c, dst, src))
        copy_unit<E>(sp, buf, dst, slot + (b * sp.P + c) * run + src, true);
    }
  }

  // The rows b0 .. b0 + sp.rows - 1 (those < P) of slot a, every thread of
  // the block copying its items `it` (row_items with units_of parts; a
  // row-tiled plan, see stream_pieces).
  __device__ __forceinline__ void issue_rows(const StreamPlan& sp, char* buf,
                                             int a, int b0, int c0,
                                             const RowItems& it) const {
    const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
    const int run = sp.C * es;
    const char* rows = reinterpret_cast<const char*>(T)
                       + (size_t)((a * sp.P + b0) * sp.P) * run + c0 * es;
    for_row_items(sp, it, min(sp.rows, sp.P - b0), [&](int b, int c, int u) {
      copy_unit<E>(sp, buf, b * sp.rowb + c * sp.ncp * es + u * step,
                   rows + (b * sp.P + c) * run + u * step, true);
    });
  }

  // Row b of slot a into `row`, `sub` copies a cell, the lanes of one
  // warp copying it (stream_rows): P runs of nc elements at stride C.
  __device__ __forceinline__ void issue_row(const StreamPlan& sp, char* row,
                                            int a, int b, int c0, int sub,
                                            int lane) const {
    const int es = (int)sizeof(E), step = sp.unit ? sp.unit : es;
    const int run = sp.C * es;
    const char* from = reinterpret_cast<const char*>(T)
                       + (size_t)((a * sp.P + b) * sp.P) * run + c0 * es;
    for (int i = lane; i < sp.P * sub; i += 32) {
      const int c = i / sub, u = i - c * sub;
      copy_unit<E>(sp, row, c * sp.ncp * es + u * step,
                   from + c * run + u * step, true);
    }
  }
};

// Starts the copies of the first D - 1 slots of a chunk.  The caller may
// do other work before stream_reductions, which waits for them.
template <typename Src>
__device__ inline void stream_prologue(const Src& src, const StreamPlan& sp,
                                       const StreamBuffers& s, int c0,
                                       int nc) {
  const CopyItems ci = copy_items<typename Src::Elem>(sp, c0, nc);
  const int n = src.count(sp.P);
  for (int i = 0; i < sp.D - 1; ++i) {
    if (i < n) src.issue(sp, s.ring + i * sp.slotb, src.slot(i), ci);
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

// The ablation variant novpu (risi18_bank_ablate.cu) replaces every pick of
// a diagonal by the full sum: D_bc = T_ab, D_ac = T_ab (so dacT = tabT),
// T_bc[b,c] = T_b[b] and M10[b,c] = sum_a R[a] T_ab[a,b] for every c, from
// the stream's T_ab.  The caller's barrier stands between the maps' writers
// and this.  Ends with a barrier.
__device__ inline void picks_as_sums(const StreamPlan& sp,
                                     const StreamBuffers& s, const float* R) {
  const int P = sp.P, ncp = sp.ncp;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* tab = s.map(kTab, sp.mapw);
  const float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);
  for (int i = tid; i < P * P * ncp; i += nth) {
    dbc[i] = tab[i];
    dacT[i] = tabT[i];
  }
  for (int item = tid; item < P * ncp; item += nth) {
    const int f = item % ncp, b = item / ncp;
    float tb = 0.f, rb = 0.f;
    for (int a = 0; a < P; ++a) {
      const float x = tab[(a * P + b) * ncp + f];
      tb += x;
      rb += R[a] * x;
    }
    for (int c = 0; c < P; ++c) {
      tbc[(b * P + c) * ncp + f] = tb;
      m10[(b * P + c) * ncp + f] = rb;
    }
  }
  __syncthreads();
}

// The vectors and scalars of a chunk from its complete maps; the caller's
// barrier stands between the maps' writers and this.  Without kSelect
// (novpu) s14 and t18 are the full sum too.  Ends with a barrier.
template <bool kSelect = true>
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
    if constexpr (!kSelect) s14 = t18 = tf;
    s.tfull[f] = tf; s.s14[f] = s14; s.s15[f] = s15; s.t18[f] = t18;
  }
  __syncthreads();
}

// Streams the slots of one vertex that `src` yields for the chunk [c0,
// c0 + nc), after stream_prologue, and leaves the chunk's maps, vectors and
// scalars in `s`.  The caller has loaded R (and, for a gathered source, the
// structure and the listed slots), and no thread still reads s's maps.
// Ends with a barrier.
//
// A warp takes one row b of a staged slot (a second one, 16 further, where
// P > 16): its lane h * quads + q owns four channels q of the columns h,
// h + H, ... (H = 32 / quads).  One float4 load per owned cell feeds both
// passes: T_bc and M10 add up in registers over the slots (pass A); T_ab
// and M6 are the cell's sum over the warp's columns (pass B), and the lane
// that holds column b or column a stores D_bc or D_ac as it is.
// The ablation variants leave parts out: without kGroupD no M6 and no M10
// (the shuffles of pass B still run, on zeros for M6), without kSelect no
// picks (picks_as_sums then writes the full sums in their place).
template <bool kGroupD = true, bool kSelect = true, typename Src>
__device__ inline void stream_reductions(const Src& src, const float* R,
                                         const StreamPlan& sp,
                                         const StreamBuffers& s, int c0,
                                         int nc) {
  using E = typename Src::Elem;
  const int P = sp.P, ncp = sp.ncp, D = sp.D, n = src.count(P);
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
      src.issue(sp, s.ring + ahead * sp.slotb, src.slot(i + D - 1), ci);
    cp_async_commit();
    const int a = src.slot(i);
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
        if constexpr (kGroupD) fma4(acc_m10[k], ra, x);
        // Pass B: this cell's part of T_ab[a,b] and M6[a,b]; the picks
        // D_bc[a,b] = T[a,b,b] and D_ac[a,b] = T[a,b,a].
        t[k] = x;
        if constexpr (kGroupD) fma4(w[k], cell_r[k], x);
        if constexpr (kSelect) {
          const int b = cell_b[k], c = cell_c[k];
          if (c == b)
            *reinterpret_cast<float4*>(dbc + (a * P + b) * ncp + 4 * q) = x;
          if (c == a)
            *reinterpret_cast<float4*>(dacT + (b * P + a) * ncp + 4 * q) = x;
        }
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
        if (which < 4) { tab[ab] = z; tabT[ba] = z; }
        else if (kGroupD) m6[ab] = z;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    if (cell[k] >= 0) {
      const int at = (cell_b[k] * P + cell_c[k]) * ncp + 4 * q;
      *reinterpret_cast<float4*>(tbc + at) = acc_tbc[k];
      if constexpr (kGroupD)
        *reinterpret_cast<float4*>(m10 + at) = acc_m10[k];
    }
  }
  __syncthreads();

  if constexpr (!kSelect) picks_as_sums(sp, s, R);
  stream_row_sums<kSelect>(sp, s);
}

// stream_reductions for a plan that is `wide`: a warp takes the rows b =
// warp, warp + nwarps, ... of a staged slot and its lane the columns h,
// h + H, ..., as many as the field has, and each thread adds its cells to
// T_bc and M10 in shared memory, where every cell has one owner, instead of
// in registers.  A slower loop for fields that few graphs have; the forward
// has a kernel of its own for it, so that no other kernel's registers
// depend on it.  kGroupD and kSelect as in stream_reductions (the ablation
// variants).
template <bool kGroupD = true, bool kSelect = true, typename Src>
__device__ inline void stream_reductions_wide(const Src& src, const float* R,
                                              const StreamPlan& sp,
                                              const StreamBuffers& s, int c0,
                                              int nc) {
  using E = typename Src::Elem;
  const int P = sp.P, ncp = sp.ncp, D = sp.D, n = src.count(P);
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
      src.issue(sp, s.ring + ahead * sp.slotb, src.slot(i + D - 1), ci);
    cp_async_commit();
    const int a = src.slot(i);
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
        float4 sum = load4(tbc + at);
        fma4(sum, 1.f, x);
        *reinterpret_cast<float4*>(tbc + at) = sum;
        if constexpr (kGroupD) {
          float4 weighted = load4(m10 + at);
          fma4(weighted, ra, x);
          *reinterpret_cast<float4*>(m10 + at) = weighted;
        }
        fma4(ts, 1.f, x);
        if constexpr (kGroupD) fma4(ws, R[c], x);
        if constexpr (kSelect) {
          if (c == b)
            *reinterpret_cast<float4*>(dbc + (a * P + b) * ncp + 4 * q) = x;
          if (c == a)
            *reinterpret_cast<float4*>(dacT + (b * P + a) * ncp + 4 * q) =
                x;
        }
      }
      const float z = reduce_over_columns(ts, ws, h, quads);
      if (h < 8) {
        const int ch = 4 * q + (which & 3);
        const int ab = (a * P + b) * ncp + ch, ba = (b * P + a) * ncp + ch;
        if (which < 4) { tab[ab] = z; tabT[ba] = z; }
        else if (kGroupD) m6[ab] = z;
      }
    }
  }
  __syncthreads();
  if constexpr (!kSelect) picks_as_sums(sp, s, R);
  stream_row_sums<kSelect>(sp, s);
}

// The stream with its loads alone (the ablation variant dma,
// risi18_bank_ablate.cu): the slots `src` yields for the chunk [c0, c0 +
// nc), after stream_prologue, each thread reading the cells of every staged
// slot that stream_reductions_wide gives it and adding them up.  Returns
// this thread's sum; no barrier.
template <typename Src>
__device__ inline float stream_loads(const Src& src, const StreamPlan& sp,
                                     const StreamBuffers& s, int c0,
                                     int nc) {
  using E = typename Src::Elem;
  const int P = sp.P, ncp = sp.ncp, D = sp.D, n = src.count(P);
  const int tid = threadIdx.x, nwarps = blockDim.x / 32;
  const int quads = ncp / 4, H = 32 / quads;
  const int q = (tid & 31) & (quads - 1), h = (tid & 31) / quads;
  const CopyItems ci = copy_items<E>(sp, c0, nc);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int stage = 0, ahead = (D - 1) % D;
  for (int i = 0; i < n; ++i) {
    cp_async_wait(D - 2);
    __syncwarp();
    if (i + D - 1 < n)
      src.issue(sp, s.ring + ahead * sp.slotb, src.slot(i + D - 1), ci);
    cp_async_commit();
    const char* buf = s.ring + stage * sp.slotb;
    stage = stage + 1 == D ? 0 : stage + 1;
    ahead = ahead + 1 == D ? 0 : ahead + 1;
    for (int b = tid / 32; b < P; b += nwarps)
      for (int c = h; c < P; c += H)
        fma4(acc, 1.f, load4(reinterpret_cast<const E*>(
                           buf + b * sp.rowb + (c * ncp + 4 * q) * (int)sizeof(E))));
  }
  return acc.x + acc.y + acc.z + acc.w;
}

// -- the row-tiled stream ---------------------------------------------------
// A field whose maps do not fit one block (K1, K4, K6 from 36 rows, K2, K5
// from 33) is walked in row tiles X = [x0, x0 + nx) of sp.rows rows.  The
// maps of a tile's rows x need two kinds of slot data:
//   whole slots a in X:  T_ab[x,:], M6[x,:], D_bc[x,:] (and T_a, Tdbc);
//   rows b in X of every slot:  T_bc[x,:], M10[x,:], T_ab[:,x] (tabT),
//                        D_ac[:,x] (dacT) (and T_b, Tdac).
// So a tile streams "pieces" of sp.rows rows of one slot: the rows X of
// every slot, then the other rows of the slots in X; the tiles together
// stream each slot about twice, not P / |X| times.  A ring buffer holds
// pieces(sp) pieces (a stage); every thread copies a share of it, and the
// block meets at a barrier per stage (stream_pieces).  A warp reduces a row
// of a piece as stream_reductions_wide does (its lanes over the columns,
// float4 loads of four channels, T_ab and M6 summed over the lanes by
// reduce_over_columns); T_bc and M10 add up in the registers of the warp
// that owns the row (or, where a row's cells outnumber them, in shared
// memory, each cell by one owner): no atomics, the same sums from run to
// run.

// The rows of a row tile that the planners try, largest first.
constexpr int kTileRows[6] = {32, 16, 8, 4, 2, 1};

// Whether tile_reductions keeps a warp's cells of T_bc and M10 in
// registers (a row of a piece a warp): then a ring buffer may hold several
// pieces, and every warp reduces a row of each stage.
__host__ __device__ inline bool tile_regs(const StreamPlan& sp) {
  const int H = 32 / (sp.ncp / 4);
  return sp.rows <= kThreads / 32 && (sp.P + H - 1) / H <= kMaxCells;
}

// Whether a stage of a row-tiled plan keeps at least three quarters of the
// block's warps busy: a warp takes a row of a piece, and a stage holds
// pieces(sp) pieces of sp.rows rows (stream_rows).
__host__ __device__ inline bool fills_warps(const StreamPlan& sp) {
  return 4 * sp.rows * pieces(sp) >= 3 * (kThreads / 32);
}

// The channel-rows a stage of a row-tiled plan reduces.
__host__ __device__ inline int stage_work(const StreamPlan& sp) {
  return sp.rows * pieces(sp) * sp.Cc;
}

// The cluster plans (forward_block_cluster: K1, K4; backward_block_cluster:
// K2 kernel 1, K5 kernel 1) spread a vertex's row tiles over a cluster of
// up to kMaxCluster blocks, the most a cluster takes without the
// non-portable attribute: with a share of `per` tiles a block, as few
// blocks as that share needs, block `rank` taking the tiles rank, rank +
// cluster, ...  A cluster's blocks add no work, they split a vertex's
// tiles; one block an SM, so the kernel's time goes as the rounds of
// clusters the card runs one after another times the tiles a block takes:
//   ceil(grid / floor(kSMs / blocks)) * per,
// grid the clusters of the launch (K1, K4: vertices x panels; K2, K5:
// vertex groups x chunks x panels).  cluster_shape takes the shape with the
// fewest, and of those the fewest blocks (each costs the cluster's meetings
// and, in the backward, the vertex's structure and G's sums once more).
// So a grid that already fills the card about twice takes one block a
// cluster, and a small one spreads its tiles over up to kMaxCluster.  That
// count fits what the clusters of 1, 2, 4 and 8 measured on an H100 for K1
// and K2 kernel 1 at (64,64,32,32), (256,64,32,32), (160,40,32,16) and
// (160,40,16,8) (PERF.md).  It is the one rule of every cluster plan, so a
// launcher and its plan query agree (both give it the same N).
constexpr int kMaxCluster = 8;
constexpr int kSMs = 132;   // an H100 SXM

struct ClusterShape {
  int blocks;   // blocks a cluster
  int per;      // row tiles a block takes, at most
};

__host__ __device__ inline ClusterShape cluster_shape(int tiles, int grid) {
  ClusterShape best{1, tiles};
  long long least = -1;
  for (int cap = 1; cap <= kMaxCluster; ++cap) {
    const int per = (tiles + cap - 1) / cap, blocks = (tiles + per - 1) / per;
    const int at_once = kSMs / blocks;
    const long long cost = (long long)((grid + at_once - 1) / at_once) * per;
    if (least < 0 || cost < least) {
      least = cost;
      best = {blocks, per};
    }
  }
  return best;
}

// -- the state's tensor map (host) -------------------------------------------

// An error of the tensor-copy route's set-up: kTensorMapError + the CUresult
// of cuTensorMapEncodeTiled (or CUDA_ERROR_NOT_FOUND where the driver has
// no such entry point).  error_string names it; the wrappers raise.
constexpr int kTensorMapError = 1 << 20;

// The L2 promotion of the state's tensor copies: none.  A row's runs of
// ncp channels (32 bytes at 8 float32 channels) lie C elements apart,
// each in its own 128-byte line at C = 32, so promoting a run to its line
// (128 B) or more (256 B) reads lines the box does not need: K1 at
// (256,64,32,32) f32 took 8.82 ms with 128-byte promotion, 8.84 with
// 256-byte and 7.26 with none, K2 kernel 1 17.61 / 17.64 / 15.44; the
// same within 1 % in bfloat16 and at N = 64 (an H100; PERF.md).
constexpr CUtensorMapL2promotion kStateL2Promotion =
    CU_TENSOR_MAP_L2_PROMOTION_NONE;

// cuTensorMapEncodeTiled, reached through the runtime (no link to the driver
// library): 0 and the function, or a cudaError_t or kTensorMapError + a
// CUresult.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
inline int encode_tiled_entry(EncodeTiled* fn) {
  void* entry = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || entry == nullptr)
    return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  *fn = reinterpret_cast<EncodeTiled>(entry);
  return 0;
}

// The tensor map of a gathered stream (sp.tma): the state [N, P, P, C] of
// element size es seen as [N*P*P rows, C channels] (a row stride of C*es
// bytes), a box of {ncp channels, P rows}: row b of a slot, a neighbour's
// state[n, p1, 0:P, c0:c0+ncp].  No swizzle; channels past C read zeros
// (OOB_FILL_NONE; the NaN request is not taken).  Returns 0, a cudaError_t
// or kTensorMapError + a CUresult.
inline int encode_state_map(CUtensorMap* map, const void* state, int N,
                            const StreamPlan& sp, int es) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    const int err = encode_tiled_entry(&encode);
    if (err != 0) return err;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)sp.C,
                              (cuuint64_t)N * sp.P * sp.P};
  const cuuint64_t strides[1] = {(cuuint64_t)sp.C * es};
  const cuuint32_t box[2] = {(cuuint32_t)sp.ncp, (cuuint32_t)sp.P};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(state), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      kStateL2Promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// The text of a launcher's error: a cudaError_t, or the tensor map's.
inline const char* error_string(int err) {
  if (err >= kTensorMapError) {
    static thread_local char text[96];
    snprintf(text, sizeof(text),
             "cuTensorMapEncodeTiled of the state (or of K2's dstate) "
             "failed: CUresult %d",
             err - kTensorMapError);
    return text;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// Launches `kernel` (kThreads threads a block, `bytes` of dynamic shared
// memory) on `stream` over `grid`, in clusters of `cluster` blocks along x,
// with `args`; returns a cudaError_t.  A cluster the card cannot place is
// refused (cudaErrorLaunchOutOfResources), never run another way.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid,
                                   int cluster, size_t bytes,
                                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The rows of a cluster plan's tile for a planner's `rows`: as many tiles,
// as even as the count allows (P = 40 in tiles of 16 becomes 14, 14, 12,
// not 16, 16, 8), so that no block of the cluster waits long for another
// at the meetings.  Never more rows than `rows`.
inline int balanced_rows(int P, int rows) {
  const int tiles = (P + rows - 1) / rows;
  return (P + tiles - 1) / tiles;
}

// Words of a row-tiled block's scratch: two a thread (a pass's partial
// sums, one float4 of four sums per warp and quad of channels at most; a
// cluster block's part of s).
constexpr int kTilePartWords = 2 * kThreads;

// Streams pieces 0 .. np - 1 of the chunk [c0, c0 + nc) through the ring,
// pieces(sp) consecutive pieces a ring buffer (a stage): piece(j, a, b0) names
// slot a and first row b0 of piece j, and consume(j, a, b0, buf) runs on
// every thread, for each piece of a stage in turn, once the block has met
// at the barrier that makes the stage's copies visible; the same barrier
// orders the consumers of stage s - 1 before the copies of stage s + D - 1
// into its buffer.  Ends with a barrier.
template <typename Src, typename Piece, typename Consume>
__device__ inline void stream_pieces(const Src& src, const StreamPlan& sp,
                                     const StreamBuffers& s, int c0, int nc,
                                     int np, Piece piece, Consume consume) {
  const int D = sp.D, G = pieces(sp), ns = (np + G - 1) / G;
  const int pieceb = sp.rows * sp.rowb;
  const RowItems it =
      row_items(sp, units_of<typename Src::Elem>(sp, nc));
  auto issue = [&](int st, char* buf) {
    for (int g = 0; g < G && st * G + g < np; ++g) {
      int a, b0;
      piece(st * G + g, a, b0);
      src.issue_rows(sp, buf + g * pieceb, a, b0, c0, it);
    }
  };
  for (int i = 0; i < D - 1; ++i) {
    if (i < ns) issue(i, s.ring + i * sp.slotb);
    cp_async_commit();
  }
  int stage = 0, ahead = (D - 1) % D;
  for (int st = 0; st < ns; ++st) {
    PIECE_MARK(t0);
    cp_async_wait(D - 2);
    __syncthreads();
    PIECE_MARK(t1);
    if (st + D - 1 < ns) issue(st + D - 1, s.ring + ahead * sp.slotb);
    cp_async_commit();
    PIECE_MARK(t2);
    for (int g = 0; g < G && st * G + g < np; ++g) {
      int a, b0;
      piece(st * G + g, a, b0);
      consume(st * G + g, a, b0, s.ring + stage * sp.slotb + g * pieceb);
    }
    PIECE_MARK(t3);
    PIECE_ADD(kPieceWait, t1 - t0);
    PIECE_ADD(kPieceIssue, t2 - t1);
    PIECE_ADD(kPieceReduce, t3 - t2);
    PIECE_ADD(kPieces, 1);
    stage = stage + 1 == D ? 0 : stage + 1;
    ahead = ahead + 1 == D ? 0 : ahead + 1;
  }
  cp_async_wait(0);
  __syncthreads();
}

// stream_pieces where a warp reduces one row of each stage (tile_regs):
// warp w copies and reduces row w % sp.rows of piece w / sp.rows of every
// stage, so that it waits for its own copies only (cp.async's wait and the
// warp's barrier) and the block meets once, when the stream ends.  The
// warps drift apart: one's copies, bound by the lines their scattered
// runs touch, overlap another's reductions, where stream_pieces' barrier
// a stage made every warp issue, then every warp reduce.  A ring buffer's
// row is written and read by its one warp, whose barrier at each stage
// orders the reads of the stage before it ahead of the copies into its
// buffer.  consume(a, b0, buf) runs on the owning warp for its row of a
// piece (slot a from row b0, the piece at buf).  Ends with a barrier.
template <typename Src, typename Piece, typename Consume>
__device__ inline void stream_rows(const Src& src, const StreamPlan& sp,
                                   const StreamBuffers& s, int c0, int nc,
                                   int np, Piece piece, Consume consume) {
  const int D = sp.D, G = pieces(sp), X = sp.rows, ns = (np + G - 1) / G;
  const int pieceb = X * sp.rowb, sub = units_of<typename Src::Elem>(sp, nc);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gw = warp / X, bw = warp % X;
  // The piece of stage st this warp owns a row of: false if none.
  auto own = [&](int st, int& a, int& b0) {
    const int j = st * G + gw;
    if (gw >= G || j >= np) return false;
    piece(j, a, b0);
    return b0 + bw < sp.P;
  };
  auto issue = [&](int st, char* buf) {
    int a, b0;
    if (own(st, a, b0))
      src.issue_row(sp, buf + gw * pieceb + bw * sp.rowb, a, b0 + bw, c0,
                    sub, lane);
  };
  for (int i = 0; i < D - 1; ++i) {
    if (i < ns) issue(i, s.ring + i * sp.slotb);
    cp_async_commit();
  }
  int stage = 0, ahead = (D - 1) % D;
  for (int st = 0; st < ns; ++st) {
    PIECE_MARK(t0);
    cp_async_wait(D - 2);
    __syncwarp();
    PIECE_MARK(t1);
    if (st + D - 1 < ns) issue(st + D - 1, s.ring + ahead * sp.slotb);
    cp_async_commit();
    PIECE_MARK(t2);
    int a, b0;
    if (own(st, a, b0))
      consume(a, b0, s.ring + stage * sp.slotb + gw * pieceb);
    PIECE_MARK(t3);
    PIECE_ADD(kPieceWait, t1 - t0);
    PIECE_ADD(kPieceIssue, t2 - t1);
    PIECE_ADD(kPieceReduce, t3 - t2);
    PIECE_ADD(kPieces, 1);
    stage = stage + 1 == D ? 0 : stage + 1;
    ahead = ahead + 1 == D ? 0 : ahead + 1;
  }
  cp_async_wait(0);
  __syncthreads();
}

// A piece of the tensor-copy route's list (tile_reductions): slot a, first
// row b0 (both under 256: P <= 156), and bit bl of `rows` set where row
// b0 + bl is present (below P, its neighbour and p1 set).
__host__ __device__ constexpr int piece_entry(int a, int b0, int rows) {
  return a | b0 << 8 | rows << 16;
}
__device__ __forceinline__ int piece_slot(int e) { return e & 255; }
__device__ __forceinline__ int piece_row(int e) { return (e >> 8) & 255; }
__device__ __forceinline__ bool piece_has(int e, int bl) {
  return (e >> (16 + bl)) & 1;
}

// The warp that issues the tensor-copy route's copies: the last one.
// (The warps between the consumers and it idle during the stream: three
// at P = 64, where tiles of 4 rows leave 12 consumers.  Made producers too
// they split the issue, and the stage took as long on an H100: the copies'
// 32-byte requests, not the producer's instructions, set its pace;
// PERF.md.)
constexpr int kProducerWarp = kThreads / 32 - 1;

// The stream of a tile's pieces on the tensor-copy route (sp.tma; a
// gathered source): np pieces, s.plist[j] piece j's piece_entry, pieces(sp)
// = G pieces a stage, a ring buffer a stage.  Warp kProducerWarp is the
// producer: per stage, its lane g * X + bl issues the copy of row bl of the
// stage's piece g (state[n, p1, 0:P, c0:c0+ncp] in storage order; none
// where the row is absent), after lane 0 has armed the buffer's full
// mbarrier with the stage's bytes, once every consumer has released the
// buffer on its empty mbarrier (the first D stages wait for nothing).  The
// consumers are warps w < G * X: warp w takes row bl = w % X of piece w / X
// of every stage, as in stream_rows, so that it keeps the cells of one
// tile row in registers; it waits on the full mbarrier, calls
// consume(entry, row) for a present row only (the row at `row` in storage
// order), and its lane 0 arrives on the empty one.  The caller has
// initialised the 2D mbarriers (s.bars: full D with one arrival, then
// empty D with G * X) and fenced its threads' writes to shared memory for
// the async proxy (fence_proxy_async) before the barrier that precedes
// this; they are invalidated here, after the barrier that ends the stream.
template <typename Src, typename Consume>
__device__ inline void stream_rows_producer(const Src& src,
                                            const StreamPlan& sp,
                                            const StreamBuffers& s, int c0,
                                            int np, Consume consume) {
  const int D = sp.D, G = pieces(sp), X = sp.rows, ns = (np + G - 1) / G;
  const int pieceb = X * sp.rowb;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t* full = s.bars;
  uint64_t* empty = s.bars + D;
  if (warp == kProducerWarp) {
    const int g = lane / X, bl = lane % X;
    const bool issues = lane < G * X;
    const unsigned row_bytes = sp.P * sp.ncp * (int)sizeof(typename Src::Elem);
    char* dst = s.ring + g * pieceb + bl * sp.rowb;
    int stage = 0;
    unsigned phase = 0;
    for (int st = 0; st < ns; ++st) {
      PIECE_MARK(t0);
      mbar_wait(empty + stage, phase ^ 1u);
      PIECE_MARK(t1);
      const int j = st * G + g;
      const int e = issues && j < np ? s.plist[j] : 0;
      const bool present = piece_has(e, bl);
      const unsigned bytes =
          __reduce_add_sync(0xffffffffu, present ? row_bytes : 0u);
      if (lane == 0) mbar_arrive_expect(full + stage, bytes);
      __syncwarp();
      if (present)
        tma_load_2d(dst + stage * sp.slotb, src.map, c0,
                    src.row_y(sp, piece_slot(e), piece_row(e) + bl),
                    full + stage);
      PIECE_MARK(t2);
      PRODUCER_ADD(kProducerWait, t1 - t0);
      PRODUCER_ADD(kProducerIssue, t2 - t1);
      PRODUCER_ADD(kProducerStages, 1);
      if (++stage == D) { stage = 0; phase ^= 1u; }
    }
  } else if (warp < G * X) {
    const int gw = warp / X, bw = warp % X;
    const char* row = s.ring + gw * pieceb + bw * sp.rowb;
    int stage = 0;
    unsigned phase = 0;
    for (int st = 0; st < ns; ++st) {
      PIECE_MARK(t0);
      mbar_wait(full + stage, phase);
      PIECE_MARK(t1);
      const int j = st * G + gw;
      if (j < np) {
        const int e = s.plist[j];
        if (piece_has(e, bw)) consume(e, row + stage * sp.slotb);
      }
      PIECE_MARK(t2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      PIECE_MARK(t3);
      PIECE_ADD(kPieceWait, t1 - t0);
      PIECE_ADD(kPieceReduce, t2 - t1);
      PIECE_ADD(kConsumerRelease, t3 - t2);
      PIECE_ADD(kPieces, 1);
      if (++stage == D) { stage = 0; phase ^= 1u; }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * D; ++i) mbar_inval(s.bars + i);
}

// The maps, row sums and vectors of the tile `tile` (rows [x0, x0 + nx),
// x0 = tile * sp.rows) for the chunk [c0, c0 + nc): map row xl * P + y
// holds, for x = x0 + xl,
//   tab  T_ab[x,y]   tabT T_ab[y,x]   tbc  T_bc[x,y]   dbc  T[x,y,y]
//   dacT T[y,x,y]    m6   M6[x,y]     m10  M10[x,y],
// and s.ta .. s.tdac rows xl.  kGroupD and kSelect as in
// stream_reductions; kDac (the ablation variant reduce) writes the whole
// slots' D_ac[x,y] = T[x,y,x] into m6, which that variant has no use for.
// kWarpRows: where the warps keep their cells in registers, the stream is
// stream_rows (a warp copies the row it reduces; the cluster blocks of
// K1, K2, K4 and K5), else stream_pieces.  kTma (a plan with sp.tma, so
// kWarpRows and registers; K1's and K2's cluster kernels are compiled for
// each route): stream_rows_producer, a producer warp copying every row in
// storage order (see reduce_tile_row and reduce_slot_row below for how the
// consumers read it).  The caller has loaded R (and the listed slots) and
// no thread still reads s.  Ends with a barrier.
template <bool kGroupD, bool kSelect, bool kDac, typename Src,
          bool kWarpRows = false, bool kTma = false>
__device__ inline void tile_reductions(const Src& src, const float* R,
                                       const StreamPlan& sp,
                                       const StreamBuffers& s, int tile,
                                       int nx, int c0, int nc) {
  using E = typename Src::Elem;
  const int P = sp.P, X = sp.rows, ncp = sp.ncp, quads = ncp / 4;
  const int tid = threadIdx.x, nth = blockDim.x, es = (int)sizeof(E);
  const int nwarps = nth / 32, H = 32 / quads, warp = tid / 32;
  const int lane = tid & 31, q = lane & (quads - 1), h = lane / quads;
  const int which = 4 * (h & 1) + (h & 2) + ((h & 4) >> 2);
  const int x0 = tile * X, nrg = (P + X - 1) / X;
  // Where a row's cells fit a lane's registers (as for pieces(sp) > 1),
  // warp w reduces row w % X of piece w / X of each stage and adds its
  // cells of T_bc and M10 (the rows X of every slot) in registers, which
  // the block adds into the maps when the stream ends, in warp order; else
  // the warps take the rows of each piece in turn and add into the maps,
  // each cell by one owner.
  const bool regs = tile_regs(sp);
  const int gw = warp / X, bw = warp % X;
  float4 acc_tbc[kMaxCells], acc_m10[kMaxCells];
#pragma unroll
  for (int k = 0; k < kMaxCells; ++k)
    acc_tbc[k] = acc_m10[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* tab = s.map(kTab, sp.mapw);
  float* tabT = s.map(kTabT, sp.mapw);
  float* tbc = s.map(kTbc, sp.mapw);
  float* dbc = s.map(kDbc, sp.mapw);
  float* dacT = s.map(kDacT, sp.mapw);
  float* m6 = s.map(kM6, sp.mapw);
  float* m10 = s.map(kM10, sp.mapw);
  const int n = src.count(P);
  // The listed slots in the tile are [lo, hi) of the list (it is sorted).
  int lo = 0, hi = 0;
  for (int i = 0; i < n; ++i) {
    const int a = src.slot(i);
    lo += a < x0;
    hi += a < x0 + nx;
  }
  const int np = n + (hi - lo) * (nrg - 1);
  auto piece = [&](int j, int& a, int& b0) {
    if (j < n) {
      a = src.slot(j);
      b0 = x0;
    } else {
      const int k = j - n, r = k % (nrg - 1);
      a = src.slot(lo + k / (nrg - 1));
      b0 = (r < tile ? r : r + 1) * X;
    }
  };
  // Row bl of a piece (slot a, rows from b0), reduced by this warp; column
  // c of the row lies at cell c of the buffer.
  auto reduce_row = [&](int a, int b0, int bl, const char* buf) {
    const bool row = b0 == x0, whole = a >= x0 && a < x0 + nx;
    const int b = b0 + bl, wa = (a - x0) * P;
    const float ra = R[a];
    auto cell = [&](int c) {
      return load4(reinterpret_cast<const E*>(
          buf + bl * sp.rowb + (c * ncp + 4 * q) * es));
    };
    float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), ws = ts;
#pragma unroll
    for (int k = 0; k < kMaxCells; ++k) {
      // The first kMaxCells columns in registers (regs), the rest after.
      const int c = h + H * k;
      if (!regs || c >= P) break;
      const float4 x = cell(c);
      if (row) {
        fma4(acc_tbc[k], 1.f, x);
        if constexpr (kGroupD) fma4(acc_m10[k], ra, x);
        if (kSelect && c == a)
          *reinterpret_cast<float4*>(dacT + (bl * P + a) * ncp + 4 * q) = x;
      }
      if (whole) {
        const int at = (wa + b) * ncp + 4 * q;
        if (kSelect && c == b) *reinterpret_cast<float4*>(dbc + at) = x;
        if (kDac && c == a) *reinterpret_cast<float4*>(m6 + at) = x;
      }
      fma4(ts, 1.f, x);
      if (kGroupD && whole) fma4(ws, R[c], x);
    }
    for (int c = regs ? P : h; c < P; c += H) {
      const float4 x = cell(c);
      if (row) {
        const int at = (bl * P + c) * ncp + 4 * q;
        float4 sum = load4(tbc + at);
        fma4(sum, 1.f, x);
        *reinterpret_cast<float4*>(tbc + at) = sum;
        if constexpr (kGroupD) {
          float4 weighted = load4(m10 + at);
          fma4(weighted, ra, x);
          *reinterpret_cast<float4*>(m10 + at) = weighted;
        }
        if (kSelect && c == a)
          *reinterpret_cast<float4*>(dacT + (bl * P + a) * ncp + 4 * q) = x;
      }
      if (whole) {
        const int at = (wa + b) * ncp + 4 * q;
        if (kSelect && c == b) *reinterpret_cast<float4*>(dbc + at) = x;
        if (kDac && c == a) *reinterpret_cast<float4*>(m6 + at) = x;
      }
      fma4(ts, 1.f, x);
      if (kGroupD && whole) fma4(ws, R[c], x);
    }
    // T_ab[a,b] (into tab for a whole slot, tabT for the tile's rows) and
    // M6[a,b].
    const float z = reduce_over_columns(ts, ws, h, quads);
    if (h < 8) {
      const int ch = 4 * q + (which & 3);
      if (which < 4) {
        if (row) tabT[(bl * P + a) * ncp + ch] = z;
        if (whole) tab[(wa + b) * ncp + ch] = z;
      } else if (kGroupD && whole) {
        m6[(wa + b) * ncp + ch] = z;
      }
    }
  };

  for (int i = tid; i < kMaps * sp.mapw; i += nth) s.maps[i] = 0.f;
  if constexpr (kTma) {
    // The piece list, the whole slots' weights and the ring's mbarriers.
    for (int j = tid; j < np; j += nth) {
      int a, b0;
      piece(j, a, b0);
      int rows = 0;
      for (int bl = 0; bl < X && b0 + bl < P; ++bl)
        rows |= (int)src.row_present(sp, a, b0 + bl) << bl;
      s.plist[j] = piece_entry(a, b0, rows);
    }
    for (int i = tid; i < nx * P; i += nth) {
      const int xl = i / P, j = i - xl * P;
      const int* perm = src.spos + (x0 + xl) * P;
      float cols = 0.f, r = 0.f;
      for (int c = 0; c < P; ++c) {
        if (perm[c] == j) {
          cols += 1.f;
          r += R[c];
        }
      }
      s.wts[i] = make_float2(cols, r);
    }
    if (tid == 0) {
      for (int i = 0; i < sp.D; ++i) {
        mbar_init(s.bars + i, 1);
        mbar_init(s.bars + sp.D + i, pieces(sp) * X);
      }
      fence_mbarrier_init();
    }
    // Every thread's writes to shared memory so far (the ring's zeros, maps
    // or products that lay over it) ordered before the tensor copies.
    fence_proxy_async();
  }
  __syncthreads();
  bool streamed = false;
  if constexpr (kTma) {
    static_assert(kWarpRows && kGroupD && kSelect && !kDac,
                  "the tensor copies feed K1's and K2's cluster blocks");
    // The tensor-copy route's consumers (kTma): a row in storage order at
    // `rowp`, cell j of it state[n, p1, j, c0:c0+ncp].  A row of the tile's
    // rows X (b = x0 + bw, the piece's first row x0) reads column c at cell
    // perm[c] = pos[a, c] (zero where absent), since T_bc's and M10's
    // registers follow c: four float4 sums a cell and, for a whole slot a in
    // X, M6's; the same sums in the same order as the cp.async route.
    // kWhole: a in X.  The picks D_ac[b,a] (and D_bc[a,b]) are one cell
    // each, read once after the loop by the lanes h = 0.
    auto cell_at = [&](const char* rowp, int at) {
      return at < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : load4(reinterpret_cast<const E*>(
                          rowp + (at * ncp + 4 * q) * es));
    };
    auto reduce_tile_row = [&](auto whole_tag, int a, const char* rowp) {
      constexpr bool kWhole = decltype(whole_tag)::value;
      const int* perm = src.spos + a * P;
      const int b = x0 + bw, wa = (a - x0) * P;
      SASS_MARK();
      const float ra = R[a];
      float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), ws = ts;
#pragma unroll
      for (int k = 0; k < kMaxCells; ++k) {
        const int c = h + H * k;
        if (c >= P) break;
        const float4 x = cell_at(rowp, perm[c]);
        fma4(acc_tbc[k], 1.f, x);
        fma4(acc_m10[k], ra, x);
        fma4(ts, 1.f, x);
        if constexpr (kWhole) fma4(ws, R[c], x);
      }
      SASS_MARK();
      const float z = reduce_over_columns(ts, ws, h, quads);
      if (h < 8) {
        const int ch = 4 * q + (which & 3);
        if (which < 4) {
          tabT[(bw * P + a) * ncp + ch] = z;
          if constexpr (kWhole) tab[(wa + b) * ncp + ch] = z;
        } else if constexpr (kWhole) {
          m6[(wa + b) * ncp + ch] = z;
        }
      }
      if (h == 0) {
        *reinterpret_cast<float4*>(dacT + (bw * P + a) * ncp + 4 * q) =
            cell_at(rowp, perm[a]);
        if constexpr (kWhole)
          *reinterpret_cast<float4*>(dbc + (wa + b) * ncp + 4 * q) =
              cell_at(rowp, perm[b]);
      }
    };
    // A row b outside X of a whole slot a in X adds only to the slot's
    // T_ab[a,b] = sum_c x[perm[c]] and M6[a,b] = sum_c R[c] x[perm[c]], which
    // it reads in storage order against the slot's weights w[j] = (the
    // columns c with perm[c] = j, the sum of their R[c]), zero for a cell of
    // no column: no index and no test a cell.  (A cell of no column that held
    // an infinity or a NaN would leak into the sums, as no finite state
    // does.)  Then the pick D_bc[a,b] = x[perm[b]].
    auto reduce_slot_row = [&](int a, int b, const char* rowp) {
      SASS_MARK();
      const float2* w = s.wts + (a - x0) * P;
      float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), ws = ts;
#pragma unroll
      for (int k = 0; k < kMaxCells; ++k) {
        const int j = h + H * k;
        if (j >= P) break;
        const float4 x = load4(reinterpret_cast<const E*>(
            rowp + (j * ncp + 4 * q) * es));
        const float2 wj = w[j];
        fma4(ts, wj.x, x);
        fma4(ws, wj.y, x);
      }
      SASS_MARK();
      const float z = reduce_over_columns(ts, ws, h, quads);
      const int at = ((a - x0) * P + b) * ncp;
      if (h < 8) (which < 4 ? tab : m6)[at + 4 * q + (which & 3)] = z;
      if (h == 0)
        *reinterpret_cast<float4*>(dbc + at + 4 * q) =
            cell_at(rowp, src.spos[a * P + b]);
    };
    stream_rows_producer(src, sp, s, c0, np, [&](int e, const char* rowp) {
      const int a = piece_slot(e), b0 = piece_row(e);
      if (b0 != x0)
        reduce_slot_row(a, b0 + bw, rowp);
      else if (a >= x0 && a < x0 + nx)
        reduce_tile_row(std::true_type{}, a, rowp);
      else
        reduce_tile_row(std::false_type{}, a, rowp);
    });
    streamed = true;
  } else if constexpr (kWarpRows) {
    if (regs) {
      stream_rows(src, sp, s, c0, nc, np, piece,
                  [&](int a, int b0, const char* buf) {
                    reduce_row(a, b0, bw, buf);
                  });
      streamed = true;
    }
  }
  if (!streamed) {
    stream_pieces(src, sp, s, c0, nc, np, piece,
                  [&](int j, int a, int b0, const char* buf) {
      const int nb = min(X, P - b0);
      if (regs) {
        if (gw == j % pieces(sp) && bw < nb)
          reduce_row(a, b0, bw, buf);
      } else {
        for (int bl = warp; bl < nb; bl += nwarps)   // the whole warp
          reduce_row(a, b0, bl, buf);
      }
    });
  }
  if (regs) {
    // The warps' cells of T_bc and M10, added in warp order (on the
    // tensor-copy route those of the consumer warps).
    for (int g = 0; g < (kTma ? pieces(sp) : nwarps / X); ++g) {
      if (gw == g && bw < nx) {
#pragma unroll
        for (int k = 0; k < kMaxCells; ++k) {
          const int c = h + H * k;
          if (c >= P) break;
          const int at = (bw * P + c) * ncp + 4 * q;
          float4 sum = load4(tbc + at);
          fma4(sum, 1.f, acc_tbc[k]);
          *reinterpret_cast<float4*>(tbc + at) = sum;
          if constexpr (kGroupD) {
            float4 weighted = load4(m10 + at);
            fma4(weighted, 1.f, acc_m10[k]);
            *reinterpret_cast<float4*>(m10 + at) = weighted;
          }
        }
      }
      __syncthreads();
    }
  }

  if constexpr (!kSelect) {
    // Every pick replaced by the full sum (picks_as_sums, on the tile's
    // rows): D_bc = T_ab, D_ac = T_ab, T_bc[x,c] = T_b[x] and M10[x,c] =
    // sum_a R[a] T_ab[a,x] for every c.
    for (int i = tid; i < nx * P * ncp; i += nth) {
      dbc[i] = tab[i];
      dacT[i] = tabT[i];
    }
    for (int item = tid; item < nx * ncp; item += nth) {
      const int f = item % ncp, xl = item / ncp;
      float tb = 0.f, rb = 0.f;
      for (int a = 0; a < P; ++a) {
        const float v = tabT[(xl * P + a) * ncp + f];
        tb += v;
        rb += R[a] * v;
      }
      for (int c = 0; c < P; ++c) {
        tbc[(xl * P + c) * ncp + f] = tb;
        m10[(xl * P + c) * ncp + f] = rb;
      }
    }
    __syncthreads();
  }
  // The tile's rows of T_a, T_b, sum_b T[x,b,b], sum_a T[a,x,a].
  for (int item = tid; item < nx * ncp; item += nth) {
    const int f = item % ncp, xl = item / ncp;
    float ta = 0.f, tb = 0.f, td = 0.f, te = 0.f;
    for (int y = 0; y < P; ++y) {
      const int at = (xl * P + y) * ncp + f;
      ta += tab[at]; tb += tabT[at]; td += dbc[at]; te += dacT[at];
    }
    s.ta[item] = ta; s.tb[item] = tb; s.tdbc[item] = td; s.tdac[item] = te;
  }
  __syncthreads();
}

// The loads of a row-tiled stream alone (the ablation variant dma): every
// row of every slot that `src` yields for the chunk, a piece of sp.rows rows
// at a time, each thread adding up the cells it reads.  Returns
// this thread's sum; ends with a barrier.
template <typename Src>
__device__ inline float tile_loads(const Src& src, const StreamPlan& sp,
                                   const StreamBuffers& s, int c0, int nc) {
  using E = typename Src::Elem;
  const int P = sp.P, X = sp.rows, ncp = sp.ncp, quads = ncp / 4;
  const int nrg = (P + X - 1) / X, es = (int)sizeof(E);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const RowItems cells = row_items(sp, quads);
  stream_pieces(src, sp, s, c0, nc, src.count(P) * nrg,
                [&](int j, int& a, int& b0) {
                  a = src.slot(j / nrg);
                  b0 = (j % nrg) * X;
                },
                [&](int, int, int b0, const char* buf) {
    for_row_items(sp, cells, min(X, P - b0), [&](int bl, int c, int q) {
      fma4(acc, 1.f, load4(reinterpret_cast<const E*>(
                         buf + bl * sp.rowb + (c * ncp + 4 * q) * es)));
    });
  });
  return acc.x + acc.y + acc.z + acc.w;
}

}  // namespace level
}  // namespace risi18
