// UCA block relaxation rounds for Hopper (sm_90a), float32.
//
// Replaces both Pallas kernels of pydem_tpu/ops/uca_block.py.  Each computes
// one round of
//     area = base + sum_k shift_k(W_k * area)
// over B x B blocks: Jacobi sweeps inside a block with its 1-px halo frozen,
// 4 sweeps per convergence test, capped at inner_max, then write-back and
// the block's changed flag.
//  * K1 replaces _gs_kernel: the compact receiver encoding (packed index
//    plane K, slot-1 weight W1, slot-2 weight 1 - W1) and a frontier skip
//    when no block of the 3x3 neighbourhood changed last round.  Its
//    rounds, in the TPU's order, run as uca_gs_dataflow_kernel, one
//    persistent launch a round (below).
//  * K2, uca_block_round_kernel, replaces _block_kernel: the 8 dense weight
//    planes, read straight from device memory, any nonnegative weights and
//    any number of them per pixel, every block visited.
// All end in relax_block, templated on where the weights come from.
//
// Differences from the TPU kernels, by design:
//  * The TPU runs K1's grid in sequence, in place: each block reads the live
//    canvas, so it sees this round's values of every block visited before
//    it; the visit order cycles through four corner orientations (_FLIPS),
//    and the grid is every block, the interior blocks, or the frame walked
//    top row, bottom row, then the side columns row by row (the subset
//    branches).  CUDA CTAs of one launch run in no order.  From the visit
//    sequence, a block's predecessors are its halo neighbours in the grid
//    that come before it (at most MAX_PREDS); the host sorts the blocks by
//    level (1 + the predecessors' highest level), a topological order, into
//    a table of rows (block, predecessors).  uca_gs_dataflow_kernel runs the
//    round as one launch: each CTA draws the next row from a ticket counter,
//    stages the block's weights and base, waits until every predecessor has
//    published this round's epoch (device-scope release after its write-back
//    and a barrier; device-scope acquire before reading the halo), relaxes
//    in place and publishes.  A block waits only for lower tickets, held by
//    CTAs already running, so the round cannot deadlock whatever the grid or
//    whatever else shares the card; a block that skips (a clean
//    neighbourhood in prev) publishes at once, so dirty blocks that no chain
//    of dirty predecessors links run together.  Every block reads what the
//    sequential grid's block reads, so the round equals it bit for bit,
//    canvas and flags: the plain version (ops/uca_block.py::
//    gs_round_oriented_plain) and the JAX round in the same form compute the
//    same.
//  * K2 reads the round-start canvas x and writes a second buffer x_out
//    (block-Jacobi), as it does on the TPU too; its plain version
//    (block_round_plain) reproduces it bit for bit.
//  * The halo is 1 px in shared memory, not the TPU's (8, 128)-aligned pads
//    or K2's pre-exploded (B+16, B+256) tiles.  Out of the canvas, x and
//    the weights read 0.
//  * B is 8, 16, 32, 64, 128 or 256 for both kernels (every B the JAX
//    package picks for a canvas or a shard).  One CTA holds a visit up to
//    B = 64.  A 258^2 float32 window
//    (266 KB) is more than one SM's 228 KB of shared memory, so at B = 128
//    and 256 a visit is split over a thread-block cluster (below).
//
// The cluster visit (B = 128: 4 CTAs of 32 rows; B = 256: 16 CTAs of 16
// rows, above the portable cluster size of 8, so the kernels allow the
// non-portable size).  Each CTA of the cluster owns a band of BR = B / C
// rows across the whole block width, with the same thread mapping as a
// one-CTA visit (R = 8 rows a thread, one column a lane, 512 threads), and
// keeps its own windows of the band and a ghost row above and below: the
// neighbouring bands' rows next to the cut (on the block's rim, the frozen
// halo row).  After each sweep a band sends its first and last rows and
// its edge strips' changed flags into the neighbours' ghost rows of the
// window the next sweep reads, as asynchronous stores
// (st.async.shared::cluster) that count their bytes on an mbarrier of the
// receiving CTA (one for each window); a skipped edge strip sends its rows
// too (its window already holds them), so every sweep brings each band a
// fixed count of bytes.  The threads that read a ghost row next sweep wait
// on their mbarrier for those bytes (acquire at cluster scope).  Nothing
// else crosses the cut: having the neighbour's rows of sweep t also says
// that the neighbour has read what it reads of this band's rows of sweep t
// - 1 (a thread sends its row after reading its window), so a band
// overwrites them at sweep t + 1 without a barrier over the cluster; bands
// run apart by up to C - 1 sweeps.  The 4-sweep convergence test is a vote:
// each CTA sends its band's "changed" of the group's last sweep to every
// CTA the same way, and every CTA reads the votes of group g at the end of
// group g + 1 and leaves the loop then if none is set; a block whose 4th
// sweep changed nothing is at its fixed point, so the group swept in
// between changed nothing, and every CTA leaves at the same sweep, the
// whole block's exit.  The vote mbarriers and slots cycle over eight
// groups (more than the C - 1 sweeps the bands run apart); each mbarrier
// completes one phase a use, one arrival (the arming thread's, with the
// bytes it expects) and the bytes, so a store that lands before the arming
// waits for it and none can count towards an earlier phase.  Every
// mbarrier is initialised at the start of a visit and invalidated after
// its closing cluster barrier, when every byte counted on it has landed;
// a wait longer than WAIT_LIMIT_NS traps, so a fault fails the launch
// instead of hanging it.  The first cluster visit put a cluster barrier
// (arrive.release / wait.acquire) after every sweep; its release, waiting
// out each CTA's stores into the neighbours, cost more than half of a
// sweep (the sweep probe, uca_probe_kernel, times that visit with its
// stores cut and with its barriers after sweeps 1-3 of a group made CTA
// barriers, beside this one).  Each CTA writes its band back; the block's
// changed flag is the OR of the bands' (stored into rank 0's slots, then a
// cluster barrier).
// Every pixel's sum is the same rounding sequence as in a one-CTA visit,
// and the sweeps, the skips and the exit are the whole block's, so a
// cluster visit equals the plain version bit for bit.  The dataflow kernel
// draws its tickets per cluster (rank 0 draws and stores the ticket into
// every CTA's slot); after a visit's last cluster barrier, which follows
// every CTA's write-back, rank 0 alone fences and publishes the block's
// "done" epoch with a device-scope release: the cluster barrier's
// release/acquire orders every band's write-back before rank 0's fence,
// and the fence is cumulative, so a successor that acquires the epoch
// reads every band.  One publication a block keeps the epoch protocol and
// the waiters as they are.  The persistent grid is the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters); a launch whose cluster
// cannot be resident fails, and the wrappers raise.
//
// K1 has a ring form (RING = 1), for a window of a larger canvas (an
// engine visit, a shard): x, K and W1 carry a 1-px ring around the n x m
// region that the blocks tile.  The ring of x is read as the frozen halo of
// the region's rim blocks and never written; the ring of K and W1 is real,
// because ring pixels send flow into the region.  base, prev and chg cover the region only.  Every pixel's sum
// is then the same rounding sequence as in a round over the whole canvas.
// Rows of m + 2 floats are not 128-byte aligned; the loads are a few
// percent of a visit.  The subset rounds of the TPU's order (the mesh's
// split round: the interior while the ring lands, then the frame) are
// dependency tables of the subset's blocks; their flags are written in
// block space, where the TPU's frame wrote program ids.
//
// What bounds it on the card.  Per visited block a round reads the halo
// window of x, the weights of the block's sources (K1: K at 1 B and W1;
// K2: 8 planes at 4 B each) and base, and writes the block: about 17 bytes
// of HBM traffic per visited pixel per round for K1 (71 MB for a full round
// at 2048^2), about 44 for K2 (185 MB), a few percent of the round's time.
// The time goes into the sweeps of a visit, up to inner_max = 2B+4 of them:
// 16 float operations per pixel per sweep, and the shared-memory
// instructions that feed them.  The design keeps those instructions few and
// does not repeat sweeps that cannot change anything:
//  * Weights and base live in registers.  A thread owns R vertically
//    adjacent pixels of one column (lanes across columns); it decodes (K1,
//    from a K/W1 source window staged once in the shared memory that the x
//    windows use afterwards) or loads (K2, coalesced from the 8 planes) the
//    8 incoming weights of each of its pixels once per visit and keeps them
//    for all sweeps.  Shared memory holds the two x windows and the strip
//    flags: 35,008 bytes at B = 64, under 48 KB at every B (Shape::SMEM).
//  * A register-tiled window.  Per sweep a thread reads the (R+2) x 3 window
//    around its strip once and forms its R sums from registers: 30 loads and
//    8 stores per 8 pixels at R = 8, where one pixel a time needs 17 and 1.
//    The x window is double-buffered, so a sweep needs one barrier.
//  * In-block activity skip.  The pixels of one warp form a strip; each
//    strip has a "changed in the last sweep" flag (two sets, like the
//    window).  A warp recomputes its strip only if a strip of its 3 x 3 strip
//    neighbourhood changed in the sweep before; else it writes nothing and
//    reports "unchanged".  That is exact: unchanged inputs give the value
//    the strip already has, and the buffer about to be written still holds
//    that value from two sweeps ago.  "Changed" is acc != cur, so a strip
//    with a NaN always recomputes.  In Jacobi sweeps only the wave that
//    entered through the halo moves; the rest of the block is skipped.
//  * Convergence is tested with __syncthreads_or every 4th sweep, and K1
//    skips converged block neighbourhoods entirely (the frontier).
//  * The prologue off the critical path: a dataflow CTA stages a block's
//    W1 window with cp.async and its K window into the shared memory the x
//    windows use afterwards, decodes the weights into registers and loads
//    the base before it waits for the predecessors; only the x window is
//    read after the wait.
// Not used, on purpose: tensor cores (wgmma), because the sum must be eight
// separately rounded float32 products added in a fixed order, which no
// matrix unit gives; TMA for the window, because a visit reads about 70 KB
// once and then sweeps for tens of microseconds.  A visit up to B = 64 runs
// on one SM, at B = 128 and 256 on the C SMs of its cluster.
//
// Numerics: the sum is base + w_0 x_0 + ... + w_7 x_7 in NEIGHBOR_OFFSETS
// order with separate multiply and add roundings (__fmul_rn/__fadd_rn, and
// the file is built with -fmad=false), as the plain versions compute it.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// NEIGHBOR_OFFSETS (core/stencil.py): E, NE, N, NW, W, SW, S, SE.
__device__ __forceinline__ constexpr int off_i(int k) {
  return (k >= 1 && k <= 3) ? -1 : ((k >= 5) ? 1 : 0);
}
__device__ __forceinline__ constexpr int off_j(int k) {
  return (k <= 1 || k == 7) ? 1 : ((k >= 3 && k <= 5) ? -1 : 0);
}

// The most predecessors a block has in a round in the TPU's order
// (ops/uca_block.py MAX_PREDS); a dependency table row is the block and its
// predecessors, -1 past the last.
constexpr int MAX_PREDS = 4;
constexpr int ROW = 1 + MAX_PREDS;

// A 4-byte asynchronous copy into shared memory; src_bytes = 0 fills zeros
// and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Device-scope acquire load and release store of a "done" epoch.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// This CTA's rank in its cluster, and the cluster barrier: every thread of
// every CTA of the cluster arrives (release) and waits (acquire), so it
// also orders the CTA's own shared memory as __syncthreads does.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// p, a variable in this CTA's shared memory, in the shared memory of the
// cluster's CTA `rank` (distributed shared memory).
template <class T>
__device__ __forceinline__ T* in_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
}
// The 32-bit shared::cluster address of this CTA's shared-memory address
// `a` in the cluster's CTA `rank`, and stores through such an address: the
// stores into a neighbour's shared memory, which keep no 64-bit pointer.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(a), "r"(rank));
  return d;
}
__device__ __forceinline__ void st_cluster(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n"
               :: "r"(a), "r"(v) : "memory");
}
// Asynchronous stores into another CTA's shared memory that count their
// bytes on an mbarrier there (`bar`, in the same CTA as `a`): the receiver
// waits on its own mbarrier for the bytes it expects, and no release fence
// is needed.  The mbarrier calls below take shared::cta addresses.
__device__ __forceinline__ void st_async(unsigned a, unsigned v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" :: "r"(a), "r"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(bar) : "memory");
}
// after the last use of an initialised mbarrier, before it is initialised
// again
__device__ __forceinline__ void mbar_inval(unsigned bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}
// one arrival (the mbarrier's only one a phase) that also expects `bytes`
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Nanoseconds on the device's global timer.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this is a fault (no round waits a second for one
// block): the kernel traps, and the launch fails instead of hanging.
constexpr unsigned long long WAIT_LIMIT_NS = 20000000000ULL;

// whether the phase of parity `parity` has completed (the thread may be
// suspended a while first); acquire at cluster scope, so the bytes that
// completed it are seen
__device__ __forceinline__ bool mbar_try(unsigned bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
      " %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// until that phase has completed; the timer is read only once the first
// try has failed, and then once every 2^16 tries: past WAIT_LIMIT_NS, trap
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  for (unsigned k = 1; !mbar_try(bar, parity); ++k) {
    if ((k & 0xffffu) == 0 && global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// The cluster visits (C > 1).  CLUSTER_VISIT is the one the kernels run;
// the others exist for the sweep probe (uca_probe_kernel), which times them
// and whose results the variants marked "probe" get wrong by design:
//  * ASYNC: every sweep's edge rows and edge strips' flags sent to the
//    neighbours as asynchronous stores counted on their mbarriers, the
//    vote sent alike and read one group late (the file's header);
//  * SWEEP: the edge rows and edge strips' flags stored into the
//    neighbours every sweep and a cluster barrier after every sweep (the
//    first cluster visit);
//  * SWEEP_NO_STORES (probe): SWEEP with the stores into the neighbours
//    cut;
//  * SWEEP_CTA_BARRIER (probe): SWEEP with a CTA barrier after sweeps 1-3
//    of a group (the 4th sweep's vote keeps its cluster barrier).
enum Visit : int {
  ASYNC = 0,
  SWEEP = 1,
  SWEEP_NO_STORES = 2,
  SWEEP_CTA_BARRIER = 3,
};
constexpr int N_VISITS = 4;
constexpr int CLUSTER_VISIT = ASYNC;

// A block visit at block size B runs on a cluster of C CTAs (C = 1 up to
// B = 64), each owning a band of BR = B / C rows.  Thread (tx, ty) of a
// (B, TY) CTA owns the pixels of column tx in rows ty*R .. ty*R + R - 1 of
// its band.  The pixels of one warp form a strip of SH rows by LW columns;
// the band is a grid of SR x SC strips.
template <int B>
struct Shape {
  static constexpr int C = (B <= 64) ? 1 : ((B == 128) ? 4 : 16);
  static constexpr int BR = B / C;  // rows of a CTA's band
  // rows per thread: 8 from B = 64, 4 at 16 and 32, 2 at 8 (a warp)
  static constexpr int R = (B >= 64) ? 8 : ((B >= 16) ? 4 : 2);
  static constexpr int TY = BR / R;  // thread rows
  static constexpr int THREADS = B * TY;
  static constexpr int LW = (B < 32) ? B : 32;  // strip width
  static constexpr int SH = R * (32 / LW);      // strip height
  static constexpr int SR = BR / SH, SC = B / LW;
  // The band with a row above and below: the block's halo row, or at C > 1
  // the neighbouring band's row next to the cut (its ghost row).
  static constexpr int WR = BR + 2, WC = B + 2;  // window rows, columns
  static constexpr int WIN = WR * WC;            // floats of one window
  // strip flags with a ghost row above and below: the flags of the
  // neighbouring bands' edge strips (0 on the block's rim: the halo is
  // frozen)
  static constexpr int NF = (SR + 2) * SC;
  // Dynamic shared memory: two x windows, then two sets of strip flags (at
  // O_FLAGS floats from the start).
  static constexpr int O_FLAGS = 2 * WIN;
  static constexpr size_t SMEM = (O_FLAGS + 2 * NF) * sizeof(float);
  static_assert(B % C == 0 && BR % SH == 0 && THREADS % 32 == 0,
                "whole warps");
  static_assert(SR * SC * 32 == THREADS, "one strip a warp");
  static_assert(THREADS <= 1024, "one CTA");
  // at C > 1 a thread sends one row and a lane one flag at most
  static_assert(C == 1 || (LW == 32 && TY >= 2), "one neighbour a thread");
  static_assert(SMEM <= 48 * 1024, "fits without the opt-in limit");
};

// Incoming weights from the compact receivers (K1): the weight that the
// source q = p - o_k sends along k is decoded from K and W1 at q (slot 2
// carries 1 - W1, as expand_compact builds it; k2 == 15: none).  RING = 1:
// K and W1 are (n + 2, m + 2) planes whose 1-px ring is real, so every source
// of the window is read; RING = 0: (n, m), no source outside the canvas.
template <int RING>
struct CompactWeights {
  const uint8_t* K;
  const float* W1;

  // w[r][k] for the thread's R pixels of the band from row i0.  The
  // WR x WC source window of K and W1 is staged in `scratch` (the x
  // windows' memory, free until this returns), then each thread reads the
  // (R+2) x 3 sources around its strip once and hands each source's weights
  // to the pixels that receive them.
  template <int B>
  __device__ __forceinline__ void load(float (&w)[Shape<B>::R][8],
                                       float* scratch, int n, int m, int i0,
                                       int j0) const {
    using S = Shape<B>;
    constexpr int R = S::R, WC = S::WC;
    float* w1s = scratch;
    uint8_t* ks = reinterpret_cast<uint8_t*>(scratch + S::WIN);
    const int tx = threadIdx.x, r0 = threadIdx.y * R;
    for (int t = threadIdx.y * B + tx; t < S::WIN; t += S::THREADS) {
      const int gi = i0 - 1 + t / WC, gj = j0 - 1 + t % WC;
      const bool in = RING || (gi >= 0 && gi < n && gj >= 0 && gj < m);
      const size_t g = (size_t)(gi + RING) * (m + 2 * RING) + (gj + RING);
      cp_async4(w1s + t, in ? W1 + g : W1, in ? 4 : 0);  // 0.f outside
      ks[t] = in ? K[g] : (uint8_t)255;
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < R + 2; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int t = (r0 + q) * WC + tx + c;
        const int kk = ks[t];
        const int k1 = kk >> 4, k2 = kk & 15;
        const float w1 = w1s[t];
        const float w2 = __fsub_rn(1.f, w1);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          // the pixel of this strip that source (q, c) reaches along k
          const int r = q - 1 + off_i(k);
          if (off_j(k) == 1 - c && r >= 0 && r < R) {
            w[r][k] = (k1 == k) ? w1 : ((k2 == k) ? w2 : 0.f);
          }
        }
      }
    }
    __syncthreads();  // the caller overwrites scratch
  }
};

// Incoming weights from the 8 dense planes (K2): any nonnegative weights,
// any number of them per pixel; 0 for a source outside the canvas.
struct DenseWeights {
  const float* W;

  template <int B>
  __device__ __forceinline__ void load(float (&w)[Shape<B>::R][8],
                                       float* /*scratch*/, int n, int m,
                                       int i0, int j0) const {
    constexpr int R = Shape<B>::R;
    const size_t plane = (size_t)n * m;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int gi = i0 + threadIdx.y * R + r - off_i(k);
        const int gj = j0 + threadIdx.x - off_j(k);
        const bool in = gi >= 0 && gi < n && gj >= 0 && gj < m;
        w[r][k] = in ? W[k * plane + (size_t)gi * m + gj] : 0.f;
      }
    }
  }
};

// What a visit waits for between its prologue (the weights and the base,
// which nothing in the round writes) and its read of the x window.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// The dataflow round's wait: threads 0..MAX_PREDS-1 each take one
// predecessor's "done" epoch with a device-scope acquire, then the barrier
// hands what they acquired to every thread of the CTA.  Every CTA of a
// cluster waits for itself: each reads its own halo.
struct WaitPreds {
  const int* preds;  // MAX_PREDS flat block indices, -1 past the last
  const int* done;
  int epoch;

  __device__ __forceinline__ void operator()() const {
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    if (t < MAX_PREDS) {
      const int p = preds[t];
      if (p >= 0) {
        const unsigned long long t0 = global_ns();
        while (ld_acquire(done + p) != epoch) {
          __nanosleep(32);
          if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
        }
      }
    }
    __syncthreads();
  }
};

// The cluster's vote slots: each CTA stores its convergence vote into
// every CTA's slot of its rank (`sweep`: set 0 in SWEEP, which reads it
// under the group's cluster barrier; set g & 7 for group g in ASYNC), and
// its changed flag (`moved`) into rank 0's; the dataflow kernel's ticket,
// stored by rank 0 into every CTA, alternates between two slots.
// `origin`: the visit's band origin and flat block index, read again for
// the write-back, so that no register holds them through the sweeps.
template <int C>
struct Votes {
  // ASYNC: the mbarriers of the rows and flags landing in window 0 / 1,
  // and of the votes of group g at g & 7 (bands run up to C - 1 sweeps
  // apart, so up to five groups' votes are in flight)
  unsigned long long bar[2], vbar[8];
  int sweep[8][C];
  int moved[C];
  int ticket[2];
  int origin[3];
};

// One sweep of a band (relax_block): each thread's R pixels from the
// (R+2) x 3 window around them in `cur`, into `nxt`, skipped when no strip
// of the warp's 3x3 strip neighbourhood (the flag `poll` of lanes 0..8)
// changed in the sweep before.  Returns the warp's "changed".  STORES: the
// band's first and last rows also into the neighbours' windows through
// `row_to` (0: none), `buf` bytes into the buffer written; 1 (SWEEP): the
// rows computed, as plain stores; 2 (ASYNC): every sweep's rows, skipped or
// not, as asynchronous stores counted on the neighbour's mbarrier `bar`.
template <int B, int STORES>
__device__ __forceinline__ int band_sweep(
    const float (&w)[Shape<B>::R][8], const float (&bse)[Shape<B>::R],
    const float* cur, float* nxt, const int* f_rd, int poll, int r0,
    unsigned row_to, unsigned buf, unsigned bar) {
  using S = Shape<B>;
  constexpr int R = S::R, WC = S::WC;
  const int tx = threadIdx.x;
  int local = 0;
  if (__any_sync(0xffffffffu, poll >= 0 && f_rd[poll])) {
    float v[R + 2][3];
#pragma unroll
    for (int q = 0; q < R + 2; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[q][c] = cur[(r0 + q) * WC + tx + c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = bse[r];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc = __fadd_rn(
            acc, __fmul_rn(w[r][k], v[r + 1 - off_i(k)][1 - off_j(k)]));
      }
      local |= (acc != v[r + 1][1]);
      nxt[(r0 + 1 + r) * WC + tx + 1] = acc;
      if constexpr (STORES) {
        if ((r == 0 || r == R - 1) && row_to
            && (r == 0) == (threadIdx.y == 0)) {
          if constexpr (STORES == 1) {
            st_cluster(row_to + buf, acc);
          } else {
            st_async(row_to + buf, __float_as_uint(acc), bar);
          }
        }
      }
    }
    local = __any_sync(0xffffffffu, local);
  } else if constexpr (STORES == 2) {
    // a skipped strip's window already holds its value after this sweep
    if (row_to) {
      const int r = (threadIdx.y == 0) ? 0 : R - 1;
      st_async(row_to + buf,
               __float_as_uint(nxt[(r0 + 1 + r) * WC + tx + 1]), bar);
    }
  }
  return local;
}

// The two x windows and the two flag sets trade places after a sweep.
__device__ __forceinline__ void swap_buffers(float*& cur, float*& nxt,
                                             int*& f_rd, int*& f_wr) {
  float* t = cur;
  cur = nxt;
  nxt = t;
  int* f = f_rd;
  f_rd = f_wr;
  f_wr = f;
}

// Relax block (bi, bj) to its local fixed point with its 1-px halo frozen,
// write it to x_out and its changed flag to chg.  Every kernel ends here;
// at C > 1 every CTA of the cluster calls it for the same block, each on its
// band (see the cluster visit at the top of the file), and it ends in a
// cluster barrier after which rank 0 has written chg.
// The weights and the base come first, then wait(), then the x window.
// x and x_out are the same canvas for the in-place dataflow launch, so
// neither is __restrict__ here (the kernels that write a second buffer say
// so on their own parameters).
// RING = 1: x and x_out are (n + 2, m + 2) with the region at (1, 1), and the
// halo of a rim block is the ring; RING = 0: (n, m), the halo reads 0 there.
template <int B, int RING, class Weights, class Wait = NoWait,
          int VISIT = CLUSTER_VISIT>
__device__ __forceinline__ void relax_block(
    const float* x, const Weights& weight,
    const float* __restrict__ base, float* x_out,
    int* __restrict__ chg, int n, int m, int inner_max, int bi, int bj,
    Votes<Shape<B>::C>& votes, const Wait& wait = Wait()) {
  using S = Shape<B>;
  constexpr int R = S::R, WR = S::WR, WC = S::WC, C = S::C;
  constexpr int SR = S::SR, SC = S::SC, NF = S::NF, TY = S::TY;
  constexpr int WIN = S::WIN;
  extern __shared__ float smem[];
  float* cur = smem;       // x window read by this sweep
  float* nxt = smem + WIN;  // x window written by this sweep
  int* flags = reinterpret_cast<int*>(smem + S::O_FLAGS);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * B + tx, lane = tid & 31;
  int rank = 0;
  if constexpr (C > 1) rank = cluster_rank();
  const int i0 = bi * B + rank * S::BR, j0 = bj * B, r0 = ty * R;
  const size_t pitch = m + 2 * RING;  // row length of x and x_out
  const bool above = rank > 0, below = rank < C - 1;  // neighbouring bands

  // Once per visit, into registers: the incoming weights and the base.
  float w[R][8];
  weight.template load<B>(w, smem, n, m, i0, j0);
  float bse[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bse[r] = base[(size_t)(i0 + r0 + r) * m + (j0 + tx)];
  }
  wait();
  // Halo window of x into both buffers (the block's halo stays frozen; the
  // rows next to another band are that band's, kept current by its stores).
  for (int t = tid; t < WIN; t += S::THREADS) {
    const int gi = i0 - 1 + t / WC, gj = j0 - 1 + t % WC;
    float v = 0.f;
    if (RING || (gi >= 0 && gi < n && gj >= 0 && gj < m)) {
      v = x[(size_t)(gi + RING) * pitch + (gj + RING)];
    }
    cur[t] = v;
    nxt[t] = v;
  }
  if (tid == 0) {
    votes.origin[0] = i0;
    votes.origin[1] = j0;
    votes.origin[2] = bi * (m / B) + bj;
    if constexpr (C > 1 && VISIT == ASYNC) {
      // (a dataflow CTA's visit before this one invalidated them)
      for (int k = 0; k < 8; ++k) {
        if (k < 2) {
          mbar_init(static_cast<unsigned>(__cvta_generic_to_shared(
              votes.bar + k)));
        }
        mbar_init(static_cast<unsigned>(__cvta_generic_to_shared(
            votes.vbar + k)));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // Strip flags: the first sweep finds every strip "changed"; a ghost row
  // with no band beyond it stays 0 in both sets.
  int* f_rd = flags;       // written by the sweep before
  int* f_wr = flags + NF;  // written by this sweep
  for (int t = tid; t < NF; t += S::THREADS) {
    const int row = t / SC;
    f_rd[t] = !((row == 0 && !above) || (row == SR + 1 && !below));
    f_wr[t] = 0;
  }
  // the windows and flags are set before a neighbour's first store into
  // this CTA's shared memory
  if constexpr (C > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  // This warp's strip, and the strip of its 3x3 neighbourhood that this
  // lane polls (lanes 0..8; a ghost row above or below the band; -1: none).
  const int sr = ty / (32 / S::LW), sc = tx / S::LW;
  const int qc = sc + lane % 3 - 1;
  const int poll = (lane < 9 && qc >= 0 && qc < SC)
                       ? (sr + lane / 3) * SC + qc : -1;
  const int own = (sr + 1) * SC + sc;

  int it = 0;
  int changed = 1;
  if constexpr (C == 1 || VISIT != ASYNC) {
    // A barrier a sweep.  At C > 1 (SWEEP and its probes): the threads of
    // the band's first row (ty = 0) store their pixels into the bottom
    // ghost row of the band above, those of its last row (ty = TY - 1)
    // into the top ghost row of the band below, in the buffer this sweep
    // writes; lane 0 of a strip on the band's first or last strip row its
    // flag into that band's ghost flag row.  Addresses in the first buffer
    // or flag set; 0: no store.
    constexpr int STORES = C > 1 && VISIT != SWEEP_NO_STORES;
    unsigned row_to = 0, flag_to = 0;
    if constexpr (STORES) {
      const unsigned base_sh =
          static_cast<unsigned>(__cvta_generic_to_shared(smem));
      if (ty == 0 && above) {
        row_to = cluster_addr(base_sh, rank - 1) + ((WR - 1) * WC + tx + 1) * 4;
      } else if (ty == TY - 1 && below) {
        row_to = cluster_addr(base_sh, rank + 1) + (tx + 1) * 4;
      }
      if (lane == 0 && sr == 0 && above) {
        flag_to = cluster_addr(base_sh, rank - 1)
                  + (S::O_FLAGS + (SR + 1) * SC + sc) * 4;
      } else if (lane == 0 && sr == SR - 1 && below) {
        flag_to = cluster_addr(base_sh, rank + 1) + (S::O_FLAGS + sc) * 4;
      }
    }
    while (it < inner_max && changed) {
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        const int local = band_sweep<B, STORES>(
            w, bse, cur, nxt, f_rd, poll, r0, row_to,
            (nxt == smem) ? 0u : WIN * 4u, 0u);
        if (lane == 0) {
          f_wr[own] = local;
          if constexpr (STORES) {  // an edge strip's flag into the ghost row
            if (flag_to) {
              st_cluster(flag_to + ((f_wr == flags) ? 0u : NF * 4u), local);
            }
          }
        }
        // one barrier per sweep: the next sweep writes what this one read
        if (s == 3) {
          changed = __syncthreads_or(local);
          if constexpr (C > 1) {  // the whole block's vote
            if (tid < C) *in_rank(&votes.sweep[0][cluster_rank()], tid) =
                changed;
            cluster_sync();
            changed = 0;
#pragma unroll
            for (int k = 0; k < C; ++k) changed |= votes.sweep[0][k];
          }
        } else if constexpr (C > 1 && VISIT != SWEEP_CTA_BARRIER) {
          cluster_sync();
        } else {
          __syncthreads();
        }
        swap_buffers(cur, nxt, f_rd, f_wr);
      }
      it += 4;
    }
  } else if constexpr (VISIT == ASYNC) {
    // ASYNC (the file's header).  The windows and flag sets by parity: the
    // sweep t reads window t & 1 and writes the other (an index, not four
    // pointers kept through the sweeps).  to: where this thread's row goes
    // in the band its row borders (the band above for the first thread row,
    // below for the last; 0: none), as a shared::cluster address; that
    // band's flags and mbarriers are at fixed offsets from it.
    const unsigned base_sh =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const unsigned bar_sh =
        static_cast<unsigned>(__cvta_generic_to_shared(votes.bar));
    const unsigned vbar_sh =
        static_cast<unsigned>(__cvta_generic_to_shared(votes.vbar));
    const unsigned row_off = ((ty == 0 ? WR - 1 : 0) * WC + tx + 1) * 4;
    unsigned to = 0;
    if ((ty == 0 && above) || (ty == TY - 1 && below)) {
      to = cluster_addr(base_sh, ty == 0 ? rank - 1 : rank + 1) + row_off;
    }
    while (it < inner_max && changed) {
      const int g = it / 4;  // this group
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        const int t = it + s, nb = (t + 1) & 1;  // nb: the window written
        // arm the mbarrier of window nb for this sweep's rows and flags
        // (its last phase completed before this thread's wait of sweep
        // t - 2), and at a group's first sweep that of the group's votes
        // (its last phase, group g - 8's, before the wait at group g - 7)
        if (tid == 0) {
          mbar_expect(bar_sh + nb * 8,
                      ((int)above + (int)below) * (B + SC) * 4);
          if (s == 0) mbar_expect(vbar_sh + (g & 7) * 8, C * 4);
        }
        // the neighbour's mbarrier of window nb, from `to`
        const unsigned nbar = to - row_off + (bar_sh - base_sh) + nb * 8;
        const int local = band_sweep<B, 2>(
            w, bse, smem + (nb ^ 1) * WIN, smem + nb * WIN,
            flags + (nb ^ 1) * NF, poll, r0, to, nb * WIN * 4u, nbar);
        if (lane == 0) {
          flags[nb * NF + own] = local;
          if (to) {  // an edge strip's flag into the ghost flag row
            st_async(to - row_off + (S::O_FLAGS + nb * NF
                                     + (ty == 0 ? SR + 1 : 0) * SC + sc) * 4,
                     local, nbar);
          }
        }
        // The CTA's sweep done; at the group's last sweep its vote sent to
        // every CTA.  Then a thread that reads a ghost row next sweep waits
        // for the neighbour's row and flags of this sweep: having them also
        // says that the neighbour has read what it reads of this CTA's
        // rows, so no barrier over the cluster is needed before this CTA
        // writes them again (each sweep writes the other window).  Bands
        // run apart by up to C - 1 sweeps.
        if (s == 3) {
          const int mine = __syncthreads_or(local);
          if (tid < C) {
            const unsigned slot = static_cast<unsigned>(
                __cvta_generic_to_shared(&votes.sweep[g & 7][rank]));
            st_async(cluster_addr(slot, tid), mine,
                     cluster_addr(vbar_sh + (g & 7) * 8, tid));
          }
        } else {
          __syncthreads();
        }
        if (tid == 0 || to) mbar_wait(bar_sh + nb * 8, (t >> 1) & 1);
        if (s == 3 && g > 0) {
          // the vote of the group before, read one group late: a block
          // still at that group's end is at its fixed point, so the group
          // swept since changed nothing
          const int v = (g - 1) & 7;
          mbar_wait(vbar_sh + v * 8, ((g - 1) >> 3) & 1);
          changed = 0;
#pragma unroll
          for (int k = 0; k < C; ++k) changed |= votes.sweep[v][k];
        }
      }
      it += 4;
    }
    // the window the last sweep wrote; the last group's votes, still
    // landing, drained before the mbarriers are invalidated
    cur = smem + (it & 1) * WIN;
    if (tid == 0 && it > 0) {
      const int g = it / 4 - 1;
      mbar_wait(vbar_sh + (g & 7) * 8, (g >> 3) & 1);
    }
  }

  int moved = 0;
  {
    const int ti = votes.origin[0] + threadIdx.y * R + RING;
    const int tj = votes.origin[1] + threadIdx.x + RING;
    const int wt = (threadIdx.y * R + 1) * WC + threadIdx.x + 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t g = (size_t)(ti + r) * (m + 2 * RING) + tj;
      const float v = cur[wt + r * WC];
      moved |= (v != x[g]);
      x_out[g] = v;
    }
  }
  moved = __syncthreads_or(moved);
  const bool first = threadIdx.x == 0 && threadIdx.y == 0;
  if constexpr (C > 1) {
    const int me = cluster_rank();
    if (first) *in_rank(&votes.moved[me], 0) = moved;
    cluster_sync();  // after every band's write-back
    if constexpr (VISIT == ASYNC) {
      // every byte counted on this CTA's mbarriers has landed, and no
      // thread waits on them any more
      if (first) {
        for (int k = 0; k < 8; ++k) {
          if (k < 2) {
            mbar_inval(static_cast<unsigned>(__cvta_generic_to_shared(
                votes.bar + k)));
          }
          mbar_inval(static_cast<unsigned>(__cvta_generic_to_shared(
              votes.vbar + k)));
        }
      }
    }
    if (me == 0 && first) {
      int any = 0;
#pragma unroll
      for (int k = 0; k < C; ++k) any |= votes.moved[k];
      chg[votes.origin[2]] = any;
    }
  } else if (first) {
    chg[votes.origin[2]] = moved;
  }
}

// The frontier of K1's rounds: relax only if some block of the 3x3
// neighbourhood changed last round.
__device__ __forceinline__ bool frontier_dirty(const int* __restrict__ prev,
                                               int nb_i, int nb_j, int bi,
                                               int bj) {
  int dirty = 0;
  for (int a = -1; a <= 1; ++a) {
    for (int c = -1; c <= 1; ++c) {
      const int qi = bi + a, qj = bj + c;
      if (qi >= 0 && qi < nb_i && qj >= 0 && qj < nb_j) {
        dirty |= prev[qi * nb_j + qj];
      }
    }
  }
  return dirty != 0;
}

// K1 in the TPU's Gauss-Seidel order, a whole round in one persistent
// launch.  Each unit (a CTA, or at B = 128 and 256 a cluster, whose rank 0
// draws for it) draws tickets from the 64-bit counter (ticket = counter -
// start, until it draws one past `rows`); ticket t is row t of the
// dependency table, rows sorted by level, a topological order.  A unit
// that holds a ticket waits only for lower tickets, all held by units that
// are running, so the round cannot deadlock, whatever the grid and
// whatever else shares the card.  A dirty block stages its weights and
// base, waits until each predecessor has published this round's epoch in
// `done`, relaxes in place and publishes its own epoch (release after its
// write-back and a barrier); a clean block publishes at once.  Skips are
// decided from prev alone, as the TPU's are, so the canvas and the flags
// are the sequential grid's bit for bit.
template <int B, int RING>
__global__ void __launch_bounds__(Shape<B>::THREADS, 1)
uca_gs_dataflow_kernel(float* x,
                       const uint8_t* __restrict__ K,
                       const float* __restrict__ W1,
                       const float* __restrict__ base,
                       const int* __restrict__ prev,
                       int* __restrict__ chg,
                       const int* __restrict__ table,
                       unsigned long long* counter, int* done,
                       int n, int m, int inner_max, int rows, int epoch,
                       unsigned long long start) {
  constexpr int C = Shape<B>::C;
  __shared__ Votes<C> votes;
  const int nb_i = n / B, nb_j = m / B;
  const int tid = threadIdx.y * B + threadIdx.x;
  int rank = 0;
  if constexpr (C > 1) rank = cluster_rank();
  for (int par = 0;; par ^= 1) {
    // rank 0 draws; the ticket slot alternates, so a slot is written again
    // only after every CTA has passed the next draw's barrier
    if (rank == 0 && tid < 32) {
      unsigned long long t = 0;
      if (tid == 0) t = atomicAdd(counter, 1ULL) - start;
      t = __shfl_sync(0xffffffffu, t, 0);
      const int ticket = t < (unsigned long long)rows ? (int)t : rows;
      if constexpr (C > 1) {
        if (tid < C) *in_rank(&votes.ticket[par], tid) = ticket;
      } else if (tid == 0) {
        votes.ticket[par] = ticket;
      }
    }
    if constexpr (C > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    const int t = votes.ticket[par];
    if (t >= rows) return;
    const int* row = table + (size_t)t * ROW;
    const int b = row[0];
    const int bi = b / nb_j, bj = b - bi * nb_j;
    if (frontier_dirty(prev, nb_i, nb_j, bi, bj)) {
      relax_block<B, RING>(x, CompactWeights<RING>{K, W1}, base, x, chg, n,
                           m, inner_max, bi, bj, votes,
                           WaitPreds{row + 1, done, epoch});
    } else if (rank == 0 && tid == 0) {
      chg[b] = 0;
    }
    // relax_block ended in a barrier (of the cluster) after every band's
    // write-back; the fence is cumulative over what that barrier ordered.
    // The block is read again from the ticket, not kept through the visit.
    if (rank == 0 && tid == 0) {
      __threadfence();
      st_release(done + table[(size_t)votes.ticket[par] * ROW], epoch);
    }
  }
}

// K2: one round over the dense weight planes, every block visited; the
// (C * m/B, n/B) grid runs a cluster of C CTAs a block.
template <int B>
__global__ void __launch_bounds__(Shape<B>::THREADS)
uca_block_round_kernel(const float* __restrict__ x,
                       const float* __restrict__ W,
                       const float* __restrict__ base,
                       float* __restrict__ x_out,
                       int* __restrict__ chg,
                       int n, int m, int inner_max) {
  __shared__ Votes<Shape<B>::C> votes;
  relax_block<B, 0>(x, DenseWeights{W}, base, x_out, chg, n, m, inner_max,
                    blockIdx.y, blockIdx.x / Shape<B>::C, votes);
}

// The sweep probe: K2's round with the cluster visit VISIT (B = 128 and
// 256), to time one sweep of each variant; a probe variant's canvas is
// wrong by design.  No solver launches it.
template <int B, int VISIT>
__global__ void __launch_bounds__(Shape<B>::THREADS)
uca_probe_kernel(const float* __restrict__ x,
                 const float* __restrict__ W,
                 const float* __restrict__ base,
                 float* __restrict__ x_out,
                 int* __restrict__ chg,
                 int n, int m, int inner_max) {
  static_assert(Shape<B>::C > 1, "a cluster visit");
  __shared__ Votes<Shape<B>::C> votes;
  relax_block<B, 0, DenseWeights, NoWait, VISIT>(
      x, DenseWeights{W}, base, x_out, chg, n, m, inner_max, blockIdx.y,
      blockIdx.x / Shape<B>::C, votes);
}

// The launch configuration of a kernel at block size B: (B, TY) CTAs and
// their dynamic shared memory, in clusters of C CTAs along x when C > 1.
// The kernels allow cluster sizes above the portable 8 (B = 256).
template <int B, class Kernel>
cudaError_t configure(Kernel kernel, dim3 grid, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  using S = Shape<B>;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(B, S::TY);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  if constexpr (S::C == 1) return cudaSuccess;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S::C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if constexpr (S::C > 8) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return cudaSuccess;
}

template <int B, class... KArgs, class... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<B>(kernel, grid, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the card holds at once of a kernel at block size B: CTAs at C = 1
// (SMs x CTAs per SM), clusters at C > 1 (0 if no cluster fits); a
// negative cudaError_t on failure.
template <int B, class Kernel>
int resident(Kernel kernel) {
  using S = Shape<B>;
  cudaError_t err;
  if constexpr (S::C == 1) {
    int dev = 0, sms = 0, per = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                          S::THREADS, S::SMEM);
    }
    return err == cudaSuccess ? sms * per : -(int)err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<B>(kernel, dim3(S::C), nullptr, cfg, attr);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace

// One K1 round in the TPU's Gauss-Seidel order, in place on x, as one
// persistent launch of `units` units (uca_gs_dataflow_kernel): CTAs at
// B = 8 to 64, clusters of uca_block_cluster_size(B) CTAs at 128 and 256.
// All arrays are row-major and contiguous on the current device.  ring = 0:
// x, W1, base (n, m) float32 and K (n, m) uint8; ring = 1: x, K and W1
// (n + 2, m + 2) with a 1-px ring around the n x m region (read, never
// written), base (n, m).  prev, chg (n/B, m/B) int32; n and m multiples of
// B.  table (on the device) holds the round's `rows` dependency rows
// (block, MAX_PREDS predecessors) in a topological order.
// state (on the device): a 64-bit ticket counter, then one int32 "done"
// epoch per block of the grid; the caller keeps it for every round on
// `stream`, passes a new `epoch` each round and the counter's value at the
// round's start in `start` (each round adds rows + units to it).  Launches
// on `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int uca_gs_round_dataflow_f32(
    void* x, const void* K, const void* W1, const void* base,
    const void* prev, void* chg, const void* table, void* state, int n,
    int m, int B, int inner_max, int ring, int rows, int units, int epoch,
    unsigned long long start, void* stream) {
  auto* xf = static_cast<float*>(x);
  const auto* kf = static_cast<const uint8_t*>(K);
  const auto* wf = static_cast<const float*>(W1);
  const auto* bf = static_cast<const float*>(base);
  const auto* pf = static_cast<const int*>(prev);
  auto* cf = static_cast<int*>(chg);
  const auto* tf = static_cast<const int*>(table);
  auto* counter = static_cast<unsigned long long*>(state);
  auto* done = static_cast<int*>(state) + 2;
  auto st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;  // an empty round visits nothing
#define DATAFLOW(BB, RR)                                                    \
  return launch<BB>(uca_gs_dataflow_kernel<BB, RR>,                         \
                    dim3(units * Shape<BB>::C), st, xf, kf, wf, bf, pf, cf, \
                    tf, counter, done, n, m, inner_max, rows, epoch, start)
  if (B == 8 && !ring) DATAFLOW(8, 0);
  if (B == 8 && ring) DATAFLOW(8, 1);
  if (B == 16 && !ring) DATAFLOW(16, 0);
  if (B == 16 && ring) DATAFLOW(16, 1);
  if (B == 32 && !ring) DATAFLOW(32, 0);
  if (B == 32 && ring) DATAFLOW(32, 1);
  if (B == 64 && !ring) DATAFLOW(64, 0);
  if (B == 64 && ring) DATAFLOW(64, 1);
  if (B == 128 && !ring) DATAFLOW(128, 0);
  if (B == 128 && ring) DATAFLOW(128, 1);
  if (B == 256 && !ring) DATAFLOW(256, 0);
  if (B == 256 && ring) DATAFLOW(256, 1);
#undef DATAFLOW
  return cudaErrorInvalidValue;
}

// The units of uca_gs_dataflow_kernel<B, ring> (kernel = 0) or of
// uca_block_round_kernel<B> (kernel = 1) that the current device holds at
// once: CTAs at B = 8 to 64, clusters at 128 and 256 (0: none fits); a
// negative cudaError_t on failure.
extern "C" int uca_resident_units(int kernel, int B, int ring) {
  if (kernel == 1) {
    if (B == 8) return resident<8>(uca_block_round_kernel<8>);
    if (B == 16) return resident<16>(uca_block_round_kernel<16>);
    if (B == 32) return resident<32>(uca_block_round_kernel<32>);
    if (B == 64) return resident<64>(uca_block_round_kernel<64>);
    if (B == 128) return resident<128>(uca_block_round_kernel<128>);
    if (B == 256) return resident<256>(uca_block_round_kernel<256>);
    return -(int)cudaErrorInvalidValue;
  }
#define RESIDENT(BB)                                                    \
  return ring ? resident<BB>(uca_gs_dataflow_kernel<BB, 1>)             \
              : resident<BB>(uca_gs_dataflow_kernel<BB, 0>)
  if (B == 8) RESIDENT(8);
  if (B == 16) RESIDENT(16);
  if (B == 32) RESIDENT(32);
  if (B == 64) RESIDENT(64);
  if (B == 128) RESIDENT(128);
  if (B == 256) RESIDENT(256);
#undef RESIDENT
  return -(int)cudaErrorInvalidValue;
}

// One K2 round (dense weight planes, every block).  x, base, x_out (n, m)
// and W (8, n, m) float32, chg (n/B, m/B) int32, all row-major and
// contiguous on the current device; n, m multiples of B; B is 8, 16, 32,
// 64, 128 or 256 (a cluster of uca_block_cluster_size(B) CTAs a block).  Launches
// on `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int uca_block_round_f32(const void* x, const void* W,
                                   const void* base, void* x_out, void* chg,
                                   int n, int m, int B, int inner_max,
                                   void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(W);
  const auto* bf = static_cast<const float*>(base);
  auto* of = static_cast<float*>(x_out);
  auto* cf = static_cast<int*>(chg);
  auto st = static_cast<cudaStream_t>(stream);
#define K2(BB)                                                               \
  return launch<BB>(uca_block_round_kernel<BB>,                              \
                    dim3(m / BB * Shape<BB>::C, n / BB), st, xf, wf, bf, of, \
                    cf, n, m, inner_max)
  switch (B) {
    case 8: K2(8);
    case 16: K2(16);
    case 32: K2(32);
    case 64: K2(64);
    case 128: K2(128);
    case 256: K2(256);
    default: return cudaErrorInvalidValue;
  }
#undef K2
}

// Bytes of dynamic shared memory a CTA of either kernel uses at block size
// B (ptxas does not report dynamic shared memory); -1 for a B the kernels
// are not built for.
extern "C" int uca_block_smem_bytes(int B) {
  switch (B) {
    case 8: return (int)Shape<8>::SMEM;
    case 16: return (int)Shape<16>::SMEM;
    case 32: return (int)Shape<32>::SMEM;
    case 64: return (int)Shape<64>::SMEM;
    case 128: return (int)Shape<128>::SMEM;
    case 256: return (int)Shape<256>::SMEM;
    default: return -1;
  }
}

// The CTAs of the cluster that relaxes one block at block size B (1: one
// CTA); -1 for a B the kernels are not built for.
extern "C" int uca_block_cluster_size(int B) {
  switch (B) {
    case 8: return Shape<8>::C;
    case 16: return Shape<16>::C;
    case 32: return Shape<32>::C;
    case 64: return Shape<64>::C;
    case 128: return Shape<128>::C;
    case 256: return Shape<256>::C;
    default: return -1;
  }
}

// One round of the sweep probe (uca_probe_kernel<B, visit>): K2's round,
// arguments as uca_block_round_f32, B 128 or 256, visit a Visit (0: the
// kernels' own).  For timing only: the probe visits' results are wrong by
// design.  Returns the cudaError_t of the launch (0 on success).
extern "C" int uca_probe_round_f32(const void* x, const void* W,
                                   const void* base, void* x_out, void* chg,
                                   int n, int m, int B, int inner_max,
                                   int visit, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(W);
  const auto* bf = static_cast<const float*>(base);
  auto* of = static_cast<float*>(x_out);
  auto* cf = static_cast<int*>(chg);
  auto st = static_cast<cudaStream_t>(stream);
#define PROBE(BB, VV)                                                        \
  if (B == BB && visit == VV)                                                \
  return launch<BB>(uca_probe_kernel<BB, VV>,                                \
                    dim3(m / BB * Shape<BB>::C, n / BB), st, xf, wf, bf, of, \
                    cf, n, m, inner_max)
  PROBE(128, ASYNC); PROBE(128, SWEEP); PROBE(128, SWEEP_NO_STORES);
  PROBE(128, SWEEP_CTA_BARRIER);
  PROBE(256, ASYNC); PROBE(256, SWEEP); PROBE(256, SWEEP_NO_STORES);
  PROBE(256, SWEEP_CTA_BARRIER);
#undef PROBE
  static_assert(N_VISITS == 4, "every visit above");
  return cudaErrorInvalidValue;
}
