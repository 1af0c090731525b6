// The flat-region label flood for Hopper (sm_90a): 8-connected components
// of a mask, each pixel labelled with the smallest flat index (i * m + j)
// of its component, n * m off the mask.
//
// Replaces no TPU kernel: in the JAX package the flood is jnp code, not a
// pallas_call (pydem_tpu/core/slope_direction.py:206, label_flood).  Its
// eager PyTorch port (pydem_tpu_torch/core/slope_direction.py::
// _label_flood_eager) repeats a min-sweep, a host read of "changed?", a
// scatter-min and two compress gathers until nothing changes: 8-9 rounds
// over a coastal tile's sea, each moving ~1 GB.  A component's label is
// defined uniquely, so a union-find that always links the larger root under
// the smaller gives the same integers whatever order its atomics run in.
// This file does that in three launches and no host read, after the
// block-based union-find of Allegretti, Bolelli and Grana (IEEE TPDS 2019)
// and Playne and Hawick (IEEE TPDS 29(6), 2018):
//  * flood_local_kernel, one CTA a 32 x 32 tile, a warp a tile row at a
//    time: a ballot of the row's mask gives each pixel its run's first
//    column, the run's root; then each run is joined to the runs of the
//    row above it inside the tile (shared memory, atomicMin, larger root
//    under smaller), skipping a union another pixel of the tile already
//    makes.  Each pixel writes the global flat index of its tile root:
//    row-major order inside a tile is global order, so that is the
//    smallest index of its piece of the component.  Off the mask: n * m.
//  * flood_merge_kernel, one CTA a tile: each mask pixel of the tile's top
//    row unions with its mask neighbours in the row above, each of its left
//    column with those in the column to the left, corners included, in
//    global memory by the same find and atomicMin loop.  The root of every
//    component ends as its smallest index, whatever the order.
//  * flood_compress_kernel, a thread a pixel: each mask pixel's label
//    becomes its root, and the path to it is compressed for the others.
// Bound: reading the mask once (1 B) and writing the labels once (4 B) is
// 5 B a pixel, 0.054 ms at 6000^2 over 3.35 TB/s.  The local pass reads the
// mask and writes the labels once, coalesced; the merge touches only the
// tiles' top rows and left columns (1/16 of the pixels) and the few tile
// roots; the compress reads and writes the labels once more and follows
// root chains that mostly sit in L2.  No kernel allocates; the caller gives
// the label plane.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;    // tile columns: one warp a row
constexpr int TH = 32;    // tile rows
constexpr int ROWS = 8;   // warps of a local-pass CTA; each TH / ROWS rows
constexpr int MERGE_THREADS = TW + TH;  // the top row, then the left column
constexpr int COMPRESS_THREADS = 256;
constexpr int COMPRESS_BLOCKS = 132 * 2048 / COMPRESS_THREADS;  // a full card

// The root of x: the first entry on its chain that points at itself.  The
// reads are volatile: other threads lower the entries while this one walks.
__device__ __forceinline__ int find(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Joins the sets of a and b: the larger root goes under the smaller by
// atomicMin; if another thread moved that root first, retry from what the
// atomic found.  Entries only decrease, so every set's root is its
// smallest member once all unions are done.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find(parent, a);
    b = find(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__device__ __forceinline__ bool bit(unsigned bits, int k) {
  return k >= 0 && k < 32 && ((bits >> k) & 1u);
}

__global__ void __launch_bounds__(TW * ROWS)
flood_local_kernel(const unsigned char* __restrict__ mask, int* __restrict__ lbl,
                   int n, int m, int tiles_x) {
  __shared__ int parent[TH * TW];
  __shared__ unsigned rows[TH];  // each tile row's mask, a bit a column
  const int lane = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_x) * TH;
  const int j0 = (blockIdx.x % tiles_x) * TW;
  const int j = j0 + lane;
  // each pixel points at the first column of its run in the tile row
  for (int r = threadIdx.y; r < TH; r += ROWS) {
    const int i = i0 + r;
    const bool in = i < n && j < m && mask[i * m + j];
    const unsigned b = __ballot_sync(0xffffffffu, in);
    const unsigned starts = b & ~(b << 1);
    const unsigned upto = starts & (0xffffffffu >> (31 - lane));
    parent[r * TW + lane] = in ? r * TW + 31 - __clz(upto) : -1;
    if (lane == 0) rows[r] = b;
  }
  __syncthreads();
  // each run joins the runs above it: p unions with its up neighbour b
  // unless its left neighbour (same run) already reaches b or a; with a
  // only where b is off (else a and b share a run); with c likewise
  for (int r = threadIdx.y; r < TH; r += ROWS) {
    const unsigned cur = rows[r];
    if (r == 0 || !bit(cur, lane)) continue;
    const unsigned up = rows[r - 1];
    const bool a = bit(up, lane - 1), b = bit(up, lane),
               c = bit(up, lane + 1), left = bit(cur, lane - 1);
    const int p = r * TW + lane;
    if (b && !left) unite(parent, p, p - TW);
    if (a && !b && !left) unite(parent, p, p - TW - 1);
    if (c && !b) unite(parent, p, p - TW + 1);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TH; r += ROWS) {
    const int i = i0 + r;
    if (i >= n || j >= m) continue;
    int out = n * m;
    if (bit(rows[r], lane)) {
      const int root = find(parent, r * TW + lane);
      out = (i0 + root / TW) * m + j0 + root % TW;
    }
    lbl[i * m + j] = out;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
flood_merge_kernel(const unsigned char* __restrict__ mask, int* lbl, int n,
                   int m, int tiles_x) {
  const int i0 = (blockIdx.x / tiles_x) * TH;
  const int j0 = (blockIdx.x % tiles_x) * TW;
  const int t = threadIdx.x;
  auto on = [&](int i, int j) {
    return i >= 0 && j >= 0 && i < n && j < m && mask[i * m + j];
  };
  if (t < TW) {
    // the top row against the row above: a, b, c above-left, above,
    // above-right; a and c join b in their own tiles' passes where b is on
    // (a run of one tile, or a left-column union of the next)
    const int i = i0, j = j0 + t;
    if (i == 0 || !on(i, j)) return;
    const int p = i * m + j;
    if (on(i - 1, j)) {
      unite(lbl, p, p - m);
    } else {
      if (on(i - 1, j - 1)) unite(lbl, p, p - m - 1);
      if (on(i - 1, j + 1)) unite(lbl, p, p - m + 1);
    }
  } else {
    // the left column against the column to the left: left, above-left,
    // below-left; the last two join the left one vertically (one tile's
    // run, or a top-row union of the next) where it is on
    const int i = i0 + t - TW, j = j0;
    if (j == 0 || !on(i, j)) return;
    const int p = i * m + j;
    if (on(i, j - 1)) {
      unite(lbl, p, p - 1);
    } else {
      if (on(i - 1, j - 1)) unite(lbl, p, p - m - 1);
      if (on(i + 1, j - 1)) unite(lbl, p, p + m - 1);
    }
  }
}

__global__ void __launch_bounds__(COMPRESS_THREADS)
flood_compress_kernel(int* lbl, int N) {
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < N; p += stride) {
    const int v = lbl[p];
    if (v == N || v == p) continue;
    const int root = find(lbl, v);
    if (root == v) continue;
    lbl[p] = root;
    // every entry on the chain gets the final root (the same value from
    // every thread): later walks through it are short
    for (int x = v; x != root;) {
      const int next = static_cast<const volatile int*>(lbl)[x];
      lbl[x] = root;
      x = next;
    }
  }
}

}  // namespace

// The label plane of the 8-connected components of `mask` (n, m), uint8
// 0/1, contiguous on the current device: lbl (n, m) int32, contiguous, gets
// each mask pixel's smallest component index and n * m elsewhere.
// n, m >= 0 with n * m < 2^31.  Launches three kernels on `stream` (none on
// an empty canvas) and does not synchronise.  Returns the number of kernels
// launched, or minus the cudaError_t of a failed launch.
extern "C" int flood_labels(const void* mask, void* lbl, int n, int m,
                            void* stream) {
  if (n < 0 || m < 0 || static_cast<long long>(n) * m >= (1ll << 31))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* lb = static_cast<int*>(lbl);
  const int tiles_x = (m + TW - 1) / TW;
  const int tiles = tiles_x * ((n + TH - 1) / TH);
  flood_local_kernel<<<tiles, dim3(TW, ROWS), 0, s>>>(mk, lb, n, m, tiles_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  flood_merge_kernel<<<tiles, MERGE_THREADS, 0, s>>>(mk, lb, n, m, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int N = n * m;
  const int want = (N + COMPRESS_THREADS - 1) / COMPRESS_THREADS;
  const int blocks = want < COMPRESS_BLOCKS ? want : COMPRESS_BLOCKS;
  flood_compress_kernel<<<blocks, COMPRESS_THREADS, 0, s>>>(lb, N);
  err = cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : 3;
}
