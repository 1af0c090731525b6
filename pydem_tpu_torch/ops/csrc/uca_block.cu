// UCA block relaxation rounds for Hopper (sm_90a), float32.
//
// Replaces both Pallas kernels of pydem_tpu/ops/uca_block.py.  Each computes
// one round of
//     area = base + sum_k shift_k(W_k * area)
// over B x B blocks: Jacobi sweeps inside a block with its 1-px halo frozen,
// 4 sweeps per convergence test, capped at inner_max, then write-back and
// the block's changed flag.
//  * K1, uca_gs_round_kernel, replaces _gs_kernel: the compact receiver
//    encoding (packed index plane K, slot-1 weight W1, slot-2 weight
//    1 - W1) and a frontier skip when no block of the 3x3 neighbourhood
//    changed last round (skipped blocks copy their values into x_out).
//  * K2, uca_block_round_kernel, replaces _block_kernel: the 8 dense weight
//    planes, read straight from device memory, any nonnegative weights and
//    any number of them per pixel, every block visited.
// Both end in relax_block, templated on where the weights come from.
//
// Differences from the TPU kernels, by design:
//  * CUDA blocks run in no order, so K1 has no Gauss-Seidel grid order and
//    no corner visit orders: every block reads the round-start canvas `x`
//    and writes a second buffer `x_out` (block-Jacobi, which is what K2
//    does on the TPU too).  A round therefore has one deterministic result,
//    which the plain PyTorch versions (ops/uca_block.py::gs_round_plain,
//    block_round_plain) reproduce bit for bit.  K1 reaches the same fixed
//    point as the TPU's; its round counts differ.
//  * The halo is 1 px in shared memory, not the TPU's (8, 128)-aligned pads
//    or K2's pre-exploded (B+16, B+256) tiles.  Out of the canvas, x and
//    the weights read 0.
//
// What bounds it on the card: per visited block a round reads the halo
// window of x, the weights for the block's sources (K1: K at 1 B and W1;
// K2: 8 planes at 4 B each) and base, and writes the block: about 17 bytes
// of HBM traffic per visited pixel per round for K1 (71 MB for a full round
// at 2048^2), about 44 for K2 (185 MB).  Inside a visit, each of up to
// inner_max = 2B+4 sweeps reads 8 weights and 8 neighbours per pixel from
// shared memory, so a visit that relaxes for many sweeps is bound by
// shared-memory bandwidth and latency, not HBM.  The design loads the
// weights once per visit into 8 incoming-weight planes in shared memory
// (no decode or reload per sweep), double-buffers the x window so each
// sweep needs one barrier, tests convergence with __syncthreads_or every
// 4th sweep, and (K1) skips converged neighbourhoods entirely.
//
// Numerics: the sum is base + w_0 x_0 + ... + w_7 x_7 in NEIGHBOR_OFFSETS
// order with separate multiply and add roundings (__fmul_rn/__fadd_rn, and
// the file is built with -fmad=false), as the plain versions compute it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// NEIGHBOR_OFFSETS (core/stencil.py): E, NE, N, NW, W, SW, S, SE.
__device__ __forceinline__ int off_i(int k) {
  return (k >= 1 && k <= 3) ? -1 : ((k >= 5) ? 1 : 0);
}
__device__ __forceinline__ int off_j(int k) {
  return (k <= 1 || k == 7) ? 1 : ((k >= 3 && k <= 5) ? -1 : 0);
}

template <int B>
struct Shape {
  static constexpr int TY = (B < 512 / B) ? B : 512 / B;  // thread rows
  static constexpr int R = B / TY;                        // rows per thread
  static constexpr int WN = B + 2;                        // window side
  static constexpr int THREADS = B * TY;
  static constexpr size_t SMEM = (2 * WN * WN + 8 * B * B) * sizeof(float);
};

// Incoming weights from the compact receivers (K1): ws[k] at p is the
// weight that the source q = p - o_k sends along k, decoded from K and W1
// (slot 2 carries 1 - W1, as expand_compact builds it; k2 == 15: none).
struct CompactWeights {
  const uint8_t* K;
  const float* W1;
  __device__ __forceinline__ float operator()(int k, size_t g) const {
    const int kk = K[g];
    const int k1 = kk >> 4, k2 = kk & 15;
    const float w1 = W1[g];
    return (k1 == k) ? w1 : ((k2 == k) ? __fsub_rn(1.f, w1) : 0.f);
  }
};

// Incoming weights from the 8 dense planes (K2): any nonnegative weights,
// any number of them per pixel.
struct DenseWeights {
  const float* W;
  size_t plane;  // n * m
  __device__ __forceinline__ float operator()(int k, size_t g) const {
    return W[k * plane + g];
  }
};

// Relax block (bi, bj) to its local fixed point with its 1-px halo frozen,
// write it to x_out and its changed flag to chg.  Both kernels end here.
template <int B, class Weights>
__device__ __forceinline__ void relax_block(
    const float* __restrict__ x, const Weights& weight,
    const float* __restrict__ base, float* __restrict__ x_out,
    int* __restrict__ chg, int n, int m, int inner_max, int bi, int bj) {
  using S = Shape<B>;
  constexpr int TY = S::TY, R = S::R, WN = S::WN;
  extern __shared__ float smem[];
  float* xs0 = smem;                 // x window, buffer 0
  float* xs1 = smem + WN * WN;       // x window, buffer 1
  float* ws = smem + 2 * WN * WN;    // incoming weights [8][B][B]

  const int nb_j = m / B;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * B + tx;
  const int i0 = bi * B, j0 = bj * B;

  // Halo window of x into both buffers (the halo stays frozen).
  for (int t = tid; t < WN * WN; t += S::THREADS) {
    const int gi = i0 - 1 + t / WN, gj = j0 - 1 + t % WN;
    float v = 0.f;
    if (gi >= 0 && gi < n && gj >= 0 && gj < m) v = x[(size_t)gi * m + gj];
    xs0[t] = v;
    xs1[t] = v;
  }
  // The incoming weights, once per visit: ws[k][i][j] is the weight that
  // the source q = p - o_k sends to p = (i, j) along offset k; 0 for a
  // source outside the canvas.
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + r * TY;
      const int gi = i0 + i - off_i(k), gj = j0 + tx - off_j(k);
      float w = 0.f;
      if (gi >= 0 && gi < n && gj >= 0 && gj < m) {
        w = weight(k, (size_t)gi * m + gj);
      }
      ws[(k * B + i) * B + tx] = w;
    }
  }
  float bse[R], x0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t g = (size_t)(i0 + ty + r * TY) * m + (j0 + tx);
    bse[r] = base[g];
    x0[r] = x[g];
  }
  __syncthreads();

  float* cur = xs0;
  float* nxt = xs1;
  int it = 0;
  int changed = 1;
  while (it < inner_max && changed) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      int local = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty + r * TY;
        float acc = bse[r];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xv = cur[(i + 1 - off_i(k)) * WN + (tx + 1 - off_j(k))];
          acc = __fadd_rn(acc, __fmul_rn(ws[(k * B + i) * B + tx], xv));
        }
        const int c = (i + 1) * WN + (tx + 1);
        local |= (acc != cur[c]);
        nxt[c] = acc;
      }
      // one barrier per sweep: the next sweep writes the buffer this one read
      if (s == 3) {
        changed = __syncthreads_or(local);
      } else {
        __syncthreads();
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    it += 4;
  }

  int moved = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + r * TY;
    const float v = cur[(i + 1) * WN + (tx + 1)];
    moved |= (v != x0[r]);
    x_out[(size_t)(i0 + i) * m + (j0 + tx)] = v;
  }
  moved = __syncthreads_or(moved);
  if (tid == 0) chg[bi * nb_j + bj] = moved;
}

// K1: one round over the compact receivers with the frontier skip.
template <int B>
__global__ void __launch_bounds__(Shape<B>::THREADS)
uca_gs_round_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ K,
                    const float* __restrict__ W1,
                    const float* __restrict__ base,
                    const int* __restrict__ prev,
                    float* __restrict__ x_out,
                    int* __restrict__ chg,
                    int n, int m, int inner_max) {
  using S = Shape<B>;
  const int nb_i = n / B, nb_j = m / B;
  const int bi = blockIdx.y, bj = blockIdx.x;

  // Frontier: relax only if some block of the 3x3 neighbourhood changed.
  int dirty = 0;
  for (int a = -1; a <= 1; ++a) {
    for (int b = -1; b <= 1; ++b) {
      const int qi = bi + a, qj = bj + b;
      if (qi >= 0 && qi < nb_i && qj >= 0 && qj < nb_j) {
        dirty |= prev[qi * nb_j + qj];
      }
    }
  }
  if (!dirty) {
#pragma unroll
    for (int r = 0; r < S::R; ++r) {
      const size_t g = (size_t)(bi * B + threadIdx.y + r * S::TY) * m
                       + (bj * B + threadIdx.x);
      x_out[g] = x[g];
    }
    if (threadIdx.x == 0 && threadIdx.y == 0) chg[bi * nb_j + bj] = 0;
    return;
  }
  relax_block<B>(x, CompactWeights{K, W1}, base, x_out, chg, n, m, inner_max,
                 bi, bj);
}

// K2: one round over the dense weight planes, every block visited.
template <int B>
__global__ void __launch_bounds__(Shape<B>::THREADS)
uca_block_round_kernel(const float* __restrict__ x,
                       const float* __restrict__ W,
                       const float* __restrict__ base,
                       float* __restrict__ x_out,
                       int* __restrict__ chg,
                       int n, int m, int inner_max) {
  relax_block<B>(x, DenseWeights{W, (size_t)n * m}, base, x_out, chg, n, m,
                 inner_max, blockIdx.y, blockIdx.x);
}

template <int B, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int n, int m, cudaStream_t stream,
                   Args... args) {
  using S = Shape<B>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(m / B, n / B);
  const dim3 block(B, S::TY);
  kernel<<<grid, block, S::SMEM, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// One K1 round (compact receivers, frontier).  All arrays are row-major and
// contiguous on the current device: x, W1, base, x_out (n, m) float32; K
// (n, m) uint8; prev, chg (n/B, m/B) int32.  n and m are multiples of B; B
// is 16 or 64, the block sizes the solvers use.  Launches on `stream` and
// does not synchronise.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int uca_gs_round_f32(const void* x, const void* K, const void* W1,
                                const void* base, const void* prev,
                                void* x_out, void* chg, int n, int m, int B,
                                int inner_max, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* kf = static_cast<const uint8_t*>(K);
  const auto* wf = static_cast<const float*>(W1);
  const auto* bf = static_cast<const float*>(base);
  const auto* pf = static_cast<const int*>(prev);
  auto* of = static_cast<float*>(x_out);
  auto* cf = static_cast<int*>(chg);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 16:
      return launch<16>(uca_gs_round_kernel<16>, n, m, st, xf, kf, wf, bf, pf,
                        of, cf, n, m, inner_max);
    case 64:
      return launch<64>(uca_gs_round_kernel<64>, n, m, st, xf, kf, wf, bf, pf,
                        of, cf, n, m, inner_max);
    default: return cudaErrorInvalidValue;
  }
}

// One K2 round (dense weight planes, every block).  x, base, x_out (n, m)
// and W (8, n, m) float32, chg (n/B, m/B) int32, all row-major and
// contiguous on the current device; n, m multiples of B; B is 16 or 64.
// Launches on `stream` and does not synchronise.  Returns the cudaError_t
// of the launch (0 on success).
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
  switch (B) {
    case 16:
      return launch<16>(uca_block_round_kernel<16>, n, m, st, xf, wf, bf, of,
                        cf, n, m, inner_max);
    case 64:
      return launch<64>(uca_block_round_kernel<64>, n, m, st, xf, wf, bf, of,
                        cf, n, m, inner_max);
    default: return cudaErrorInvalidValue;
  }
}
