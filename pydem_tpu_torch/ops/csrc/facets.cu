// The D-infinity (Tarboton) facet sweep for Hopper (sm_90a), float32 and
// float64: slope magnitude and flow direction of every pixel of a grid.
//
// Replaces no TPU kernel: in the JAX package the sweep is jnp code that XLA
// fuses (pydem_tpu/core/slope_direction.py::slopes_directions).  Its eager
// PyTorch port (pydem_tpu_torch/core/slope_direction.py::
// _slopes_directions_eager) runs some forty full-grid kernels a facet, over
// the interior and again over the whole grid for the frame; this file
// computes the same two planes, bit for bit, in two launches:
//  * facet_pixels_kernel, one thread a pixel of a 32 x 32 tile staged in
//    shared memory with its 1-px halo (each elevation read from device
//    memory about once), every pixel its in-grid facets in order 0-7: all 8
//    inside the frame (the eager sweep's phase 1), the subset whose two
//    neighbours lie in the grid on the frame (its phase 3).  A pixel keeps
//    the running squared slope and the facet that set it; the in-facet
//    angle, one atan2 a pixel, is taken for that facet alone at the end.
//    The direction is the angle of the last facet whose squared slope beat
//    the running one, so this is the eager sweep's value.  Interior pixels
//    two or more from the edge are final here; those one from the edge keep
//    their squared slope (the frame copies read it); frame pixels hold -1
//    and their facets' best goes to a side buffer.
//  * facet_frame_kernel, one CTA: the eager sweep's phase 2, the
//    sequential copies of an inner neighbour onto the upstream-facing
//    edges (left column, right column, top row, bottom row, each step
//    seeing the earlier ones' writes, for any n, m >= 2), a CTA barrier
//    between steps; then its phase 3 on the frame, which from the copied
//    value m0 gives the best facet's (rad2, angle) where rad2 > m0 and
//    (m0, its direction) otherwise, exactly as the eager strict-greater
//    updates do from m0; then the square root on the frame and on the
//    pixels one from the edge.
// Rounding: each operation rounds once, as eager PyTorch does (built with
// -fmad=false; IEEE division, sqrt and atan2 as torch.div, torch.sqrt and
// torch.atan2 call them).  Divisions that two facets share in the eager
// sweep (the same difference over the same spacing) are computed once.
// The per-row spacings, hyp and both diagonal angles atan2(dY, dX) and
// atan2(dX, dY) are computed once per tile row into shared memory.
// Bound: the sweep reads the elevation once and writes two planes (12 B a
// float32 pixel); with 18 divisions, one atan2 and ~150 other operations
// a pixel it is bound by its instructions, not bytes: blocks of 256
// threads and no spill keep the SMs full.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TW = 32;       // tile columns: one warp a row
constexpr int TH = 32;       // tile rows
constexpr int ROWS = 8;      // thread rows of a CTA; each thread TH / ROWS pixels
constexpr int FRAME_THREADS = 1024;

// the facet's in-facet angle offset adj0 * pi/2 (rounded as a Python float
// first, as the eager sweep's scalar is) and its sign adj1
__device__ __forceinline__ double facet_offset(int k) {
  constexpr double HALF_PI = M_PI / 2;
  return (k == 0)   ? 0.0 * HALF_PI
         : (k <= 2) ? 1.0 * HALF_PI
         : (k <= 4) ? 2.0 * HALF_PI
         : (k <= 6) ? 3.0 * HALF_PI
                    : 4.0 * HALF_PI;
}

__device__ __forceinline__ int facet_sign(int k) { return (k & 1) ? -1 : 1; }

template <typename T>
struct Best {
  T rad2;    // running squared slope, -1 before any facet beats it
  int k;     // facet that set it, -1 for none
  int kind;  // 1: on the diagonal, 2: on the straight edge, 0: inside
  T s1, s2;  // that facet's slopes, for its atan2
};

// One facet's candidate, as _facet_candidates computes it, and the strict
// update of _apply_facets (NaN compares false, as torch's compares do).
template <typename T>
__device__ __forceinline__ void consider(bool ok, int k, T s1, T s2, T sd,
                                         T d1, T d2, Best<T>& b) {
  const T s1_2 = s1 * s1;
  const T s2_2 = s2 * s2;
  T rad2 = s1_2 + s2_2;
  const bool s1_lte0 = s1 <= T(0), s2_lte0 = s2 <= T(0), s2_gt0 = s2 > T(0);
  const bool i1 = s2_gt0 && (s1_lte0 || (s2 * d1 > s1 * d2));
  if (i1) rad2 = sd * sd;
  const bool i2 = (s2 < T(0)) || ((s2 == T(0)) && (s1 > T(0)));
  if (i2) rad2 = s1_2;
  const bool i3 = s1_lte0 && (s2_lte0 || (s2_gt0 && (sd <= T(0))));
  if (i3) rad2 = T(-1);
  if (ok && rad2 > b.rad2) {
    b.rad2 = rad2;
    b.k = k;
    b.kind = i1 ? 1 : (i2 ? 2 : 0);
    b.s1 = s1;
    b.s2 = s2;
  }
}

// per tile row: the up-facets' fence row i-1 and the down-facets' row i
// (clipped to [0, n-2]): dX, dY, hyp, atan2(dY, dX), atan2(dX, dY)
enum { DXU, DYU, HU, XYU, YXU, DXD, DYD, HD, XYD, YXD, NROW };

// (i, j) of the t-th pixel of the frame of an a x b rectangle (a, b >= 1):
// the top row, the bottom row, then the left and right columns between
template <typename I>
__device__ __forceinline__ void frame_pixel(I t, I a, I b, I& i, I& j) {
  if (a == 1) { i = 0; j = t; return; }
  if (b == 1) { i = t; j = 0; return; }
  if (t < b) { i = 0; j = t; return; }
  if (t < 2 * b) { i = a - 1; j = t - b; return; }
  t -= 2 * b;
  if (t < a - 2) { i = t + 1; j = 0; return; }
  i = t - (a - 2) + 1;
  j = b - 1;
}

template <typename I>
__device__ __forceinline__ I frame_size(I a, I b) {
  return (a == 1 || b == 1) ? a * b : 2 * b + 2 * (a - 2);
}

template <typename T>
__device__ __forceinline__ T finish_mag(T v) {
  return v > T(0) ? sqrt(v) : v;
}

template <typename T>
__global__ void __launch_bounds__(TW * ROWS)
facet_pixels_kernel(const T* __restrict__ elev, const T* __restrict__ dX,
                    const T* __restrict__ dY, T* __restrict__ mag, T* __restrict__ dir,
                    T* __restrict__ side, int n, int m) {
  __shared__ T tile[TH + 2][TW + 2];
  __shared__ T rowc[NROW][TH];
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const T nan = T(NAN);
  for (int t = tid; t < (TH + 2) * (TW + 2); t += TW * ROWS) {
    const int gi = i0 + t / (TW + 2) - 1, gj = j0 + t % (TW + 2) - 1;
    tile[t / (TW + 2)][t % (TW + 2)] =
        (gi >= 0 && gi < n && gj >= 0 && gj < m)
            ? elev[(size_t)gi * m + gj] : nan;
  }
  if (tid < TH) {
    const int i = min(i0 + tid, n - 1);
    const int f[2] = {max(i - 1, 0), min(i, n - 2)};
    for (int s = 0; s < 2; ++s) {  // up, then down: DXD - DXU apart
      const int at = s * (DXD - DXU);
      const T dx = dX[f[s]], dy = dY[f[s]];
      rowc[at + DXU][tid] = dx;
      rowc[at + DYU][tid] = dy;
      rowc[at + HU][tid] = sqrt(dx * dx + dy * dy);
      rowc[at + XYU][tid] = atan2(dy, dx);
      rowc[at + YXU][tid] = atan2(dx, dy);
    }
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  const int c = threadIdx.x + 1;
  if (j >= m) return;
  for (int r = threadIdx.y; r < TH; r += ROWS) {
    const int i = i0 + r;
    if (i >= n) return;
    const T dXu = rowc[DXU][r], dYu = rowc[DYU][r], hu = rowc[HU][r];
    const T dXd = rowc[DXD][r], dYd = rowc[DYD][r], hd = rowc[HD][r];
    const T e0 = tile[r + 1][c];
    const T eE = tile[r + 1][c + 1], eW = tile[r + 1][c - 1];
    const T eN = tile[r][c], eNE = tile[r][c + 1], eNW = tile[r][c - 1];
    const T eS = tile[r + 2][c], eSE = tile[r + 2][c + 1],
            eSW = tile[r + 2][c - 1];
    const bool up = i > 0, dn = i < n - 1, lf = j > 0, rt = j < m - 1;
    // s1 = (e0 - e1) / d1 and sd = (e0 - e2) / hyp, each shared by the
    // facets that compute the same quotient
    const T a0 = (e0 - eE) / dXu, a12 = (e0 - eN) / dYu;
    const T a3 = (e0 - eW) / dXu, a4 = (e0 - eW) / dXd;
    const T a56 = (e0 - eS) / dYd, a7 = (e0 - eE) / dXd;
    const T q01 = (e0 - eNE) / hu, q23 = (e0 - eNW) / hu;
    const T q45 = (e0 - eSW) / hd, q67 = (e0 - eSE) / hd;
    Best<T> b{T(-1), -1, 0, T(0), T(0)};
    consider(up && rt, 0, a0, (eE - eNE) / dYu, q01, dXu, dYu, b);
    consider(up && rt, 1, a12, (eN - eNE) / dXu, q01, dYu, dXu, b);
    consider(up && lf, 2, a12, (eN - eNW) / dXu, q23, dYu, dXu, b);
    consider(up && lf, 3, a3, (eW - eNW) / dYu, q23, dXu, dYu, b);
    consider(dn && lf, 4, a4, (eW - eSW) / dYd, q45, dXd, dYd, b);
    consider(dn && lf, 5, a56, (eS - eSW) / dXd, q45, dYd, dXd, b);
    consider(dn && rt, 6, a56, (eS - eSE) / dXd, q67, dYd, dXd, b);
    consider(dn && rt, 7, a7, (eE - eSE) / dYd, q67, dXd, dYd, b);
    T mg = T(-1), dr = T(-1);
    if (b.k >= 0) {
      mg = b.rad2;
      T ang;
      if (b.kind == 1) {
        // theta_b = atan2(d2, d1): (dY, dX) for facets 0, 3, 4, 7
        const bool xy = (b.k == 0 || b.k == 3 || b.k == 4 || b.k == 7);
        ang = rowc[b.k < 4 ? (xy ? XYU : YXU) : (xy ? XYD : YXD)][r];
      } else if (b.kind == 2) {
        ang = T(0);
      } else {
        ang = atan2(b.s2, b.s1);
      }
      dr = ang * T(facet_sign(b.k)) + T(facet_offset(b.k));
    }
    const size_t p = (size_t)i * m + j;
    if (!up || !dn || !lf || !rt) {
      // the frame: -1 until the copies, the facets' best aside
      const size_t S = 2 * (size_t)n + 2 * (size_t)m - 4;
      const size_t slot = !up   ? (size_t)j
                          : !dn ? (size_t)m + j
                          : !lf ? 2 * (size_t)m + (i - 1)
                                : 2 * (size_t)m + (n - 2) + (i - 1);
      mag[p] = T(-1);
      dir[p] = T(-1);
      side[slot] = mg;
      side[S + slot] = dr;
    } else {
      const bool ring = i == 1 || i == n - 2 || j == 1 || j == m - 2;
      mag[p] = ring ? mg : finish_mag(mg);
      dir[p] = dr;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FRAME_THREADS)
facet_frame_kernel(T* __restrict__ mag, T* __restrict__ dir,
                   const T* __restrict__ side, int n_, int m_) {
  // the eager sweep compares with Python floats rounded to the tensor's type
  const T half_pi = T(M_PI / 2), three_half_pi = T(3 * M_PI / 2);
  const T pi = T(M_PI), two_pi = T(2 * M_PI);
  const size_t n = n_, m = m_;
  const size_t t0 = threadIdx.x, dt = blockDim.x;
  // left column from column 1
  for (size_t i = t0; i < n; i += dt) {
    const T d = dir[i * m + 1];
    if (d > half_pi && d < three_half_pi) {
      dir[i * m] = d;
      mag[i * m] = mag[i * m + 1];
    }
  }
  __syncthreads();
  // right column from column m-2
  for (size_t i = t0; i < n; i += dt) {
    const T d = dir[i * m + m - 2];
    if (d < half_pi || d > three_half_pi) {
      dir[i * m + m - 1] = d;
      mag[i * m + m - 1] = mag[i * m + m - 2];
    }
  }
  __syncthreads();
  // top row from row 1
  for (size_t j = t0; j < m; j += dt) {
    const T d = dir[m + j];
    if (d > T(0) && d < pi) {
      dir[j] = d;
      mag[j] = mag[m + j];
    }
  }
  __syncthreads();
  // bottom row from row n-2
  for (size_t j = t0; j < m; j += dt) {
    const T d = dir[(n - 2) * m + j];
    if (d > pi && d < two_pi) {
      dir[(n - 1) * m + j] = d;
      mag[(n - 1) * m + j] = mag[(n - 2) * m + j];
    }
  }
  __syncthreads();
  // the frame's facets over the copied values, then the square roots of
  // the frame and of the pixels one from the edge (read by the copies)
  const size_t S = frame_size(n, m);
  for (size_t t = t0; t < S; t += dt) {
    size_t i, j;
    frame_pixel(t, n, m, i, j);
    const size_t p = i * m + j;
    T mg = mag[p];
    if (side[t] > mg) {
      mg = side[t];
      dir[p] = side[S + t];
    }
    mag[p] = finish_mag(mg);
  }
  if (n >= 3 && m >= 3) {
    const size_t R = frame_size(n - 2, m - 2);
    for (size_t t = t0; t < R; t += dt) {
      size_t i, j;
      frame_pixel(t, n - 2, m - 2, i, j);
      const size_t p = (i + 1) * m + (j + 1);
      mag[p] = finish_mag(mag[p]);
    }
  }
}

template <typename T>
int sweep(const void* elev, const void* dX, const void* dY, void* mag,
          void* dir, void* side, int n, int m, void* stream) {
  if (n < 2 || m < 2) return -(int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + TW - 1) / TW, (n + TH - 1) / TH);
  facet_pixels_kernel<T><<<grid, dim3(TW, ROWS), 0, s>>>(
      static_cast<const T*>(elev), static_cast<const T*>(dX),
      static_cast<const T*>(dY), static_cast<T*>(mag), static_cast<T*>(dir), static_cast<T*>(side), n,
      m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -(int)err;
  facet_frame_kernel<T><<<1, FRAME_THREADS, 0, s>>>(
      static_cast<T*>(mag), static_cast<T*>(dir),
      static_cast<const T*>(side), n, m);
  err = cudaGetLastError();
  return err != cudaSuccess ? -(int)err : 2;
}

}  // namespace

// The facet sweep of an (n, m) grid, n, m >= 2.  All arrays are contiguous
// on the current device, of one type: elev, mag, dir (n, m); dX, dY (n-1)
// (the spacing between rows i and i+1); side, scratch of 2 (2n + 2m - 4).
// Launches two kernels on `stream` and does not synchronise.  Returns the
// number of kernels launched (2), or minus the cudaError_t of a failed
// launch.
extern "C" int facet_sweep_f32(const void* elev, const void* dX,
                               const void* dY, void* mag, void* dir,
                               void* side, int n, int m, void* stream) {
  return sweep<float>(elev, dX, dY, mag, dir, side, n, m, stream);
}

extern "C" int facet_sweep_f64(const void* elev, const void* dX,
                               const void* dY, void* mag, void* dir,
                               void* side, int n, int m, void* stream) {
  return sweep<double>(elev, dX, dY, mag, dir, side, n, m, stream);
}
