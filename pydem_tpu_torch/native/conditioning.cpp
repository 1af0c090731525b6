// Native host-side conditioning kernel: pit drain-path carving.
//
// The PyTorch port's copy of pydem_tpu/native/conditioning.cpp (the port
// imports nothing of the JAX package).  From the first include line on,
// the two files are byte for byte the same, as
// tests/test_torch_conditioning.py checks.  Only this header differs.
//
// C++ counterpart of pydem_tpu_torch.core.conditioning.drain_pit_paths
// (semantics of the reference pyDEM's DEMProcessor.calc_pit_drain_paths,
// dem_processing.py:428-548): for each pit, in ascending elevation order,
// grow a min-elevation region until a strictly lower drain appears, filter
// drains by pixel/real distance, back-prune the growth path to an
// 8-connected chain, and carve a linear elevation ramp from pit to drain.
// Elevation is mutated in place as pits are processed, so later pits see
// earlier carvings, identical to the numpy path.  Built with g++ on first
// use (pydem_tpu_torch/native/__init__.py) and called through ctypes.
//
// Pit detection and the ascending-elevation ordering stay in numpy (the
// caller passes `pits` pre-sorted with np.argsort) so tie ordering is
// bit-identical with the numpy fallback.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

namespace {

struct Grid {
    int64_t n, m;
    // 8-neighborhood in the ascending-flat-index order produced by the
    // python _adjacent_flat_indices helper does not matter here: borders are
    // kept globally sorted, so per-pixel emission order is irrelevant.
    inline void neighbors(int64_t p, int64_t* out, int* count) const {
        int64_t i = p / m, j = p % m;
        int c = 0;
        for (int64_t di = -1; di <= 1; ++di) {
            for (int64_t dj = -1; dj <= 1; ++dj) {
                if (di == 0 && dj == 0) continue;
                int64_t i2 = i + di, j2 = j + dj;
                if (i2 < 0 || i2 >= n || j2 < 0 || j2 >= m) continue;
                out[c++] = i2 * m + j2;
            }
        }
        *count = c;
    }
};

// mean of dX[min(i1,i2) : max(i1,i2)] -- fence rows between post rows i1,i2
// (dem_processing.py:1993-1997); dX has length n-1.
inline double fence_mean(const double* dX, int64_t ndx, int64_t i1, int64_t i2) {
    if (i1 == i2) return dX[std::min(i1, ndx - 1)];
    int64_t a = std::min(i1, i2), b = std::max(i1, i2);
    double s = 0.0;
    for (int64_t k = a; k < b; ++k) s += dX[k];
    return s / double(b - a);
}

inline double span_sum(const double* dY, int64_t i1, int64_t i2) {
    int64_t a = std::min(i1, i2), b = std::max(i1, i2);
    double s = 0.0;
    for (int64_t k = a; k < b; ++k) s += dY[k];
    return s;
}

}  // namespace

extern "C" {

// Carve drain paths for every pit.  `e` (n*m, row-major float64) is mutated.
// `pits` must be sorted by ascending elevation (np.argsort order).
// max_dist <= 0 / max_dist_XY <= 0 disable the respective filter.
// Returns the number of pits that found no drain (warn count).
int64_t drain_pit_paths(double* e, int64_t n, int64_t m,
                        const double* dX, const double* dY,
                        const int64_t* pits, int64_t n_pits,
                        int64_t max_iter, double max_dist,
                        double max_dist_XY) {
    const Grid g{n, m};
    const int64_t N = n * m;
    std::vector<int32_t> area_stamp(N, 0), border_stamp(N, 0);
    std::vector<int64_t> border, adds, newly, path, drain;
    int64_t nbr[8];
    int nc;
    int32_t stamp = 0;
    int64_t warn = 0;

    for (int64_t pi = 0; pi < n_pits; ++pi) {
        const int64_t pit = pits[pi];
        const double epit = e[pit];
        ++stamp;
        area_stamp[pit] = stamp;
        path.assign(1, pit);
        border.clear();
        g.neighbors(pit, nbr, &nc);
        for (int k = 0; k < nc; ++k) {
            border_stamp[nbr[k]] = stamp;
            border.push_back(nbr[k]);
        }
        std::sort(border.begin(), border.end());

        drain.clear();
        bool found = false;
        for (int64_t it = 0; it < max_iter && !border.empty(); ++it) {
            double emin = e[border[0]];
            bool has_nan = false;
            for (int64_t b : border) {
                if (std::isnan(e[b])) has_nan = true;
                emin = std::min(emin, e[b]);
            }
            if (has_nan) break;  // numpy: NaN poisons min() -> growth stalls
                                 // until max_iter and the pit warns
            if (emin < epit) {
                for (int64_t b : border)
                    if (e[b] == emin) drain.push_back(b);
                found = true;
                break;
            }
            // grow by every border pixel at the min elevation (ascending
            // index order: `border` is sorted)
            newly.clear();
            for (int64_t b : border)
                if (e[b] == emin) {
                    newly.push_back(b);
                    area_stamp[b] = stamp;
                    path.push_back(b);
                }
            adds.clear();
            for (int64_t p : newly) {
                g.neighbors(p, nbr, &nc);
                for (int k = 0; k < nc; ++k) {
                    int64_t q = nbr[k];
                    if (area_stamp[q] != stamp && border_stamp[q] != stamp) {
                        border_stamp[q] = stamp;
                        adds.push_back(q);
                    }
                }
            }
            std::sort(adds.begin(), adds.end());
            // border := (border \ newly) merge adds, staying sorted
            std::vector<int64_t> next;
            next.reserve(border.size() + adds.size());
            size_t ai = 0;
            for (int64_t b : border) {
                if (area_stamp[b] == stamp) continue;  // grown
                while (ai < adds.size() && adds[ai] < b) next.push_back(adds[ai++]);
                next.push_back(b);
            }
            while (ai < adds.size()) next.push_back(adds[ai++]);
            border.swap(next);
        }

        if (!found) {
            ++warn;
            continue;
        }

        const int64_t ipit = pit / m, jpit = pit % m;

        // pixel-distance filter
        if (max_dist > 0) {
            std::vector<int64_t> kept;
            for (int64_t d : drain) {
                double di = double(ipit - d / m), dj = double(jpit - d % m);
                if (std::sqrt(di * di + dj * dj) <= max_dist) kept.push_back(d);
            }
            if (kept.empty()) {
                ++warn;
                continue;
            }
            drain.swap(kept);
        }

        // real-distance (meters) per drain
        std::vector<double> dxy(drain.size());
        for (size_t k = 0; k < drain.size(); ++k) {
            int64_t i2 = drain[k] / m, j2 = drain[k] % m;
            double dx = fence_mean(dX, n - 1, ipit, i2) * double(jpit - j2);
            double dy = span_sum(dY, ipit, i2);
            dxy[k] = std::sqrt(dx * dx + dy * dy);
        }
        if (max_dist_XY > 0) {
            std::vector<int64_t> kd;
            std::vector<double> kx;
            for (size_t k = 0; k < drain.size(); ++k)
                if (dxy[k] <= max_dist_XY) {
                    kd.push_back(drain[k]);
                    kx.push_back(dxy[k]);
                }
            if (kd.empty()) {
                ++warn;
                continue;
            }
            drain.swap(kd);
            dxy.swap(kx);
        }

        // nearest drain; ties resolve to the lowest flat index (drains are
        // in ascending order), matching `drain[dxy == dxy.min()][0]`
        double dmin = dxy[0];
        for (double v : dxy) dmin = std::min(dmin, v);
        int64_t d0 = -1;
        for (size_t k = 0; k < drain.size(); ++k)
            if (dxy[k] == dmin) {
                d0 = drain[k];
                break;
            }
        path.push_back(d0);

        // back-prune path pixels not 8-connected toward the drain
        // (dem_processing.py:520-532 semantics, as in the numpy fallback)
        int64_t k = int64_t(path.size()) - 2;
        while (k > 0) {
            int64_t ia = path[k] / m, ja = path[k] % m;
            int64_t ib = path[k + 1] / m, jb = path[k + 1] % m;
            if (std::llabs(ia - ib) <= 1 && std::llabs(ja - jb) <= 1) {
                --k;
            } else {
                path.erase(path.begin() + k);
                k = std::min(k, int64_t(path.size()) - 2);
            }
            if (path[k] == pit) break;
        }

        // carve a linear ramp pit -> drain (numpy linspace semantics: value_i
        // = i*step with the endpoint forced exact)
        if (e[pit] < e[d0]) {
            double lift = HUGE_VAL;
            for (int64_t p : path)
                if (e[p] > e[d0]) lift = std::min(lift, e[p]);
            e[pit] = lift;
        }
        const double start = e[pit];
        const double si = e[d0] - start;
        const int64_t L = int64_t(path.size());
        if (L > 1) {
            const double step = 1.0 / double(L - 1);
            for (int64_t t = 0; t < L; ++t) {
                double f = (t == L - 1) ? 1.0 : double(t) * step;
                e[path[t]] = start + f * si;
            }
        } else {
            e[path[0]] = start;
        }
    }
    return warn;
}

}  // extern "C"
