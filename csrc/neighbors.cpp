// Cell-list neighbor builder for sclmd_jax.
//
// The JAX potentials (models/tersoff.py, models/sw.py, models/nnp.py)
// consume a static padded neighbor table built once from the reference
// geometry. The Python builder is O(na^2) with a per-atom Python loop —
// fine for hundreds of atoms, the setup bottleneck beyond ~10^4. This
// native builder uses cell lists (O(na) at fixed density) with an
// orthorhombic minimum-image convention, and reproduces the Python
// semantics exactly: per atom, neighbors within cutoff sorted by
// (distance, index), truncated/padded to max_nnei (-1 = padding).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double wrap(double d, double L) {
  if (L > 0.0) d -= std::round(d / L) * L;
  return d;
}

}  // namespace

extern "C" {

// xyz: (na, 3) row-major; cell: 3 lengths or nullptr (open boundaries);
// nbr_out: (na, max_nnei) int64; mask_out: (na, max_nnei) uint8.
// Returns the maximum neighbor count seen (so callers can detect
// max_nnei overflow); negative on error.
long long sclmd_neighbors(long long na, const double* xyz,
                          const double* cell, double cutoff,
                          long long max_nnei, long long* nbr_out,
                          unsigned char* mask_out) {
  if (na <= 0 || cutoff <= 0.0 || max_nnei <= 0) return -1;
  const double c2 = cutoff * cutoff;
  double L[3] = {0.0, 0.0, 0.0};
  if (cell) {
    L[0] = cell[0];
    L[1] = cell[1];
    L[2] = cell[2];
  }

  // bin geometry: cover the bounding box (or the cell) with bins of
  // size >= cutoff; periodic axes use exactly L/floor(L/cutoff) bins
  double lo[3], hi[3];
  int nb[3];
  for (int a = 0; a < 3; ++a) {
    if (L[a] > 0.0) {
      lo[a] = 0.0;
      hi[a] = L[a];
      nb[a] = std::max(1, static_cast<int>(std::floor(L[a] / cutoff)));
    } else {
      lo[a] = xyz[a];
      hi[a] = xyz[a];
      for (long long i = 1; i < na; ++i) {
        lo[a] = std::min(lo[a], xyz[3 * i + a]);
        hi[a] = std::max(hi[a], xyz[3 * i + a]);
      }
      const double span = std::max(hi[a] - lo[a], 1e-12);
      nb[a] = std::max(1, static_cast<int>(std::floor(span / cutoff)));
    }
  }
  const long long nbins =
      static_cast<long long>(nb[0]) * nb[1] * nb[2];

  auto bin_of = [&](long long i) -> long long {
    long long b[3];
    for (int a = 0; a < 3; ++a) {
      double u = xyz[3 * i + a] - lo[a];
      if (L[a] > 0.0) u -= std::floor(u / L[a]) * L[a];  // into [0, L)
      long long k = static_cast<long long>(
          std::floor(u / (hi[a] - lo[a] > 0 ? (hi[a] - lo[a]) : 1.0)
                     * nb[a]));
      b[a] = std::min<long long>(std::max<long long>(k, 0), nb[a] - 1);
    }
    return (b[0] * nb[1] + b[1]) * nb[2] + b[2];
  };

  std::vector<std::vector<int64_t>> bins(nbins);
  for (long long i = 0; i < na; ++i) bins[bin_of(i)].push_back(i);

  struct Cand {
    double r2;
    int64_t j;
  };
  std::vector<Cand> cands;
  long long worst = 0;

  for (long long i = 0; i < na; ++i) {
    cands.clear();
    // locate i's bin indices
    long long bi = bin_of(i);
    long long b0 = bi / (nb[1] * nb[2]);
    long long b1 = (bi / nb[2]) % nb[1];
    long long b2 = bi % nb[2];
    for (int d0 = -1; d0 <= 1; ++d0)
      for (int d1 = -1; d1 <= 1; ++d1)
        for (int d2 = -1; d2 <= 1; ++d2) {
          long long k0 = b0 + d0, k1 = b1 + d1, k2 = b2 + d2;
          // periodic axes wrap; open axes clip (skip duplicates when a
          // periodic axis has < 3 bins: visit each bin once)
          long long kk[3] = {k0, k1, k2};
          bool skip = false;
          for (int a = 0; a < 3; ++a) {
            if (L[a] > 0.0) {
              if (nb[a] < 3) {
                // few bins: only the 0 offset is meaningful; others
                // would revisit the same bins
                if ((a == 0 ? d0 : a == 1 ? d1 : d2) != 0 &&
                    nb[a] == 1) {
                  skip = true;
                  break;
                }
                kk[a] = ((kk[a] % nb[a]) + nb[a]) % nb[a];
              } else {
                kk[a] = ((kk[a] % nb[a]) + nb[a]) % nb[a];
              }
            } else if (kk[a] < 0 || kk[a] >= nb[a]) {
              skip = true;
              break;
            }
          }
          if (skip) continue;
          const auto& cell_atoms =
              bins[(kk[0] * nb[1] + kk[1]) * nb[2] + kk[2]];
          for (int64_t j : cell_atoms) {
            if (j == i) continue;
            double dx = wrap(xyz[3 * j] - xyz[3 * i], L[0]);
            double dy = wrap(xyz[3 * j + 1] - xyz[3 * i + 1], L[1]);
            double dz = wrap(xyz[3 * j + 2] - xyz[3 * i + 2], L[2]);
            double r2 = dx * dx + dy * dy + dz * dz;
            if (r2 < c2) cands.push_back({r2, j});
          }
        }
    // nb[a] == 2 on a periodic axis makes +-1 offsets alias the same
    // bin: dedupe
    std::sort(cands.begin(), cands.end(), [](const Cand& a, const Cand& b) {
      return a.j < b.j;
    });
    cands.erase(std::unique(cands.begin(), cands.end(),
                            [](const Cand& a, const Cand& b) {
                              return a.j == b.j;
                            }),
                cands.end());
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) {
                if (a.r2 != b.r2) return a.r2 < b.r2;
                return a.j < b.j;
              });
    worst = std::max<long long>(worst,
                                static_cast<long long>(cands.size()));
    for (long long n = 0; n < max_nnei; ++n) {
      if (n < static_cast<long long>(cands.size())) {
        nbr_out[i * max_nnei + n] = cands[n].j;
        mask_out[i * max_nnei + n] = 1;
      } else {
        nbr_out[i * max_nnei + n] = -1;
        mask_out[i * max_nnei + n] = 0;
      }
    }
  }
  return worst;
}

}  // extern "C"
