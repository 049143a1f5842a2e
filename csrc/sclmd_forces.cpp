// Native force engine for sclmd_jax.
//
// The host-side analog of the reference's in-process LAMMPS library
// (lammpsdriver.py loads liblammps via ctypes): a small C++ engine with
// a C ABI that evaluates pair-potential forces/energies and central-
// difference dynamical matrices for junction geometries. Used through
// sclmd_jax.models.native.NativeDriver (ctypes), following the same
// driver protocol (.force(q), .f0, .conv, .dynmat()).
//
// Potentials: Lennard-Jones 12-6 (shifted), Morse, harmonic bonds.
// Neighbor lists are static (built once from the reference geometry
// with a skin), matching the JAX drivers' semantics.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pair {
  int i, j;
};

struct Engine {
  int natoms = 0;
  std::vector<double> x0;       // reference positions (3N)
  std::vector<Pair> pairs;      // static half neighbor list
  std::vector<Pair> bonds;      // explicit bonds (harmonic)
  // LJ
  double eps = 0.0, sigma = 0.0, rcut = 0.0;
  bool use_lj = false;
  // Morse
  double D = 0.0, alpha = 0.0, r0 = 0.0, mcut = 0.0;
  bool use_morse = false;
  // harmonic bonds
  double kbond = 0.0, rbond = 0.0;
  // periodic cell (orthorhombic, 0 = open)
  double cell[3] = {0.0, 0.0, 0.0};
};

inline void min_image(const Engine* e, double* d) {
  for (int c = 0; c < 3; ++c) {
    if (e->cell[c] > 0.0) d[c] -= std::round(d[c] / e->cell[c]) * e->cell[c];
  }
}

double pair_energy_force(const Engine* e, const double* x, double* f) {
  double energy = 0.0;
  if (f) std::memset(f, 0, sizeof(double) * 3 * e->natoms);

  const double rc2 = e->rcut * e->rcut;
  double eshift = 0.0;
  if (e->use_lj) {
    const double sr6c = std::pow(e->sigma / e->rcut, 6);
    eshift = 4.0 * e->eps * (sr6c * sr6c - sr6c);
  }

  for (const Pair& p : e->pairs) {
    double d[3] = {x[3 * p.j] - x[3 * p.i], x[3 * p.j + 1] - x[3 * p.i + 1],
                   x[3 * p.j + 2] - x[3 * p.i + 2]};
    min_image(e, d);
    const double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const double r = std::sqrt(r2);

    double de_dr = 0.0;  // dE/dr
    if (e->use_lj && r2 < rc2) {
      const double sr6 = std::pow(e->sigma * e->sigma / r2, 3);
      energy += 4.0 * e->eps * (sr6 * sr6 - sr6) - eshift;
      de_dr += 4.0 * e->eps * (-12.0 * sr6 * sr6 + 6.0 * sr6) / r;
    }
    if (e->use_morse && r < e->mcut) {
      const double ex = std::exp(-e->alpha * (r - e->r0));
      energy += e->D * (ex * ex - 2.0 * ex);
      de_dr += e->D * (-2.0 * e->alpha * ex * ex + 2.0 * e->alpha * ex);
    }
    if (f && de_dr != 0.0) {
      for (int c = 0; c < 3; ++c) {
        const double fc = -de_dr * d[c] / r;  // force on j
        f[3 * p.j + c] += fc;
        f[3 * p.i + c] -= fc;
      }
    }
  }

  for (const Pair& b : e->bonds) {
    double d[3] = {x[3 * b.j] - x[3 * b.i], x[3 * b.j + 1] - x[3 * b.i + 1],
                   x[3 * b.j + 2] - x[3 * b.i + 2]};
    min_image(e, d);
    const double r = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const double dr = r - e->rbond;
    energy += 0.5 * e->kbond * dr * dr;
    if (f) {
      const double de_dr = e->kbond * dr;
      for (int c = 0; c < 3; ++c) {
        const double fc = -de_dr * d[c] / r;
        f[3 * b.j + c] += fc;
        f[3 * b.i + c] -= fc;
      }
    }
  }
  return energy;
}

}  // namespace

extern "C" {

void* sclmd_engine_create(int natoms, const double* x0, const double* cell) {
  Engine* e = new Engine();
  e->natoms = natoms;
  e->x0.assign(x0, x0 + 3 * natoms);
  if (cell) {
    for (int c = 0; c < 3; ++c) e->cell[c] = cell[c];
  }
  return e;
}

void sclmd_engine_destroy(void* h) { delete static_cast<Engine*>(h); }

void sclmd_set_lj(void* h, double eps, double sigma, double rcut) {
  Engine* e = static_cast<Engine*>(h);
  e->eps = eps;
  e->sigma = sigma;
  e->rcut = rcut;
  e->use_lj = true;
}

void sclmd_set_morse(void* h, double D, double alpha, double r0,
                     double rcut) {
  Engine* e = static_cast<Engine*>(h);
  e->D = D;
  e->alpha = alpha;
  e->r0 = r0;
  e->mcut = rcut;
  e->use_morse = true;
}

void sclmd_set_bonds(void* h, int nbond, const int* ij, double k, double r0) {
  Engine* e = static_cast<Engine*>(h);
  e->bonds.clear();
  for (int b = 0; b < nbond; ++b)
    e->bonds.push_back({ij[2 * b], ij[2 * b + 1]});
  e->kbond = k;
  e->rbond = r0;
}

// build the static half pair list from the reference geometry
int sclmd_build_neighbors(void* h, double cutoff, double skin) {
  Engine* e = static_cast<Engine*>(h);
  e->pairs.clear();
  const double rc = cutoff + skin;
  for (int i = 0; i < e->natoms; ++i) {
    for (int j = i + 1; j < e->natoms; ++j) {
      double d[3] = {e->x0[3 * j] - e->x0[3 * i],
                     e->x0[3 * j + 1] - e->x0[3 * i + 1],
                     e->x0[3 * j + 2] - e->x0[3 * i + 2]};
      min_image(e, d);
      const double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (r2 < rc * rc) e->pairs.push_back({i, j});
    }
  }
  return static_cast<int>(e->pairs.size());
}

double sclmd_energy(void* h, const double* x) {
  return pair_energy_force(static_cast<Engine*>(h), x, nullptr);
}

double sclmd_forces(void* h, const double* x, double* f) {
  return pair_energy_force(static_cast<Engine*>(h), x, f);
}

// dynamical matrix in raw cartesian coordinates by central differences:
// D[a,b] = -dF_b/dx_a, symmetrised. out is (3N x 3N) row-major.
void sclmd_dynmat(void* h, const double* x, double eps, double* out) {
  Engine* e = static_cast<Engine*>(h);
  const int n = 3 * e->natoms;
  std::vector<double> xp(x, x + n), fp(n), fm(n);
  for (int a = 0; a < n; ++a) {
    xp[a] = x[a] + eps;
    pair_energy_force(e, xp.data(), fp.data());
    xp[a] = x[a] - eps;
    pair_energy_force(e, xp.data(), fm.data());
    xp[a] = x[a];
    for (int b = 0; b < n; ++b)
      out[a * n + b] = -(fp[b] - fm[b]) / (2.0 * eps);
  }
  // symmetrise
  for (int a = 0; a < n; ++a)
    for (int b = a + 1; b < n; ++b) {
      const double s = 0.5 * (out[a * n + b] + out[b * n + a]);
      out[a * n + b] = s;
      out[b * n + a] = s;
    }
}

}  // extern "C"
