// Native C++ MLS-MPM validation solver.
//
// The framework's counterpart to the reference's native half — the
// standalone C++ validation solver cpp_validation/mls-mpm88-explained.cpp
// (2D MLS-MPM, fixed corotated + snow plasticity, fp32) and the math
// routines it uses from the bundled legacy-taichi header (2D polar
// decomposition taichi.h:8375, 2x2 SVD taichi.h:8389).  This is an
// independent implementation of the same published algorithm (Hu et al.,
// MLS-MPM, SIGGRAPH 2018; Jiang et al. SVD notes Algorithm 4) with a C API
// over structure-of-arrays buffers so Python binds it with ctypes — no
// pybind11 dependency.
//
// Role in the framework: a second, native ground truth.  The test suite
// cross-validates three implementations per substep — this C++ solver, the
// NumPy oracle (oracle/mls_mpm88_numpy.py) and the JAX solvers —
// the same cross-implementation QA strategy the reference uses
// (README.md:27-35).
//
// Build: `make -C native` -> libmpm_oracle.so  (g++ -O2, strict IEEE fp).

#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

struct Mat2 {
  // Row-major 2x2.
  float a00, a01, a10, a11;
};

inline Mat2 mul(const Mat2 &x, const Mat2 &y) {
  return {x.a00 * y.a00 + x.a01 * y.a10, x.a00 * y.a01 + x.a01 * y.a11,
          x.a10 * y.a00 + x.a11 * y.a10, x.a10 * y.a01 + x.a11 * y.a11};
}

inline Mat2 transposed(const Mat2 &x) { return {x.a00, x.a10, x.a01, x.a11}; }

inline float det(const Mat2 &x) { return x.a00 * x.a11 - x.a01 * x.a10; }

// Closed-form 2D polar decomposition: rotation from the trace/skew pair.
inline void polar_decomp(const Mat2 &m, Mat2 &r, Mat2 &s) {
  float x = m.a00 + m.a11;
  float y = m.a10 - m.a01;
  float scale = 1.0f / std::sqrt(x * x + y * y);
  float c = x * scale, sn = y * scale;
  r = {c, -sn, sn, c};
  s = mul(transposed(r), m);
}

// 2x2 SVD via polar + one Jacobi rotation (Jiang et al., Algorithm 4).
inline void svd2(const Mat2 &m, Mat2 &u, float sig[2], Mat2 &v) {
  Mat2 s;
  polar_decomp(m, u, s);
  float c, sn;
  if (std::fabs(s.a01) < 1e-6f) {
    sig[0] = s.a00;
    sig[1] = s.a11;
    c = 1.0f;
    sn = 0.0f;
  } else {
    float tao = 0.5f * (s.a00 - s.a11);
    float w = std::sqrt(tao * tao + s.a01 * s.a01);
    float t = tao > 0 ? s.a01 / (tao + w) : s.a01 / (tao - w);
    c = 1.0f / std::sqrt(t * t + 1.0f);
    sn = -t * c;
    sig[0] = c * c * s.a00 - 2 * c * sn * s.a01 + sn * sn * s.a11;
    sig[1] = sn * sn * s.a00 + 2 * c * sn * s.a01 + c * c * s.a11;
  }
  if (sig[0] < sig[1]) {
    std::swap(sig[0], sig[1]);
    v = {-sn, -c, c, -sn};
  } else {
    v = {c, -sn, sn, c};
  }
  v = transposed(v);
  u = mul(u, v);
}

}  // namespace

extern "C" {

struct MPM88Params {
  int num_grid;       // cells per axis (nodes = num_grid + 1)
  float dt;
  float mass_p;
  float vol_p;
  float hardening;
  float mu_0;
  float lambda_0;
  float gravity;      // y acceleration (negative = down)
  float boundary;     // normalized wall band width
  int plastic;        // 0/1 snow plasticity clamp
};

// Advance `steps` substeps in place over SoA particle buffers:
//   x, v       : (n, 2)
//   F, C       : (n, 2, 2) row-major
//   Jp         : (n,)
// grid_scratch : caller-provided ((num_grid+1)^2 * 3) floats, or nullptr
//                to use an internal allocation.
void mpm88_advance(float *x, float *v, float *F, float *C, float *Jp, int n,
                   int steps, const MPM88Params *prm, float *grid_scratch) {
  const int ng = prm->num_grid + 1;
  const float dx = 1.0f / prm->num_grid;
  const float inv_dx = (float)prm->num_grid;
  float *grid = grid_scratch;
  bool own = false;
  if (!grid) {
    grid = new float[ng * ng * 3];
    own = true;
  }

  for (int step = 0; step < steps; step++) {
    std::memset(grid, 0, sizeof(float) * ng * ng * 3);

    // ---- P2G ----
    for (int p = 0; p < n; p++) {
      float px = x[2 * p], py = x[2 * p + 1];
      int bx = (int)(px * inv_dx - 0.5f);
      int by = (int)(py * inv_dx - 0.5f);
      float fx = px * inv_dx - bx, fy = py * inv_dx - by;
      float wx[3] = {0.5f * (1.5f - fx) * (1.5f - fx),
                     0.75f - (fx - 1.0f) * (fx - 1.0f),
                     0.5f * (fx - 0.5f) * (fx - 0.5f)};
      float wy[3] = {0.5f * (1.5f - fy) * (1.5f - fy),
                     0.75f - (fy - 1.0f) * (fy - 1.0f),
                     0.5f * (fy - 0.5f) * (fy - 0.5f)};

      float e = std::exp(prm->hardening * (1.0f - Jp[p]));
      float mu = prm->mu_0 * e, lambda = prm->lambda_0 * e;
      Mat2 Fp = {F[4 * p], F[4 * p + 1], F[4 * p + 2], F[4 * p + 3]};
      Mat2 Cp = {C[4 * p], C[4 * p + 1], C[4 * p + 2], C[4 * p + 3]};
      float J = det(Fp);
      Mat2 r, s;
      polar_decomp(Fp, r, s);
      float dinv = 4.0f * inv_dx * inv_dx;
      // PF = 2 mu (F - R) F^T + lambda (J - 1) J I
      Mat2 fmr = {Fp.a00 - r.a00, Fp.a01 - r.a01, Fp.a10 - r.a10,
                  Fp.a11 - r.a11};
      Mat2 pf = mul(fmr, transposed(Fp));
      float lj = lambda * (J - 1.0f) * J;
      pf = {2 * mu * pf.a00 + lj, 2 * mu * pf.a01, 2 * mu * pf.a10,
            2 * mu * pf.a11 + lj};
      float sc = -(prm->dt * prm->vol_p) * dinv;
      Mat2 affine = {sc * pf.a00 + prm->mass_p * Cp.a00,
                     sc * pf.a01 + prm->mass_p * Cp.a01,
                     sc * pf.a10 + prm->mass_p * Cp.a10,
                     sc * pf.a11 + prm->mass_p * Cp.a11};

      float mvx = prm->mass_p * v[2 * p], mvy = prm->mass_p * v[2 * p + 1];
      for (int i = 0; i < 3; i++) {
        for (int j = 0; j < 3; j++) {
          float dpx = (i - fx) * dx, dpy = (j - fy) * dx;
          float w = wx[i] * wy[j];
          float *g = grid + 3 * ((bx + i) * ng + (by + j));
          g[0] += w * (mvx + affine.a00 * dpx + affine.a01 * dpy);
          g[1] += w * (mvy + affine.a10 * dpx + affine.a11 * dpy);
          g[2] += w * prm->mass_p;
        }
      }
    }

    // ---- grid update ----
    for (int i = 0; i < ng; i++) {
      for (int j = 0; j < ng; j++) {
        float *g = grid + 3 * (i * ng + j);
        if (g[2] > 0) {
          g[0] /= g[2];
          g[1] /= g[2];
          g[2] = 1.0f;
          g[1] += prm->dt * prm->gravity;
          float nx = (float)i / prm->num_grid;
          float ny = (float)j / prm->num_grid;
          if (nx < prm->boundary || nx > 1 - prm->boundary ||
              ny > 1 - prm->boundary) {
            g[0] = g[1] = g[2] = 0.0f;
          }
          if (ny < prm->boundary) {
            g[1] = std::max(0.0f, g[1]);
          }
        }
      }
    }

    // ---- G2P ----
    for (int p = 0; p < n; p++) {
      float px = x[2 * p], py = x[2 * p + 1];
      int bx = (int)(px * inv_dx - 0.5f);
      int by = (int)(py * inv_dx - 0.5f);
      float fx = px * inv_dx - bx, fy = py * inv_dx - by;
      float wx[3] = {0.5f * (1.5f - fx) * (1.5f - fx),
                     0.75f - (fx - 1.0f) * (fx - 1.0f),
                     0.5f * (fx - 0.5f) * (fx - 0.5f)};
      float wy[3] = {0.5f * (1.5f - fy) * (1.5f - fy),
                     0.75f - (fy - 1.0f) * (fy - 1.0f),
                     0.5f * (fy - 0.5f) * (fy - 0.5f)};

      float vx = 0, vy = 0;
      Mat2 Cn = {0, 0, 0, 0};
      for (int i = 0; i < 3; i++) {
        for (int j = 0; j < 3; j++) {
          float dpx = i - fx, dpy = j - fy;
          const float *g = grid + 3 * ((bx + i) * ng + (by + j));
          float w = wx[i] * wy[j];
          vx += w * g[0];
          vy += w * g[1];
          Cn.a00 += 4 * inv_dx * (w * g[0]) * dpx;
          Cn.a01 += 4 * inv_dx * (w * g[0]) * dpy;
          Cn.a10 += 4 * inv_dx * (w * g[1]) * dpx;
          Cn.a11 += 4 * inv_dx * (w * g[1]) * dpy;
        }
      }
      v[2 * p] = vx;
      v[2 * p + 1] = vy;
      C[4 * p] = Cn.a00;
      C[4 * p + 1] = Cn.a01;
      C[4 * p + 2] = Cn.a10;
      C[4 * p + 3] = Cn.a11;
      x[2 * p] = px + prm->dt * vx;
      x[2 * p + 1] = py + prm->dt * vy;

      Mat2 Fp = {F[4 * p], F[4 * p + 1], F[4 * p + 2], F[4 * p + 3]};
      Mat2 ipc = {1 + prm->dt * Cn.a00, prm->dt * Cn.a01, prm->dt * Cn.a10,
                  1 + prm->dt * Cn.a11};
      Mat2 Ft = mul(ipc, Fp);
      Mat2 u2, v2;
      float sig[2];
      svd2(Ft, u2, sig, v2);
      if (prm->plastic) {
        for (int k = 0; k < 2; k++)
          sig[k] = std::min(std::max(sig[k], 1.0f - 2.5e-2f), 1.0f + 7.5e-3f);
      }
      float old_j = det(Ft);
      Mat2 us = {u2.a00 * sig[0], u2.a01 * sig[1], u2.a10 * sig[0],
                 u2.a11 * sig[1]};
      Mat2 Fn = mul(us, transposed(v2));
      float jp = Jp[p] * old_j / det(Fn);
      Jp[p] = std::min(std::max(jp, 0.6f), 20.0f);
      F[4 * p] = Fn.a00;
      F[4 * p + 1] = Fn.a01;
      F[4 * p + 2] = Fn.a10;
      F[4 * p + 3] = Fn.a11;
    }
  }

  if (own) delete[] grid;
}

}  // extern "C"
