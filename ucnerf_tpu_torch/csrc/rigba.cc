// Rig bundle adjustment: compact Levenberg-Marquardt with point-Schur.
//
// Native replacement for the two COLMAP verbs UC-NeRF's pose-refinement
// pipeline actually uses (the reference's pose_refinement/stpr):
//  - rig bundle adjustment (optim/bundle_adjustment.cc:795-1074): per-snapshot
//    rig pose composed with per-camera rig-relative pose, reprojection
//    residuals, with the UC-NeRF option `fix_trans_refine_rot`
//    (bundle_adjustment.h:276, cc:1055-1061): hold relative translations
//    constant while refining relative rotations.
//  - multi-view triangulation with fixed poses (exe/sfm.cc:339).
//
// No Ceres: the normal equations are built analytically and the point blocks
// are eliminated by a Schur complement, leaving a dense reduced camera system
// (a few hundred parameters for 80 snapshots x 5 cameras) solved by Cholesky.
//
// Conventions (COLMAP): poses are world-to-frame, rotation as unit quaternion
// (w, x, y, z).  Camera projection: x_cam = q_rel * (q_rig * X + t_rig) +
// t_rel; uv = (fx * x/z + cx, fy * y/z + cy).  Rotation increments are
// left-multiplied axis-angle deltas.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }

struct Quat {
  double w, x, y, z;
};

inline Quat normalize(Quat q) {
  double n = std::sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n < 1e-12) return {1, 0, 0, 0};
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

inline Quat qmul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// Rotate vector by quaternion.
inline Vec3 qrot(Quat q, Vec3 v) {
  // v' = v + 2w(u x v) + 2(u x (u x v)), u = (x, y, z)
  Vec3 u{q.x, q.y, q.z};
  Vec3 uv{u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x};
  Vec3 uuv{u.y * uv.z - u.z * uv.y, u.z * uv.x - u.x * uv.z,
           u.x * uv.y - u.y * uv.x};
  return v + 2.0 * q.w * uv + 2.0 * uuv;
}

// Exp map: axis-angle -> quaternion.
inline Quat qexp(const double* w) {
  double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double theta = std::sqrt(theta2);
  double s;
  if (theta < 1e-8) {
    s = 0.5 - theta2 / 48.0;
  } else {
    s = std::sin(theta / 2) / theta;
  }
  return normalize({std::cos(theta / 2), s * w[0], s * w[1], s * w[2]});
}

// 3x3 rotation matrix from quaternion (row-major).
inline void qmat(Quat q, double R[9]) {
  double w = q.w, x = q.x, y = q.y, z = q.z;
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

inline Vec3 matvec(const double R[9], Vec3 v) {
  return {R[0] * v.x + R[1] * v.y + R[2] * v.z,
          R[3] * v.x + R[4] * v.y + R[5] * v.z,
          R[6] * v.x + R[7] * v.y + R[8] * v.z};
}

// Dense symmetric-positive-definite solve via Cholesky (in-place, n x n).
bool cholesky_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
    if (d <= 1e-14) return false;
    d = std::sqrt(d);
    A[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s / d;
    }
  }
  // Forward substitution L y = b.
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * n + k] * b[k];
    b[i] = s / A[i * n + i];
  }
  // Back substitution L^T x = y.
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= A[k * n + i] * b[k];
    b[i] = s / A[i * n + i];
  }
  return true;
}

struct Problem {
  int num_snapshots, num_cameras, num_points, num_obs;
  double* rig_q;   // [S,4]
  double* rig_t;   // [S,3]
  double* rel_q;   // [C,4]
  double* rel_t;   // [C,3]
  double* pts;     // [P,3]
  const double* K;  // [C,4] fx fy cx cy
  const int* o_snap;
  const int* o_cam;
  const int* o_pt;
  const double* o_xy;
  bool fix_rig, fix_rel_rot, fix_rel_trans, fix_points;
  int ref_camera;  // reference camera: relative pose held constant
  double huber;    // Huber loss delta in pixels (<=0: squared loss)
};

// Residual + Jacobians for one observation.  Jc: [2 x 12] w.r.t.
// (rig_rot, rig_trans, rel_rot, rel_trans); Jp: [2 x 3] w.r.t. point.
bool evaluate(const Problem& P, int i, double r[2], double Jc[24],
              double Jp[6], double* wgt) {
  int s = P.o_snap[i], c = P.o_cam[i], p = P.o_pt[i];
  Quat qg{P.rig_q[4 * s], P.rig_q[4 * s + 1], P.rig_q[4 * s + 2],
          P.rig_q[4 * s + 3]};
  Quat qr{P.rel_q[4 * c], P.rel_q[4 * c + 1], P.rel_q[4 * c + 2],
          P.rel_q[4 * c + 3]};
  Vec3 tg{P.rig_t[3 * s], P.rig_t[3 * s + 1], P.rig_t[3 * s + 2]};
  Vec3 tr{P.rel_t[3 * c], P.rel_t[3 * c + 1], P.rel_t[3 * c + 2]};
  Vec3 X{P.pts[3 * p], P.pts[3 * p + 1], P.pts[3 * p + 2]};

  Vec3 p_rig = qrot(qg, X) + tg;
  Vec3 p_cam = qrot(qr, p_rig) + tr;
  if (p_cam.z < 1e-6) return false;  // behind camera

  double fx = P.K[4 * c], fy = P.K[4 * c + 1];
  double cx = P.K[4 * c + 2], cy = P.K[4 * c + 3];
  double iz = 1.0 / p_cam.z;
  double u = fx * p_cam.x * iz + cx;
  double v = fy * p_cam.y * iz + cy;
  r[0] = u - P.o_xy[2 * i];
  r[1] = v - P.o_xy[2 * i + 1];

  // Robust weight (IRLS sqrt of rho' at squared norm).
  double e2 = r[0] * r[0] + r[1] * r[1];
  *wgt = 1.0;
  if (P.huber > 0) {
    double e = std::sqrt(e2);
    if (e > P.huber) *wgt = std::sqrt(P.huber / e);
  }

  if (Jc == nullptr) return true;

  // d(uv)/d(p_cam), [2x3].
  double Jproj[6] = {fx * iz, 0, -fx * p_cam.x * iz * iz,
                     0, fy * iz, -fy * p_cam.y * iz * iz};
  double Rr[9], Rg[9];
  qmat(qr, Rr);
  qmat(qg, Rg);

  // Helper: Jout[2x3] = Jproj * M[3x3].
  auto proj_mul = [&](const double M[9], double* out) {
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 3; ++b)
        out[a * 3 + b] = Jproj[a * 3 + 0] * M[0 * 3 + b] +
                         Jproj[a * 3 + 1] * M[1 * 3 + b] +
                         Jproj[a * 3 + 2] * M[2 * 3 + b];
  };

  // d p_cam / d delta_rel = -[R_rel p_rig]x ; d p_cam / d t_rel = I.
  Vec3 rp = qrot(qr, p_rig);
  double skew_rp[9] = {0, -rp.z, rp.y, rp.z, 0, -rp.x, -rp.y, rp.x, 0};
  double neg_skew_rp[9];
  for (int k = 0; k < 9; ++k) neg_skew_rp[k] = -skew_rp[k];

  // d p_cam / d delta_rig = R_rel * (-[R_rig X]x); d p_cam / d t_rig = R_rel.
  Vec3 gX = qrot(qg, X);
  double skew_gX[9] = {0, -gX.z, gX.y, gX.z, 0, -gX.x, -gX.y, gX.x, 0};
  double RrSkew[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      RrSkew[a * 3 + b] = 0;
      for (int k = 0; k < 3; ++k)
        RrSkew[a * 3 + b] += Rr[a * 3 + k] * (-skew_gX[k * 3 + b]);
    }

  // d p_cam / d X = R_rel R_rig.
  double RrRg[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      RrRg[a * 3 + b] = 0;
      for (int k = 0; k < 3; ++k)
        RrRg[a * 3 + b] += Rr[a * 3 + k] * Rg[k * 3 + b];
    }

  double tmp[6];
  // Columns 0-2: rig rotation.
  proj_mul(RrSkew, tmp);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 3; ++b) Jc[a * 12 + b] = tmp[a * 3 + b];
  // Columns 3-5: rig translation (Jproj * R_rel).
  proj_mul(Rr, tmp);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 3; ++b) Jc[a * 12 + 3 + b] = tmp[a * 3 + b];
  // Columns 6-8: rel rotation.
  proj_mul(neg_skew_rp, tmp);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 3; ++b) Jc[a * 12 + 6 + b] = tmp[a * 3 + b];
  // Columns 9-11: rel translation (Jproj * I).
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 3; ++b) Jc[a * 12 + 9 + b] = Jproj[a * 3 + b];
  // Point Jacobian.
  proj_mul(RrRg, Jp);
  return true;
}

double total_cost(const Problem& P) {
  double cost = 0;
  double r[2], w;
  for (int i = 0; i < P.num_obs; ++i) {
    if (!evaluate(P, i, r, nullptr, nullptr, &w)) continue;
    double e2 = r[0] * r[0] + r[1] * r[1];
    if (P.huber > 0) {
      double e = std::sqrt(e2);
      cost += (e <= P.huber) ? 0.5 * e2 : P.huber * (e - 0.5 * P.huber);
    } else {
      cost += 0.5 * e2;
    }
  }
  return cost;
}

}  // namespace

extern "C" {

// Solve the rig bundle adjustment.  Returns 0 on success.
int rigba_solve(int num_snapshots, int num_cameras, int num_points,
                int num_obs, double* rig_qvecs, double* rig_tvecs,
                double* rel_qvecs, double* rel_tvecs, double* points,
                const double* intrinsics, const int* obs_snapshot,
                const int* obs_camera, const int* obs_point,
                const double* obs_xy, int fix_rig_poses, int fix_rel_rot,
                int fix_rel_trans, int fix_points, int ref_camera,
                int max_iterations, double huber_delta, int verbose,
                double* final_cost) {
  Problem P{num_snapshots, num_cameras, num_points, num_obs,
            rig_qvecs,     rig_tvecs,   rel_qvecs,  rel_tvecs,
            points,        intrinsics,  obs_snapshot, obs_camera,
            obs_point,     obs_xy,
            fix_rig_poses != 0, fix_rel_rot != 0, fix_rel_trans != 0,
            fix_points != 0, ref_camera, huber_delta};

  // Camera-parameter layout in the reduced system.
  const int rig_params = P.fix_rig ? 0 : 6;
  int rel_params = 0;
  if (!P.fix_rel_rot) rel_params += 3;
  if (!P.fix_rel_trans) rel_params += 3;
  const int n_cam = rig_params * num_snapshots + rel_params * num_cameras;
  auto rig_off = [&](int s) { return rig_params * s; };
  auto rel_off = [&](int c) {
    return rig_params * num_snapshots + rel_params * c;
  };

  double lambda = 1e-4;
  double cost = total_cost(P);
  if (verbose) std::fprintf(stderr, "rigba: initial cost %.6f\n", cost);

  std::vector<double> S(static_cast<size_t>(n_cam) * n_cam);
  std::vector<double> g(n_cam);
  std::vector<double> Hpp(num_points * 9), bp(num_points * 3);
  // Per-point camera coupling is accumulated densely into S via the Schur
  // trick observation-by-observation: we need, per point, the list of
  // W = H_cp blocks.  Store per-observation Jacobians grouped by point.
  std::vector<int> point_obs_start(num_points + 1, 0);
  std::vector<int> obs_by_point(num_obs);
  {
    std::vector<int> cnt(num_points, 0);
    for (int i = 0; i < num_obs; ++i) cnt[obs_point[i]]++;
    for (int p = 0; p < num_points; ++p)
      point_obs_start[p + 1] = point_obs_start[p] + cnt[p];
    std::vector<int> cur(point_obs_start.begin(), point_obs_start.end() - 1);
    for (int i = 0; i < num_obs; ++i) obs_by_point[i] = 0;
    for (int i = 0; i < num_obs; ++i) obs_by_point[cur[obs_point[i]]++] = i;
  }

  std::vector<double> backup_rig_q(rig_qvecs, rig_qvecs + 4 * num_snapshots);
  std::vector<double> backup_rig_t(rig_tvecs, rig_tvecs + 3 * num_snapshots);
  std::vector<double> backup_rel_q(rel_qvecs, rel_qvecs + 4 * num_cameras);
  std::vector<double> backup_rel_t(rel_tvecs, rel_tvecs + 3 * num_cameras);
  std::vector<double> backup_pts(points, points + 3 * num_points);

  for (int iter = 0; iter < max_iterations; ++iter) {
    std::fill(S.begin(), S.end(), 0.0);
    std::fill(g.begin(), g.end(), 0.0);
    std::fill(Hpp.begin(), Hpp.end(), 0.0);
    std::fill(bp.begin(), bp.end(), 0.0);

    // Pass 1: accumulate camera-camera, point-point and gradient terms;
    // store per-observation (Jc, Jp, r) for the Schur coupling.
    std::vector<double> all_Jc(static_cast<size_t>(num_obs) * 24);
    std::vector<double> all_Jp(static_cast<size_t>(num_obs) * 6);
    std::vector<double> all_r(static_cast<size_t>(num_obs) * 2);
    std::vector<char> ok(num_obs, 0);

    // Map from full 12-col Jc to active camera columns for this config.
    int col_map[12];
    {
      int q = 0;
      for (int k = 0; k < 6; ++k) col_map[k] = P.fix_rig ? -1 : q++;
      int rel_base = 0;  // within rel block
      for (int k = 6; k < 9; ++k)
        col_map[k] = P.fix_rel_rot ? -1 : rel_base++;
      for (int k = 9; k < 12; ++k)
        col_map[k] = P.fix_rel_trans ? -1 : rel_base++;
    }

    for (int i = 0; i < num_obs; ++i) {
      double* Jc = &all_Jc[24 * i];
      double* Jp = &all_Jp[6 * i];
      double* r = &all_r[2 * i];
      double w;
      if (!evaluate(P, i, r, Jc, Jp, &w)) continue;
      ok[i] = 1;
      for (int k = 0; k < 24; ++k) Jc[k] *= w;
      for (int k = 0; k < 6; ++k) Jp[k] *= w;
      r[0] *= w;
      r[1] *= w;

      int s = obs_snapshot[i], c = obs_camera[i], p = obs_point[i];
      bool rel_const = (c == ref_camera);

      // Active global columns for this observation.
      int cols[12];
      for (int k = 0; k < 6; ++k)
        cols[k] = (col_map[k] < 0) ? -1 : rig_off(s) + col_map[k];
      for (int k = 6; k < 12; ++k)
        cols[k] = (col_map[k] < 0 || rel_const) ? -1
                                                : rel_off(c) + col_map[k];

      for (int a = 0; a < 12; ++a) {
        if (cols[a] < 0) continue;
        for (int b = 0; b < 12; ++b) {
          if (cols[b] < 0) continue;
          S[static_cast<size_t>(cols[a]) * n_cam + cols[b]] +=
              Jc[0 * 12 + a] * Jc[0 * 12 + b] + Jc[1 * 12 + a] * Jc[1 * 12 + b];
        }
        g[cols[a]] -= Jc[0 * 12 + a] * r[0] + Jc[1 * 12 + a] * r[1];
      }
      if (!P.fix_points) {
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b)
            Hpp[9 * p + 3 * a + b] +=
                Jp[0 * 3 + a] * Jp[0 * 3 + b] + Jp[1 * 3 + a] * Jp[1 * 3 + b];
          bp[3 * p + a] -= Jp[0 * 3 + a] * r[0] + Jp[1 * 3 + a] * r[1];
        }
      }
    }

    // LM damping.  Parameter columns with no residuals (e.g. the reference
    // camera's relative pose) get a unit diagonal so the Cholesky stays
    // positive definite; their gradient is zero, so their update is zero.
    for (int d = 0; d < n_cam; ++d) {
      double& diag = S[static_cast<size_t>(d) * n_cam + d];
      if (diag == 0.0) diag = 1.0;
      diag *= (1.0 + lambda);
    }
    std::vector<double> Hpp_inv(num_points * 9, 0.0);
    if (!P.fix_points) {
      for (int p = 0; p < num_points; ++p) {
        double M[9];
        std::memcpy(M, &Hpp[9 * p], sizeof(M));
        for (int d = 0; d < 3; ++d) M[3 * d + d] *= (1.0 + lambda);
        // 3x3 inverse.
        double det = M[0] * (M[4] * M[8] - M[5] * M[7]) -
                     M[1] * (M[3] * M[8] - M[5] * M[6]) +
                     M[2] * (M[3] * M[7] - M[4] * M[6]);
        if (std::fabs(det) < 1e-12) continue;
        double inv[9] = {
            (M[4] * M[8] - M[5] * M[7]), -(M[1] * M[8] - M[2] * M[7]),
            (M[1] * M[5] - M[2] * M[4]), -(M[3] * M[8] - M[5] * M[6]),
            (M[0] * M[8] - M[2] * M[6]), -(M[0] * M[5] - M[2] * M[3]),
            (M[3] * M[7] - M[4] * M[6]), -(M[0] * M[7] - M[1] * M[6]),
            (M[0] * M[4] - M[1] * M[3])};
        for (int k = 0; k < 9; ++k) Hpp_inv[9 * p + k] = inv[k] / det;
      }

      // Pass 2 (Schur): S -= W Hpp^-1 W^T, g -= W Hpp^-1 bp, per point.
      for (int p = 0; p < num_points; ++p) {
        int lo = point_obs_start[p], hi = point_obs_start[p + 1];
        const double* Hi = &Hpp_inv[9 * p];
        // y = Hpp^-1 bp.
        double y[3] = {
            Hi[0] * bp[3 * p] + Hi[1] * bp[3 * p + 1] + Hi[2] * bp[3 * p + 2],
            Hi[3] * bp[3 * p] + Hi[4] * bp[3 * p + 1] + Hi[5] * bp[3 * p + 2],
            Hi[6] * bp[3 * p] + Hi[7] * bp[3 * p + 1] + Hi[8] * bp[3 * p + 2]};
        for (int oi = lo; oi < hi; ++oi) {
          int i = obs_by_point[oi];
          if (!ok[i]) continue;
          const double* Jc_i = &all_Jc[24 * i];
          const double* Jp_i = &all_Jp[6 * i];
          int s = obs_snapshot[i], c = obs_camera[i];
          bool rel_const_i = (c == ref_camera);
          int cols_i[12];
          for (int k = 0; k < 6; ++k)
            cols_i[k] = (col_map[k] < 0) ? -1 : rig_off(s) + col_map[k];
          for (int k = 6; k < 12; ++k)
            cols_i[k] = (col_map[k] < 0 || rel_const_i)
                            ? -1
                            : rel_off(c) + col_map[k];
          // W_i = Jc_i^T Jp_i (12x3).
          double Wi[36];
          for (int a = 0; a < 12; ++a)
            for (int b = 0; b < 3; ++b)
              Wi[a * 3 + b] = Jc_i[0 * 12 + a] * Jp_i[0 * 3 + b] +
                              Jc_i[1 * 12 + a] * Jp_i[1 * 3 + b];
          // g -= Wi y.
          for (int a = 0; a < 12; ++a) {
            if (cols_i[a] < 0) continue;
            g[cols_i[a]] -=
                Wi[a * 3] * y[0] + Wi[a * 3 + 1] * y[1] + Wi[a * 3 + 2] * y[2];
          }
          // S -= Wi Hpp^-1 Wj^T for all j sharing the point.
          double WiH[36];
          for (int a = 0; a < 12; ++a)
            for (int b = 0; b < 3; ++b)
              WiH[a * 3 + b] = Wi[a * 3] * Hi[b] + Wi[a * 3 + 1] * Hi[3 + b] +
                               Wi[a * 3 + 2] * Hi[6 + b];
          for (int oj = lo; oj < hi; ++oj) {
            int j = obs_by_point[oj];
            if (!ok[j]) continue;
            const double* Jc_j = &all_Jc[24 * j];
            const double* Jp_j = &all_Jp[6 * j];
            int sj = obs_snapshot[j], cj = obs_camera[j];
            bool rel_const_j = (cj == ref_camera);
            int cols_j[12];
            for (int k = 0; k < 6; ++k)
              cols_j[k] = (col_map[k] < 0) ? -1 : rig_off(sj) + col_map[k];
            for (int k = 6; k < 12; ++k)
              cols_j[k] = (col_map[k] < 0 || rel_const_j)
                              ? -1
                              : rel_off(cj) + col_map[k];
            double Wj[36];
            for (int a = 0; a < 12; ++a)
              for (int b = 0; b < 3; ++b)
                Wj[a * 3 + b] = Jc_j[0 * 12 + a] * Jp_j[0 * 3 + b] +
                                Jc_j[1 * 12 + a] * Jp_j[1 * 3 + b];
            for (int a = 0; a < 12; ++a) {
              if (cols_i[a] < 0) continue;
              for (int b = 0; b < 12; ++b) {
                if (cols_j[b] < 0) continue;
                S[static_cast<size_t>(cols_i[a]) * n_cam + cols_j[b]] -=
                    WiH[a * 3] * Wj[b * 3] + WiH[a * 3 + 1] * Wj[b * 3 + 1] +
                    WiH[a * 3 + 2] * Wj[b * 3 + 2];
              }
            }
          }
        }
      }
    }

    // Solve the reduced camera system.
    std::vector<double> S_ch = S;
    std::vector<double> dx = g;
    bool solved = n_cam == 0 || cholesky_solve(S_ch, dx, n_cam);
    if (!solved) {
      lambda *= 10;
      if (verbose)
        std::fprintf(stderr, "rigba: iter %d cholesky failed, lambda=%g\n",
                     iter, lambda);
      continue;
    }

    // Back-substitute points: dp = Hpp^-1 (bp - W^T dx).
    std::vector<double> dp(3 * num_points, 0.0);
    if (!P.fix_points) {
      std::vector<double> rhs(bp);
      for (int i = 0; i < num_obs; ++i) {
        if (!ok[i]) continue;
        const double* Jc_i = &all_Jc[24 * i];
        const double* Jp_i = &all_Jp[6 * i];
        int s = obs_snapshot[i], c = obs_camera[i], p = obs_point[i];
        bool rel_const_i = (c == ref_camera);
        int cols_i[12];
        for (int k = 0; k < 6; ++k)
          cols_i[k] = (col_map[k] < 0) ? -1 : rig_off(s) + col_map[k];
        for (int k = 6; k < 12; ++k)
          cols_i[k] = (col_map[k] < 0 || rel_const_i) ? -1
                                                      : rel_off(c) + col_map[k];
        double Jcdx[2] = {0, 0};
        for (int a = 0; a < 12; ++a) {
          if (cols_i[a] < 0) continue;
          Jcdx[0] += Jc_i[0 * 12 + a] * dx[cols_i[a]];
          Jcdx[1] += Jc_i[1 * 12 + a] * dx[cols_i[a]];
        }
        for (int b = 0; b < 3; ++b)
          rhs[3 * p + b] -=
              Jp_i[0 * 3 + b] * Jcdx[0] + Jp_i[1 * 3 + b] * Jcdx[1];
      }
      for (int p = 0; p < num_points; ++p) {
        const double* Hi = &Hpp_inv[9 * p];
        for (int a = 0; a < 3; ++a)
          dp[3 * p + a] = Hi[3 * a] * rhs[3 * p] + Hi[3 * a + 1] * rhs[3 * p + 1] +
                          Hi[3 * a + 2] * rhs[3 * p + 2];
      }
    }

    // Apply the update (to trial state).
    std::memcpy(backup_rig_q.data(), rig_qvecs, 4 * num_snapshots * 8);
    std::memcpy(backup_rig_t.data(), rig_tvecs, 3 * num_snapshots * 8);
    std::memcpy(backup_rel_q.data(), rel_qvecs, 4 * num_cameras * 8);
    std::memcpy(backup_rel_t.data(), rel_tvecs, 3 * num_cameras * 8);
    std::memcpy(backup_pts.data(), points, 3 * num_points * 8);

    if (!P.fix_rig) {
      for (int s = 0; s < num_snapshots; ++s) {
        const double* d = &dx[rig_off(s)];
        Quat dq = qexp(d);
        Quat q{rig_qvecs[4 * s], rig_qvecs[4 * s + 1], rig_qvecs[4 * s + 2],
               rig_qvecs[4 * s + 3]};
        Quat qn = normalize(qmul(dq, q));
        rig_qvecs[4 * s] = qn.w;
        rig_qvecs[4 * s + 1] = qn.x;
        rig_qvecs[4 * s + 2] = qn.y;
        rig_qvecs[4 * s + 3] = qn.z;
        for (int k = 0; k < 3; ++k) rig_tvecs[3 * s + k] += d[3 + k];
      }
    }
    for (int c = 0; c < num_cameras; ++c) {
      if (c == ref_camera) continue;
      const double* d = &dx[rel_off(c)];
      int q_idx = 0;
      if (!P.fix_rel_rot) {
        Quat dq = qexp(d);
        Quat q{rel_qvecs[4 * c], rel_qvecs[4 * c + 1], rel_qvecs[4 * c + 2],
               rel_qvecs[4 * c + 3]};
        Quat qn = normalize(qmul(dq, q));
        rel_qvecs[4 * c] = qn.w;
        rel_qvecs[4 * c + 1] = qn.x;
        rel_qvecs[4 * c + 2] = qn.y;
        rel_qvecs[4 * c + 3] = qn.z;
        q_idx = 3;
      }
      if (!P.fix_rel_trans)
        for (int k = 0; k < 3; ++k) rel_tvecs[3 * c + k] += d[q_idx + k];
    }
    if (!P.fix_points)
      for (int k = 0; k < 3 * num_points; ++k) points[k] += dp[k];

    double new_cost = total_cost(P);
    if (new_cost < cost) {
      cost = new_cost;
      lambda = std::max(lambda / 3.0, 1e-10);
      if (verbose)
        std::fprintf(stderr, "rigba: iter %d cost %.6f lambda %g\n", iter,
                     cost, lambda);
    } else {
      // Revert.
      std::memcpy(rig_qvecs, backup_rig_q.data(), 4 * num_snapshots * 8);
      std::memcpy(rig_tvecs, backup_rig_t.data(), 3 * num_snapshots * 8);
      std::memcpy(rel_qvecs, backup_rel_q.data(), 4 * num_cameras * 8);
      std::memcpy(rel_tvecs, backup_rel_t.data(), 3 * num_cameras * 8);
      std::memcpy(points, backup_pts.data(), 3 * num_points * 8);
      lambda *= 10;
      if (lambda > 1e8) break;
      if (verbose)
        std::fprintf(stderr, "rigba: iter %d rejected, lambda %g\n", iter,
                     lambda);
    }
  }

  if (final_cost) *final_cost = cost;
  return 0;
}

// Multi-view DLT triangulation with fixed poses.  For each track (a range of
// observations), solves for the 3D point minimizing algebraic error, then
// filters by reprojection error.  Returns number of successful points.
int rigba_triangulate(int num_points, int num_obs, const int* obs_snapshot,
                      const int* obs_camera, const int* obs_point,
                      const double* obs_xy, const double* rig_qvecs,
                      const double* rig_tvecs, const double* rel_qvecs,
                      const double* rel_tvecs, const double* intrinsics,
                      int num_snapshots, int num_cameras, double max_error,
                      double* points_out, unsigned char* valid_out) {
  (void)num_snapshots;
  (void)num_cameras;
  // Group observations per point.
  std::vector<std::vector<int>> per_point(num_points);
  for (int i = 0; i < num_obs; ++i) per_point[obs_point[i]].push_back(i);

  int n_ok = 0;
  for (int p = 0; p < num_points; ++p) {
    valid_out[p] = 0;
    const auto& obs = per_point[p];
    if (obs.size() < 2) continue;
    // Normal equations of the DLT system A X = b with rows from
    // x * P3 - P1, y * P3 - P2 (world-to-cam projective rows).
    double AtA[9] = {0}, Atb[3] = {0};
    for (int i : obs) {
      int s = obs_snapshot[i], c = obs_camera[i];
      Quat qg{rig_qvecs[4 * s], rig_qvecs[4 * s + 1], rig_qvecs[4 * s + 2],
              rig_qvecs[4 * s + 3]};
      Quat qr{rel_qvecs[4 * c], rel_qvecs[4 * c + 1], rel_qvecs[4 * c + 2],
              rel_qvecs[4 * c + 3]};
      Quat q = normalize(qmul(qr, qg));
      double R[9];
      qmat(q, R);
      Vec3 tg{rig_tvecs[3 * s], rig_tvecs[3 * s + 1], rig_tvecs[3 * s + 2]};
      Vec3 tr{rel_tvecs[3 * c], rel_tvecs[3 * c + 1], rel_tvecs[3 * c + 2]};
      Vec3 t = qrot(qr, tg) + tr;  // combined world-to-cam translation
      double fx = intrinsics[4 * c], fy = intrinsics[4 * c + 1];
      double cx = intrinsics[4 * c + 2], cy = intrinsics[4 * c + 3];
      double xn = (obs_xy[2 * i] - cx) / fx;
      double yn = (obs_xy[2 * i + 1] - cy) / fy;
      // Rows: xn * R3 - R1, yn * R3 - R2 (with matching rhs from t).
      double rows[2][3], rhs[2];
      for (int k = 0; k < 3; ++k) {
        rows[0][k] = xn * R[6 + k] - R[0 + k];
        rows[1][k] = yn * R[6 + k] - R[3 + k];
      }
      rhs[0] = t.x - xn * t.z;
      rhs[1] = t.y - yn * t.z;
      for (int rr = 0; rr < 2; ++rr)
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b)
            AtA[3 * a + b] += rows[rr][a] * rows[rr][b];
          Atb[a] += rows[rr][a] * rhs[rr];
        }
    }
    double det = AtA[0] * (AtA[4] * AtA[8] - AtA[5] * AtA[7]) -
                 AtA[1] * (AtA[3] * AtA[8] - AtA[5] * AtA[6]) +
                 AtA[2] * (AtA[3] * AtA[7] - AtA[4] * AtA[6]);
    if (std::fabs(det) < 1e-12) continue;
    double inv[9] = {(AtA[4] * AtA[8] - AtA[5] * AtA[7]),
                     -(AtA[1] * AtA[8] - AtA[2] * AtA[7]),
                     (AtA[1] * AtA[5] - AtA[2] * AtA[4]),
                     -(AtA[3] * AtA[8] - AtA[5] * AtA[6]),
                     (AtA[0] * AtA[8] - AtA[2] * AtA[6]),
                     -(AtA[0] * AtA[5] - AtA[2] * AtA[3]),
                     (AtA[3] * AtA[7] - AtA[4] * AtA[6]),
                     -(AtA[0] * AtA[7] - AtA[1] * AtA[6]),
                     (AtA[0] * AtA[4] - AtA[1] * AtA[3])};
    Vec3 X{(inv[0] * Atb[0] + inv[1] * Atb[1] + inv[2] * Atb[2]) / det,
           (inv[3] * Atb[0] + inv[4] * Atb[1] + inv[5] * Atb[2]) / det,
           (inv[6] * Atb[0] + inv[7] * Atb[1] + inv[8] * Atb[2]) / det};

    // Reprojection check over all observations.
    bool all_ok = true;
    for (int i : obs) {
      int s = obs_snapshot[i], c = obs_camera[i];
      Quat qg{rig_qvecs[4 * s], rig_qvecs[4 * s + 1], rig_qvecs[4 * s + 2],
              rig_qvecs[4 * s + 3]};
      Quat qr{rel_qvecs[4 * c], rel_qvecs[4 * c + 1], rel_qvecs[4 * c + 2],
              rel_qvecs[4 * c + 3]};
      Vec3 tg{rig_tvecs[3 * s], rig_tvecs[3 * s + 1], rig_tvecs[3 * s + 2]};
      Vec3 tr{rel_tvecs[3 * c], rel_tvecs[3 * c + 1], rel_tvecs[3 * c + 2]};
      Vec3 pc = qrot(qr, qrot(qg, X) + tg) + tr;
      if (pc.z < 1e-6) {
        all_ok = false;
        break;
      }
      double fx = intrinsics[4 * c], fy = intrinsics[4 * c + 1];
      double cx = intrinsics[4 * c + 2], cy = intrinsics[4 * c + 3];
      double du = fx * pc.x / pc.z + cx - obs_xy[2 * i];
      double dv = fy * pc.y / pc.z + cy - obs_xy[2 * i + 1];
      if (du * du + dv * dv > max_error * max_error) {
        all_ok = false;
        break;
      }
    }
    points_out[3 * p] = X.x;
    points_out[3 * p + 1] = X.y;
    points_out[3 * p + 2] = X.z;
    valid_out[p] = all_ok ? 1 : 0;
    n_ok += all_ok;
  }
  return n_ok;
}

}  // extern "C"
