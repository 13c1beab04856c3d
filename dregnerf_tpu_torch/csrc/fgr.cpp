// Fast Global Registration (FGR) — native C++ classical-registration baseline.
//
// Open3D replacement for the reference's FPFH + FGR pipeline
// (conerf/geometry/global_registration.py:69-116): voxel downsample ->
// normal estimation -> FPFH features -> reciprocal nearest-neighbor
// correspondences with tuple test -> graduated non-convexity over a scaled
// Geman-McClure objective solved by Gauss-Newton on se(3).
//
// Exposed as a C ABI for ctypes (dregnerf_tpu/registration/fgr.py). Host
// CPU only — this is the evaluation baseline, not on the TPU path.
//
// References: Zhou, Park, Koltun, "Fast Global Registration", ECCV 2016;
// Rusu et al., "Fast Point Feature Histograms", ICRA 2009.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3 &o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3 &o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
  Vec3 normalized() const {
    double n = norm();
    return n > 1e-12 ? Vec3{x / n, y / n, z / n} : Vec3{0, 0, 1};
  }
};

// ---------------------------------------------------------------- grid hash
struct GridHash {
  double cell;
  std::unordered_map<uint64_t, std::vector<int>> cells;
  const std::vector<Vec3> *pts;

  static uint64_t key(int64_t ix, int64_t iy, int64_t iz) {
    return (uint64_t(ix & 0x1FFFFF) << 42) | (uint64_t(iy & 0x1FFFFF) << 21) |
           uint64_t(iz & 0x1FFFFF);
  }

  void build(const std::vector<Vec3> &points, double cell_size) {
    pts = &points;
    cell = cell_size;
    cells.clear();
    for (int i = 0; i < (int)points.size(); ++i) {
      const Vec3 &p = points[i];
      cells[key((int64_t)std::floor(p.x / cell), (int64_t)std::floor(p.y / cell),
                (int64_t)std::floor(p.z / cell))]
          .push_back(i);
    }
  }

  // indices within radius r (r should be <= cell for the 27-cell sweep)
  void radius(const Vec3 &q, double r, std::vector<int> &out) const {
    out.clear();
    int64_t cx = (int64_t)std::floor(q.x / cell);
    int64_t cy = (int64_t)std::floor(q.y / cell);
    int64_t cz = (int64_t)std::floor(q.z / cell);
    int64_t reach = (int64_t)std::ceil(r / cell);
    double r2 = r * r;
    for (int64_t dx = -reach; dx <= reach; ++dx)
      for (int64_t dy = -reach; dy <= reach; ++dy)
        for (int64_t dz = -reach; dz <= reach; ++dz) {
          auto it = cells.find(key(cx + dx, cy + dy, cz + dz));
          if (it == cells.end()) continue;
          for (int i : it->second) {
            Vec3 d = (*pts)[i] - q;
            if (d.dot(d) <= r2) out.push_back(i);
          }
        }
  }
};

// ------------------------------------------------------------- downsample
std::vector<Vec3> voxel_downsample(const double *xyz, int n, double voxel) {
  std::unordered_map<uint64_t, std::pair<Vec3, int>> acc;
  acc.reserve(n);
  for (int i = 0; i < n; ++i) {
    Vec3 p{xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
    uint64_t k = GridHash::key((int64_t)std::floor(p.x / voxel),
                               (int64_t)std::floor(p.y / voxel),
                               (int64_t)std::floor(p.z / voxel));
    auto &slot = acc[k];
    slot.first = slot.first + p;
    slot.second += 1;
  }
  std::vector<Vec3> out;
  out.reserve(acc.size());
  for (auto &kv : acc) out.push_back(kv.second.first * (1.0 / kv.second.second));
  return out;
}

// ----------------------------------------------------------------- normals
//
// Normal SIGN must be deterministic and rigid-transform covariant: the
// Jacobi eigenvector sign is numerically arbitrary, so without an
// orientation rule ~half the (src, tgt) counterpart normals flip relative
// to each other after a rotation, scrambling the FPFH Darboux angles and
// the correspondences (measured: 24.6 deg FGR error on IDENTICAL clouds).
// Rule: point the normal AWAY from the local neighborhood mean — outward
// on shell-like clouds (exactly what NeRF voxel extractions are), fully
// local, covariant. Fallback when the local cue is degenerate (flat
// patch): away from the cloud centroid.
std::vector<Vec3> estimate_normals(const std::vector<Vec3> &pts,
                                   const GridHash &grid, double radius) {
  std::vector<Vec3> normals(pts.size());
  std::vector<int> nbr;
  Vec3 centroid{0, 0, 0};
  for (const Vec3 &p : pts) centroid = centroid + p;
  if (!pts.empty()) centroid = centroid * (1.0 / pts.size());
  for (size_t i = 0; i < pts.size(); ++i) {
    grid.radius(pts[i], radius, nbr);
    if (nbr.size() < 3) {
      normals[i] = {0, 0, 1};
      continue;
    }
    Vec3 mean{0, 0, 0};
    for (int j : nbr) mean = mean + pts[j];
    mean = mean * (1.0 / nbr.size());
    double C[6] = {0, 0, 0, 0, 0, 0};  // xx xy xz yy yz zz
    for (int j : nbr) {
      Vec3 d = pts[j] - mean;
      C[0] += d.x * d.x; C[1] += d.x * d.y; C[2] += d.x * d.z;
      C[3] += d.y * d.y; C[4] += d.y * d.z; C[5] += d.z * d.z;
    }
    // smallest-eigenvector via inverse power iteration on (C + eps I)^-1 ~
    // use explicit 3x3 eigen decomposition (Jacobi, few sweeps)
    double A[3][3] = {{C[0], C[1], C[2]}, {C[1], C[3], C[4]}, {C[2], C[4], C[5]}};
    double V[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
    for (int sweep = 0; sweep < 12; ++sweep) {
      for (int p = 0; p < 2; ++p)
        for (int q = p + 1; q < 3; ++q) {
          if (std::fabs(A[p][q]) < 1e-15) continue;
          double theta = 0.5 * std::atan2(2 * A[p][q], A[q][q] - A[p][p]);
          double c = std::cos(theta), s = std::sin(theta);
          for (int k = 0; k < 3; ++k) {
            double apk = A[p][k], aqk = A[q][k];
            A[p][k] = c * apk - s * aqk;
            A[q][k] = s * apk + c * aqk;
          }
          for (int k = 0; k < 3; ++k) {
            double akp = A[k][p], akq = A[k][q];
            A[k][p] = c * akp - s * akq;
            A[k][q] = s * akp + c * akq;
            double vkp = V[k][p], vkq = V[k][q];
            V[k][p] = c * vkp - s * vkq;
            V[k][q] = s * vkp + c * vkq;
          }
        }
    }
    int mi = 0;
    double mv = A[0][0];
    for (int k = 1; k < 3; ++k)
      if (A[k][k] < mv) { mv = A[k][k]; mi = k; }
    Vec3 n = Vec3{V[0][mi], V[1][mi], V[2][mi]}.normalized();
    Vec3 local = pts[i] - mean;
    double cue = n.dot(local);
    if (std::fabs(cue) < 1e-3 * radius) cue = n.dot(pts[i] - centroid);
    if (cue < 0) n = n * -1.0;
    normals[i] = n;
  }
  return normals;
}

// -------------------------------------------------------------------- FPFH
// 33-dim FPFH: 3 x 11-bin histograms of (alpha, phi, theta) Darboux angles,
// SPFH weighted-summed over neighbors.
void compute_spfh(const std::vector<Vec3> &pts, const std::vector<Vec3> &normals,
                  const GridHash &grid, double radius,
                  std::vector<std::array<float, 33>> &spfh,
                  std::vector<std::vector<int>> &neighbors) {
  const int B = 11;
  spfh.assign(pts.size(), {});
  neighbors.assign(pts.size(), {});
  std::vector<int> nbr;
  for (size_t i = 0; i < pts.size(); ++i) {
    grid.radius(pts[i], radius, nbr);
    auto &h = spfh[i];
    int cnt = 0;
    for (int j : nbr) {
      if ((size_t)j == i) continue;
      neighbors[i].push_back(j);
      Vec3 d = pts[j] - pts[i];
      double dist = d.norm();
      if (dist < 1e-12) continue;
      Vec3 dn = d * (1.0 / dist);
      const Vec3 &n1 = normals[i], &n2 = normals[j];
      Vec3 u = n1;
      Vec3 v = dn.cross(u).normalized();
      Vec3 w = u.cross(v);
      double alpha = v.dot(n2);                       // [-1, 1]
      double phi = u.dot(dn);                         // [-1, 1]
      double theta = std::atan2(w.dot(n2), u.dot(n2));  // [-pi, pi]
      int b0 = std::min(B - 1, (int)((alpha + 1.0) * 0.5 * B));
      int b1 = std::min(B - 1, (int)((phi + 1.0) * 0.5 * B));
      int b2 = std::min(B - 1, (int)((theta + M_PI) / (2 * M_PI) * B));
      h[b0] += 1; h[B + b1] += 1; h[2 * B + b2] += 1;
      ++cnt;
    }
    if (cnt > 0)
      for (auto &x : h) x /= cnt;
  }
}

std::vector<std::array<float, 33>> compute_fpfh(
    const std::vector<Vec3> &pts, const std::vector<Vec3> &normals,
    const GridHash &grid, double radius) {
  std::vector<std::array<float, 33>> spfh;
  std::vector<std::vector<int>> neighbors;
  compute_spfh(pts, normals, grid, radius, spfh, neighbors);
  std::vector<std::array<float, 33>> fpfh(pts.size(), std::array<float, 33>{});
  for (size_t i = 0; i < pts.size(); ++i) {
    auto &f = fpfh[i];
    f = spfh[i];
    double wsum = 1.0;
    for (int j : neighbors[i]) {
      double w = (pts[j] - pts[i]).norm();
      if (w < 1e-12) continue;
      w = 1.0 / w;
      for (int k = 0; k < 33; ++k) f[k] += (float)(w * spfh[j][k]);
      wsum += w;
    }
    for (int k = 0; k < 33; ++k) f[k] /= (float)wsum;
  }
  return fpfh;
}

// -------------------------------------------------- feature nearest neighbor
int nn_feature(const std::array<float, 33> &q,
               const std::vector<std::array<float, 33>> &feats) {
  int best = -1;
  float bd = 1e30f;
  for (size_t i = 0; i < feats.size(); ++i) {
    float d = 0;
    for (int k = 0; k < 33; ++k) {
      float t = q[k] - feats[i][k];
      d += t * t;
      if (d >= bd) break;
    }
    if (d < bd) { bd = d; best = (int)i; }
  }
  return best;
}

// -------------------------------------------------------------- 6x6 solver
bool solve66(double A[6][6], double b[6], double x[6]) {
  int idx[6] = {0, 1, 2, 3, 4, 5};
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (std::fabs(A[r][c]) > std::fabs(A[piv][c])) piv = r;
    if (std::fabs(A[piv][c]) < 1e-12) return false;
    std::swap(A[c], A[piv]);
    std::swap(b[c], b[piv]);
    (void)idx;
    for (int r = c + 1; r < 6; ++r) {
      double f = A[r][c] / A[c][c];
      for (int k = c; k < 6; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  for (int c = 5; c >= 0; --c) {
    double s = b[c];
    for (int k = c + 1; k < 6; ++k) s -= A[c][k] * x[k];
    x[c] = s / A[c][c];
  }
  return true;
}

void apply_T(const double T[16], const Vec3 &p, Vec3 &out) {
  out.x = T[0] * p.x + T[1] * p.y + T[2] * p.z + T[3];
  out.y = T[4] * p.x + T[5] * p.y + T[6] * p.z + T[7];
  out.z = T[8] * p.x + T[9] * p.y + T[10] * p.z + T[11];
}

void compose_se3(const double xi[6], double T[16]) {
  // first-order update composed exactly via Rodrigues
  Vec3 w{xi[0], xi[1], xi[2]};
  double th = w.norm();
  double R[9];
  if (th < 1e-12) {
    R[0] = 1; R[1] = 0; R[2] = 0; R[3] = 0; R[4] = 1; R[5] = 0;
    R[6] = 0; R[7] = 0; R[8] = 1;
  } else {
    Vec3 a = w * (1.0 / th);
    double c = std::cos(th), s = std::sin(th), C = 1 - c;
    R[0] = c + a.x * a.x * C;       R[1] = a.x * a.y * C - a.z * s; R[2] = a.x * a.z * C + a.y * s;
    R[3] = a.y * a.x * C + a.z * s; R[4] = c + a.y * a.y * C;       R[5] = a.y * a.z * C - a.x * s;
    R[6] = a.z * a.x * C - a.y * s; R[7] = a.z * a.y * C + a.x * s; R[8] = c + a.z * a.z * C;
  }
  double Tn[16] = {R[0], R[1], R[2], xi[3], R[3], R[4], R[5], xi[4],
                   R[6], R[7], R[8], xi[5], 0, 0, 0, 1};
  double Told[16];
  std::memcpy(Told, T, sizeof(Told));
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += Tn[4 * r + k] * Told[4 * k + c];
      T[4 * r + c] = s;
    }
}

}  // namespace

namespace {

// Kabsch on a correspondence subset -> 4x4 row-major T (src -> tgt).
void kabsch(const std::vector<Vec3> &src, const std::vector<Vec3> &tgt,
            const std::vector<std::pair<int, int>> &corr,
            const std::vector<int> &subset, double T[16]) {
  Vec3 ca{0, 0, 0}, cb{0, 0, 0};
  for (int k : subset) {
    ca = ca + src[corr[k].first];
    cb = cb + tgt[corr[k].second];
  }
  double inv = 1.0 / subset.size();
  ca = ca * inv;
  cb = cb * inv;
  double H[3][3] = {};
  for (int k : subset) {
    Vec3 a = src[corr[k].first] - ca;
    Vec3 b = tgt[corr[k].second] - cb;
    double av[3] = {a.x, a.y, a.z}, bv[3] = {b.x, b.y, b.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) H[i][j] += av[i] * bv[j];
  }
  // SVD of 3x3 via Jacobi eigen of H^T H (V), then U = H V S^-1
  double HtH[3][3] = {};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) HtH[i][j] += H[k][i] * H[k][j];
  double V[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  double A[3][3];
  std::memcpy(A, HtH, sizeof(A));
  for (int sweep = 0; sweep < 16; ++sweep)
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(A[p][q]) < 1e-15) continue;
        double theta = 0.5 * std::atan2(2 * A[p][q], A[q][q] - A[p][p]);
        double c = std::cos(theta), s = std::sin(theta);
        for (int k = 0; k < 3; ++k) {
          double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
          double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  // columns of V = eigenvectors; singular values = sqrt(eig). With 3
  // correspondences H is rank-2: complete the deficient column(s) of U
  // (and V) by cross products instead of dividing by ~0.
  double U[3][3];
  double sv_max = 1e-12;
  for (int j = 0; j < 3; ++j) sv_max = std::max(sv_max, A[j][j]);
  int weak = -1;
  for (int j = 0; j < 3; ++j) {
    double sv2 = A[j][j];
    if (sv2 < 1e-9 * sv_max) { weak = j; continue; }
    double sv = std::sqrt(std::max(sv2, 1e-12));
    for (int i = 0; i < 3; ++i) {
      double hv = 0;
      for (int k = 0; k < 3; ++k) hv += H[i][k] * V[k][j];
      U[i][j] = hv / sv;
    }
  }
  if (weak >= 0) {
    int a = (weak + 1) % 3, b2 = (weak + 2) % 3;
    Vec3 ua{U[0][a], U[1][a], U[2][a]}, ub{U[0][b2], U[1][b2], U[2][b2]};
    Vec3 uc = ua.cross(ub).normalized();
    U[0][weak] = uc.x; U[1][weak] = uc.y; U[2][weak] = uc.z;
    Vec3 va{V[0][a], V[1][a], V[2][a]}, vb{V[0][b2], V[1][b2], V[2][b2]};
    Vec3 vc = va.cross(vb).normalized();
    V[0][weak] = vc.x; V[1][weak] = vc.y; V[2][weak] = vc.z;
  }
  // R = U V^T with det fix (R maps src->tgt: note H = sum a b^T so R = U V^T
  // transposed appropriately; verify orientation via det)
  double R[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      R[i][j] = 0;
      for (int k = 0; k < 3; ++k) R[i][j] += V[i][k] * U[j][k];
    }
  double det = R[0][0] * (R[1][1] * R[2][2] - R[1][2] * R[2][1]) -
               R[0][1] * (R[1][0] * R[2][2] - R[1][2] * R[2][0]) +
               R[0][2] * (R[1][0] * R[2][1] - R[1][1] * R[2][0]);
  if (det < 0) {
    // flip the smallest singular direction (column 2 after sort ~ use col
    // with smallest eigenvalue: find it)
    int mi = 0;
    for (int k = 1; k < 3; ++k)
      if (A[k][k] < A[mi][mi]) mi = k;
    for (int i = 0; i < 3; ++i) V[i][mi] = -V[i][mi];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        R[i][j] = 0;
        for (int k = 0; k < 3; ++k) R[i][j] += V[i][k] * U[j][k];
      }
  }
  // With H = sum (a-ca)(b-cb)^T and SVD H = U S V^T, the rotation mapping
  // a -> b is R = V U^T — which is exactly what R holds above.
  Vec3 t = cb - Vec3{R[0][0] * ca.x + R[0][1] * ca.y + R[0][2] * ca.z,
                     R[1][0] * ca.x + R[1][1] * ca.y + R[1][2] * ca.z,
                     R[2][0] * ca.x + R[2][1] * ca.y + R[2][2] * ca.z};
  double Tn[16] = {R[0][0], R[0][1], R[0][2], t.x,
                   R[1][0], R[1][1], R[1][2], t.y,
                   R[2][0], R[2][1], R[2][2], t.z, 0, 0, 0, 1};
  std::memcpy(T, Tn, sizeof(Tn));
}

}  // namespace

extern "C" {

// Register src onto tgt: out_T (row-major 4x4) maps src points into tgt.
// Returns 0 on success, <0 on failure.
int fgr_register(const double *src_xyz, int n_src, const double *tgt_xyz,
                 int n_tgt, double voxel_size, double *out_T) {
  if (n_src < 10 || n_tgt < 10) return -1;
  auto src = voxel_downsample(src_xyz, n_src, voxel_size);
  auto tgt = voxel_downsample(tgt_xyz, n_tgt, voxel_size);
  if (src.size() < 10 || tgt.size() < 10) return -2;

  double normal_r = voxel_size * 2.0;
  double feature_r = voxel_size * 5.0;

  GridHash gs, gt;
  gs.build(src, feature_r);
  gt.build(tgt, feature_r);
  auto ns = estimate_normals(src, gs, normal_r);
  auto nt = estimate_normals(tgt, gt, normal_r);
  auto fs = compute_fpfh(src, ns, gs, feature_r);
  auto ft = compute_fpfh(tgt, nt, gt, feature_r);

  // reciprocal nearest-neighbor correspondences
  std::vector<std::pair<int, int>> corr;
  std::vector<int> t_for_s(src.size());
  for (size_t i = 0; i < src.size(); ++i) t_for_s[i] = nn_feature(fs[i], ft);
  std::vector<int> s_for_t(tgt.size());
  for (size_t j = 0; j < tgt.size(); ++j) s_for_t[j] = nn_feature(ft[j], fs);
  for (size_t i = 0; i < src.size(); ++i) {
    int j = t_for_s[i];
    if (j >= 0 && s_for_t[j] == (int)i) corr.push_back({(int)i, j});
  }
  if (corr.size() < 10) return -3;

  // tuple test (FGR sec 3.3): keep correspondences appearing in compatible
  // random triplets
  std::mt19937 rng(0);
  std::uniform_int_distribution<int> pick(0, (int)corr.size() - 1);
  std::vector<char> keep(corr.size(), 0);
  const double tau = 0.9;
  int found = 0;
  for (int it = 0; it < (int)corr.size() * 30 && found < 3000; ++it) {
    int a = pick(rng), b = pick(rng), c = pick(rng);
    if (a == b || b == c || a == c) continue;
    auto ok = [&](int u, int v) {
      double ds = (src[corr[u].first] - src[corr[v].first]).norm();
      double dt = (tgt[corr[u].second] - tgt[corr[v].second]).norm();
      if (ds < 1e-9 || dt < 1e-9) return false;
      double r = ds / dt;
      return r > tau && r < 1.0 / tau;
    };
    if (ok(a, b) && ok(b, c) && ok(a, c)) {
      for (int u : {a, b, c})
        if (!keep[u]) { keep[u] = 1; ++found; }
    }
  }
  std::vector<std::pair<int, int>> corr2;
  for (size_t i = 0; i < corr.size(); ++i)
    if (keep[i]) corr2.push_back(corr[i]);
  if (corr2.size() < 10) corr2 = corr;  // fall back to all correspondences

  // graduated non-convexity over scaled Geman-McClure, Gauss-Newton steps
  double T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  double max_dist = voxel_size * 20.0;
  double mu = max_dist * max_dist;
  const int outer = 64;
  for (int it = 0; it < outer; ++it) {
    if (it > 0 && it % 4 == 0) mu = std::max(mu / 1.4, voxel_size * voxel_size * 0.25);
    double A[6][6] = {}, b[6] = {};
    for (auto &pr : corr2) {
      Vec3 ps;
      apply_T(T, src[pr.first], ps);
      Vec3 q = tgt[pr.second];
      Vec3 r = ps - q;
      double r2 = r.dot(r);
      double w = mu / ((mu + r2) * (mu + r2)) * mu;  // GM weight (l_{p,q})
      // J = [ -[ps]x | I ] per row; accumulate J^T W J and J^T W r
      double J[3][6] = {{0, ps.z, -ps.y, 1, 0, 0},
                        {-ps.z, 0, ps.x, 0, 1, 0},
                        {ps.y, -ps.x, 0, 0, 0, 1}};
      double res[3] = {r.x, r.y, r.z};
      for (int a2 = 0; a2 < 6; ++a2) {
        for (int b2 = 0; b2 < 6; ++b2) {
          double s = 0;
          for (int k = 0; k < 3; ++k) s += J[k][a2] * J[k][b2];
          A[a2][b2] += w * s;
        }
        double s = 0;
        for (int k = 0; k < 3; ++k) s += J[k][a2] * res[k];
        b[a2] += w * s;
      }
    }
    for (int d = 0; d < 6; ++d) A[d][d] += 1e-9;
    double xi[6];
    double nb[6];
    for (int d = 0; d < 6; ++d) nb[d] = -b[d];
    if (!solve66(A, nb, xi)) break;
    compose_se3(xi, T);
    double step = 0;
    for (int d = 0; d < 6; ++d) step += xi[d] * xi[d];
    if (step < 1e-14) break;
  }
  std::memcpy(out_T, T, sizeof(T));
  return 0;
}

// RANSAC feature-matching registration (Open3D
// registration_ransac_based_on_feature_matching equivalent): FPFH
// correspondences -> 3-sample Kabsch hypotheses -> inlier maximization ->
// final Kabsch refit on inliers. Returns 0 on success.
int ransac_register(const double *src_xyz, int n_src, const double *tgt_xyz,
                    int n_tgt, double voxel_size, int max_iters,
                    double *out_T) {
  if (n_src < 10 || n_tgt < 10) return -1;
  auto src = voxel_downsample(src_xyz, n_src, voxel_size);
  auto tgt = voxel_downsample(tgt_xyz, n_tgt, voxel_size);
  if (src.size() < 10 || tgt.size() < 10) return -2;
  double normal_r = voxel_size * 2.0, feature_r = voxel_size * 5.0;
  GridHash gs, gt;
  gs.build(src, feature_r);
  gt.build(tgt, feature_r);
  auto ns = estimate_normals(src, gs, normal_r);
  auto nt = estimate_normals(tgt, gt, normal_r);
  auto fs = compute_fpfh(src, ns, gs, feature_r);
  auto ft = compute_fpfh(tgt, nt, gt, feature_r);

  // reciprocal nearest-neighbor correspondences (same pipeline as FGR —
  // one-directional matches proved too noisy for stable hypotheses)
  std::vector<std::pair<int, int>> corr;
  std::vector<int> t_for_s(src.size()), s_for_t(tgt.size());
  for (size_t i = 0; i < src.size(); ++i) t_for_s[i] = nn_feature(fs[i], ft);
  for (size_t j = 0; j < tgt.size(); ++j) s_for_t[j] = nn_feature(ft[j], fs);
  for (size_t i = 0; i < src.size(); ++i) {
    int j = t_for_s[i];
    if (j >= 0 && s_for_t[j] == (int)i) corr.push_back({(int)i, j});
  }
  if (corr.size() < 3) return -3;

  std::mt19937 rng(0);
  std::uniform_int_distribution<int> pick(0, (int)corr.size() - 1);
  double thresh = voxel_size * 1.5;
  double t2 = thresh * thresh;
  int best_inliers = -1;
  double best_T[16];
  std::vector<int> tri(3);
  for (int it = 0; it < max_iters; ++it) {
    tri[0] = pick(rng);
    tri[1] = pick(rng);
    tri[2] = pick(rng);
    if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2]) continue;
    // edge-length compatibility prefilter
    double ds01 = (src[corr[tri[0]].first] - src[corr[tri[1]].first]).norm();
    double dt01 = (tgt[corr[tri[0]].second] - tgt[corr[tri[1]].second]).norm();
    if (std::fabs(ds01 - dt01) > 2 * thresh) continue;
    double T[16];
    kabsch(src, tgt, corr, tri, T);
    int inl = 0;
    for (auto &pr : corr) {
      Vec3 p;
      apply_T(T, src[pr.first], p);
      Vec3 r = p - tgt[pr.second];
      if (r.dot(r) < t2) ++inl;
    }
    if (inl > best_inliers) {
      best_inliers = inl;
      std::memcpy(best_T, T, sizeof(T));
    }
  }
  if (best_inliers < 3) return -4;
  // polish with the graduated Geman-McClure Gauss-Newton loop (same
  // objective as fgr_register) seeded from the RANSAC pose — smoothly
  // downweights bad feature matches instead of hard ICP reassignment
  double mu = (thresh * 4.0) * (thresh * 4.0);
  for (int it = 0; it < 48; ++it) {
    if (it > 0 && it % 4 == 0)
      mu = std::max(mu / 1.4, voxel_size * voxel_size * 0.25);
    double A[6][6] = {}, b[6] = {};
    for (auto &pr : corr) {
      Vec3 ps;
      apply_T(best_T, src[pr.first], ps);
      Vec3 r = ps - tgt[pr.second];
      double r2v = r.dot(r);
      double w = mu / ((mu + r2v) * (mu + r2v)) * mu;
      double J[3][6] = {{0, ps.z, -ps.y, 1, 0, 0},
                        {-ps.z, 0, ps.x, 0, 1, 0},
                        {ps.y, -ps.x, 0, 0, 0, 1}};
      double res[3] = {r.x, r.y, r.z};
      for (int a2 = 0; a2 < 6; ++a2) {
        for (int b2 = 0; b2 < 6; ++b2) {
          double s = 0;
          for (int k = 0; k < 3; ++k) s += J[k][a2] * J[k][b2];
          A[a2][b2] += w * s;
        }
        double s = 0;
        for (int k = 0; k < 3; ++k) s += J[k][a2] * res[k];
        b[a2] += w * s;
      }
    }
    for (int d2 = 0; d2 < 6; ++d2) A[d2][d2] += 1e-9;
    double xi[6], nb[6];
    for (int d2 = 0; d2 < 6; ++d2) nb[d2] = -b[d2];
    if (!solve66(A, nb, xi)) break;
    compose_se3(xi, best_T);
  }
  std::memcpy(out_T, best_T, sizeof(best_T));
  return 0;
}

// FPFH features for external use (testing): out must hold n*33 floats.
int fpfh_features(const double *xyz, int n, double voxel_size, float *out) {
  auto pts = voxel_downsample(xyz, n, voxel_size);
  GridHash g;
  double feature_r = voxel_size * 5.0;
  g.build(pts, feature_r);
  auto normals = estimate_normals(pts, g, voxel_size * 2.0);
  auto f = compute_fpfh(pts, normals, g, feature_r);
  int m = std::min((int)f.size(), n);
  for (int i = 0; i < m; ++i)
    for (int k = 0; k < 33; ++k) out[i * 33 + k] = f[i][k];
  return (int)f.size();
}

}  // extern "C"
