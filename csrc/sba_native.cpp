// sba_native: native host runtime for spherical_ba.
//
// Three subsystems, exposed as a C ABI for ctypes:
//   1. Image codecs (libpng / libjpeg): decode to RGB8, encode PNG.
//   2. A threaded prefetching image loader (the data-loader tier the
//      reference lacks; OpenMP pixel loops in the reference are replaced
//      on-device by XLA, so the native niche is host IO).
//   3. A float64 "oracle" implementing the reference's numerical
//      conventions (8-point essential estimation, rot2euler, the
//      three-stage BCD bundle adjustment with its quirks) used by golden
//      tests to validate the f32 on-device solvers. Conventions follow
//      /root/reference/spherical_bundle_adjuster.cpp:47-217, independently
//      re-implemented (Jacobi eigensolvers instead of LAPACK/OpenCV).
//
// Build: python csrc/build.py  (g++ -O2 -shared -fPIC, links png/jpeg/z)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// 1. Image codecs

void sba_free(void* p) { free(p); }

// Decode PNG or JPEG (sniffed by magic bytes) into a malloc'd RGB8 buffer.
// Returns 0 on success.
int sba_load_image(const char* path, uint8_t** out, int* out_h, int* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return -2;
  }
  rewind(f);

  if (magic[0] == 0x89 && magic[1] == 'P') {  // PNG
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(f);
      return -3;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);

    uint8_t* buf = (uint8_t*)malloc((size_t)h * w * 3);
    std::vector<png_bytep> rows(h);
    for (png_uint_32 i = 0; i < h; i++) rows[i] = buf + (size_t)i * w * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    *out = buf;
    *out_h = (int)h;
    *out_w = (int)w;
    return 0;
  }

  if (magic[0] == 0xFF && magic[1] == 0xD8) {  // JPEG
    jpeg_decompress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    int w = cinfo.output_width, h = cinfo.output_height;
    uint8_t* buf = (uint8_t*)malloc((size_t)h * w * 3);
    while ((int)cinfo.output_scanline < h) {
      JSAMPROW row = buf + (size_t)cinfo.output_scanline * w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    *out = buf;
    *out_h = h;
    *out_w = w;
    return 0;
  }

  fclose(f);
  return -4;  // unknown format
}

int sba_save_png(const char* path, const uint8_t* rgb, int h, int w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                            nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return -2;
  }
  png_init_io(png, f);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int i = 0; i < h; i++)
    png_write_row(png, const_cast<png_bytep>(rgb + (size_t)i * w * 3));
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// 2. Threaded prefetching loader

struct Loader {
  std::vector<std::string> paths;
  std::queue<int> pending;                    // indices to decode
  std::queue<std::pair<int, uint8_t*>> done;  // decoded results (h*w known)
  int h = 0, w = 0;                            // expected dims (0 = any/first)
  std::mutex mu;
  std::condition_variable cv_done, cv_work;
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};
  std::atomic<int> outstanding{0};

  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !pending.empty(); });
        if (stop && pending.empty()) return;
        idx = pending.front();
        pending.pop();
      }
      uint8_t* buf = nullptr;
      int ih = 0, iw = 0;
      int rc = sba_load_image(paths[idx].c_str(), &buf, &ih, &iw);
      if (rc != 0) buf = nullptr;
      {
        std::lock_guard<std::mutex> lk(mu);
        done.push({idx, buf});
        if (buf && h == 0) { h = ih; w = iw; }
      }
      cv_done.notify_one();
    }
  }
};

void* sba_loader_create(const char** paths, int n, int n_threads) {
  Loader* L = new Loader();
  for (int i = 0; i < n; i++) L->paths.emplace_back(paths[i]);
  for (int i = 0; i < n; i++) L->pending.push(i);
  L->outstanding = n;
  int nt = std::max(1, n_threads);
  for (int i = 0; i < nt; i++) L->threads.emplace_back(&Loader::worker, L);
  L->cv_work.notify_all();
  return L;
}

// Pops one decoded image (blocking). Returns the path index, or -1 when
// exhausted, or -2 on decode error for that item. Caller provides `out`
// sized cap_bytes; short buffers truncate.
int sba_loader_next(void* lp, uint8_t* out, long cap_bytes, int* out_h,
                    int* out_w) {
  Loader* L = (Loader*)lp;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->outstanding == 0 && L->done.empty()) return -1;
  L->cv_done.wait(lk, [&] { return !L->done.empty(); });
  auto [idx, buf] = L->done.front();
  L->done.pop();
  L->outstanding--;
  lk.unlock();
  if (!buf) return -2;
  // dims were captured on first decode; all images in a dataset share them
  long bytes = (long)L->h * L->w * 3;
  memcpy(out, buf, std::min(bytes, cap_bytes));
  if (out_h) *out_h = L->h;
  if (out_w) *out_w = L->w;
  free(buf);
  return idx;
}

void sba_loader_destroy(void* lp) {
  Loader* L = (Loader*)lp;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_work.notify_all();
  for (auto& t : L->threads) t.join();
  while (!L->done.empty()) {
    free(L->done.front().second);
    L->done.pop();
  }
  delete L;
}

// ---------------------------------------------------------------------------
// 3. Float64 reference-convention oracle

}  // extern "C" (reopened below; helper templates need C++ linkage)

namespace {

// Cyclic Jacobi eigensolver for a symmetric n x n matrix (row major).
// On return: A's diagonal holds eigenvalues, V columns the eigenvectors.
void jacobi_eig(double* A, double* V, int n, int sweeps = 50) {
  for (int i = 0; i < n * n; i++) V[i] = 0.0;
  for (int i = 0; i < n; i++) V[i * n + i] = 1.0;
  for (int s = 0; s < sweeps; s++) {
    double off = 0.0;
    for (int p = 0; p < n; p++)
      for (int q = p + 1; q < n; q++) off += A[p * n + q] * A[p * n + q];
    if (off < 1e-24) break;
    for (int p = 0; p < n; p++) {
      for (int q = p + 1; q < n; q++) {
        double apq = A[p * n + q];
        if (std::fabs(apq) < 1e-30) continue;
        double app = A[p * n + p], aqq = A[q * n + q];
        double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        double c = 1.0 / std::sqrt(1.0 + t * t), sn = t * c;
        for (int k = 0; k < n; k++) {
          double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - sn * akq;
          A[k * n + q] = sn * akp + c * akq;
        }
        for (int k = 0; k < n; k++) {
          double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - sn * aqk;
          A[q * n + k] = sn * apk + c * aqk;
        }
        for (int k = 0; k < n; k++) {
          double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - sn * vkq;
          V[k * n + q] = sn * vkp + c * vkq;
        }
      }
    }
  }
}

void mat3_mul(const double A[9], const double B[9], double C[9]) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += A[i * 3 + k] * B[k * 3 + j];
      C[i * 3 + j] = s;
    }
}

double det3(const double A[9]) {
  return A[0] * (A[4] * A[8] - A[5] * A[7]) -
         A[1] * (A[3] * A[8] - A[5] * A[6]) +
         A[2] * (A[3] * A[7] - A[4] * A[6]);
}

// SVD of a 3x3 via Jacobi on A^T A: A = U diag(s) V^T.
void svd3(const double A[9], double U[9], double s[3], double Vt[9]) {
  double ata[9], V[9];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double acc = 0;
      for (int k = 0; k < 3; k++) acc += A[k * 3 + i] * A[k * 3 + j];
      ata[i * 3 + j] = acc;
    }
  jacobi_eig(ata, V, 3);
  // sort eigenvalues descending
  int ord[3] = {0, 1, 2};
  double ev[3] = {ata[0], ata[4], ata[8]};
  std::sort(ord, ord + 3, [&](int a, int b) { return ev[a] > ev[b]; });
  for (int j = 0; j < 3; j++) {
    s[j] = std::sqrt(std::max(ev[ord[j]], 0.0));
    for (int i = 0; i < 3; i++) Vt[j * 3 + i] = V[i * 3 + ord[j]];
  }
  // U = A V / s. The cutoff must be RELATIVE to s[0]: for a rank-2
  // essential matrix the numerical third singular value is ~1e-9, and
  // dividing its noise direction by it yields a non-orthogonal U.
  for (int j = 0; j < 3; j++) {
    double col[3] = {0, 0, 0};
    for (int i = 0; i < 3; i++)
      for (int k = 0; k < 3; k++) col[i] += A[i * 3 + k] * Vt[j * 3 + k];
    if (s[j] > 1e-6 * std::max(s[0], 1e-300)) {
      for (int i = 0; i < 3; i++) U[i * 3 + j] = col[i] / s[j];
    } else {
      double u0[3] = {U[0], U[3], U[6]}, u1[3] = {U[1], U[4], U[7]};
      U[0 * 3 + j] = u0[1] * u1[2] - u0[2] * u1[1];
      U[1 * 3 + j] = u0[2] * u1[0] - u0[0] * u1[2];
      U[2 * 3 + j] = u0[0] * u1[1] - u0[1] * u1[0];
    }
  }
}

// rot2euler, the reference formula (spherical_bundle_adjuster.cpp:25-45).
void rot2euler(const double R[9], double e[3]) {
  double sy = std::sqrt(R[0] * R[0] + R[3] * R[3]);
  if (sy >= 1e-6) {
    e[0] = std::atan2(R[7], R[8]);
    e[1] = std::atan2(-R[6], sy);
    e[2] = std::atan2(R[3], R[0]);
  } else {
    e[0] = std::atan2(-R[5], R[4]);
    e[1] = std::atan2(-R[6], sy);
    e[2] = 0.0;
  }
}

void angle_axis_rotate(const double r[3], const double X[3], double out[3]) {
  double th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  if (th2 < 1e-24) {
    // small-angle: R x ~ x + r x x
    out[0] = X[0] + r[1] * X[2] - r[2] * X[1];
    out[1] = X[1] + r[2] * X[0] - r[0] * X[2];
    out[2] = X[2] + r[0] * X[1] - r[1] * X[0];
    return;
  }
  double th = std::sqrt(th2);
  double w[3] = {r[0] / th, r[1] / th, r[2] / th};
  double c = std::cos(th), s = std::sin(th);
  double wx[3] = {w[1] * X[2] - w[2] * X[1], w[2] * X[0] - w[0] * X[2],
                  w[0] * X[1] - w[1] * X[0]};
  double wd = w[0] * X[0] + w[1] * X[1] + w[2] * X[2];
  for (int i = 0; i < 3; i++)
    out[i] = X[i] * c + wx[i] * s + w[i] * wd * (1.0 - c);
}

}  // namespace

extern "C" {

// debug helpers (test-only)
void sba_dbg_svd3(const double* A, double* U, double* s, double* Vt) {
  svd3(A, U, s, Vt);
}
void sba_dbg_eig(double* A, double* V, int n) { jacobi_eig(A, V, n); }

// 8-point essential estimation, the reference pipeline
// (spherical_bundle_adjuster.cpp:47-116): constraint rows
// flatten(outer(b1, b2)), null vector of A^T A, rank-2 projection,
// decomposeEssentialMat convention, rot2euler + |e|<1.57 validity.
void sba_oracle_eight_point(const double* b1, const double* b2, int n,
                            double* e1_out, double* e2_out, double* t_out,
                            int* valid1, int* valid2) {
  double M[81] = {0};
  for (int i = 0; i < n; i++) {
    double a[9];
    for (int r = 0; r < 3; r++)
      for (int c = 0; c < 3; c++) a[r * 3 + c] = b1[i * 3 + r] * b2[i * 3 + c];
    for (int r = 0; r < 9; r++)
      for (int c = 0; c < 9; c++) M[r * 9 + c] += a[r] * a[c];
  }
  double V[81];
  jacobi_eig(M, V, 9);
  int mi = 0;
  double ev[9];
  for (int i = 0; i < 9; i++) ev[i] = M[i * 9 + i];
  for (int i = 1; i < 9; i++)
    if (ev[i] < ev[mi]) mi = i;
  double E[9];
  for (int i = 0; i < 9; i++) E[i] = V[i * 9 + mi];

  double U[9], s[3], Vt[9];
  svd3(E, U, s, Vt);
  // rank-2 projection
  double Ec[9];
  {
    double Us[9];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        Us[i * 3 + j] = U[i * 3 + j] * (j < 2 ? s[j] : 0.0);
    mat3_mul(Us, Vt, Ec);
  }
  svd3(Ec, U, s, Vt);
  if (det3(U) < 0)
    for (int i = 0; i < 9; i++) U[i] = -U[i];
  if (det3(Vt) < 0)
    for (int i = 0; i < 9; i++) Vt[i] = -Vt[i];
  double W[9] = {0, 1, 0, -1, 0, 0, 0, 0, 1};
  double Wt[9] = {0, -1, 0, 1, 0, 0, 0, 0, 1};
  double R1[9], R2[9], tmp[9];
  mat3_mul(U, W, tmp);
  mat3_mul(tmp, Vt, R1);
  mat3_mul(U, Wt, tmp);
  mat3_mul(tmp, Vt, R2);
  t_out[0] = U[2];
  t_out[1] = U[5];
  t_out[2] = U[8];
  rot2euler(R1, e1_out);
  rot2euler(R2, e2_out);
  double m1 = std::max({std::fabs(e1_out[0]), std::fabs(e1_out[1]),
                        std::fabs(e1_out[2])});
  double m2 = std::max({std::fabs(e2_out[0]), std::fabs(e2_out[1]),
                        std::fabs(e2_out[2])});
  *valid1 = m1 < 1.57;
  *valid2 = m2 < 1.57;
}

}  // extern "C"

namespace {

// Reprojection residual (spherical_bundle_adjuster.cpp:844-868):
// res = X2 - (AngleAxis(r) X1 - t), X1 = d1 b1, X2 = d2 b2.
void reproj_residual(const double b1[3], const double b2[3], double d1,
                     double d2, const double r[3], const double t[3],
                     double res[3]) {
  double X1[3] = {b1[0] * d1, b1[1] * d1, b1[2] * d1};
  double X2[3] = {b2[0] * d2, b2[1] * d2, b2[2] * d2};
  double Xr[3];
  angle_axis_rotate(r, X1, Xr);
  for (int i = 0; i < 3; i++) res[i] = X2[i] - (Xr[i] - t[i]);
}

double huber_cost_block(const double res[3], double delta) {
  double s = res[0] * res[0] + res[1] * res[1] + res[2] * res[2];
  if (s <= delta * delta) return 0.5 * s;
  return 0.5 * (2.0 * delta * std::sqrt(s) - delta * delta);
}

// Damped LM over a 3-vector parameter with numeric central-difference
// Jacobians and Huber weighting. `eval` fills res (3n).
template <typename EvalFn>
void lm3(double* param, int n_blocks, int iters, double huber, EvalFn eval) {
  double lam = 1e-4;
  std::vector<double> res(3 * n_blocks), res2(3 * n_blocks);
  for (int it = 0; it < iters; it++) {
    eval(param, res.data());
    double cost = 0;
    for (int i = 0; i < n_blocks; i++) cost += huber_cost_block(&res[3 * i], huber);
    // numeric Jacobian 3n x 3
    double H[9] = {0}, g[3] = {0};
    std::vector<double> Jcol[3];
    for (int c = 0; c < 3; c++) {
      double eps = 1e-7;
      double p2[3] = {param[0], param[1], param[2]};
      p2[c] += eps;
      eval(p2, res2.data());
      Jcol[c].resize(3 * n_blocks);
      for (int k = 0; k < 3 * n_blocks; k++)
        Jcol[c][k] = (res2[k] - res[k]) / eps;
    }
    for (int i = 0; i < n_blocks; i++) {
      double s = res[3 * i] * res[3 * i] + res[3 * i + 1] * res[3 * i + 1] +
                 res[3 * i + 2] * res[3 * i + 2];
      double wgt = (s <= huber * huber) ? 1.0 : huber / std::sqrt(s);
      for (int a = 0; a < 3; a++)
        for (int b = 0; b < 3; b++)
          for (int k = 0; k < 3; k++)
            H[a * 3 + b] += wgt * Jcol[a][3 * i + k] * Jcol[b][3 * i + k];
      for (int a = 0; a < 3; a++)
        for (int k = 0; k < 3; k++)
          g[a] += wgt * Jcol[a][3 * i + k] * res[3 * i + k];
    }
    // solve (H + lam diag(H)) dp = -g  (3x3 Cramer)
    double Hd[9];
    for (int i = 0; i < 9; i++) Hd[i] = H[i];
    for (int i = 0; i < 3; i++) Hd[i * 3 + i] += lam * H[i * 3 + i] + 1e-12;
    double dets = det3(Hd);
    if (std::fabs(dets) < 1e-30) {
      lam *= 4;
      continue;
    }
    double dp[3];
    for (int c = 0; c < 3; c++) {
      double Hc[9];
      memcpy(Hc, Hd, sizeof(Hc));
      for (int r2 = 0; r2 < 3; r2++) Hc[r2 * 3 + c] = -g[r2];
      dp[c] = det3(Hc) / dets;
    }
    double pnew[3] = {param[0] + dp[0], param[1] + dp[1], param[2] + dp[2]};
    eval(pnew, res2.data());
    double cost2 = 0;
    for (int i = 0; i < n_blocks; i++)
      cost2 += huber_cost_block(&res2[3 * i], huber);
    if (cost2 < cost) {
      memcpy(param, pnew, sizeof(pnew));
      lam = std::max(lam / 2, 1e-12);
    } else {
      lam = std::min(lam * 4, 1e10);
    }
  }
}

}  // namespace

extern "C" {

// Three-stage BCD (d -> rot -> tran), reference solve_problem semantics
// (spherical_bundle_adjuster.cpp:183-217). compat != 0 replicates the
// first-two-matches depth quirk (:941-942, :998-999); otherwise per-match
// depths are used in the rot/tran stages.
void sba_oracle_bcd(const double* b1, const double* b2, int n, double* rot,
                    double* tran, double* d, int iters, int compat) {
  // ---- d stage: per-match (d1, d2), 5 residuals, barrier, bound >= 0 ----
  for (int i = 0; i < n; i++) {
    double lam = 1e-4;
    double di[2] = {d[2 * i], d[2 * i + 1]};
    for (int it = 0; it < iters; it++) {
      auto eval5 = [&](const double dd[2], double out[5]) {
        reproj_residual(&b1[3 * i], &b2[3 * i], dd[0], dd[1], rot, tran, out);
        out[3] = std::exp(-dd[0]);
        out[4] = std::exp(-dd[1]);
      };
      double r0[5], r1[5], r2[5];
      eval5(di, r0);
      double c0 = 0;
      for (int k = 0; k < 5; k++) c0 += 0.5 * r0[k] * r0[k];
      double eps = 1e-7;
      double da[2] = {di[0] + eps, di[1]}, db[2] = {di[0], di[1] + eps};
      eval5(da, r1);
      eval5(db, r2);
      double J[5][2];
      for (int k = 0; k < 5; k++) {
        J[k][0] = (r1[k] - r0[k]) / eps;
        J[k][1] = (r2[k] - r0[k]) / eps;
      }
      double H00 = 0, H01 = 0, H11 = 0, g0 = 0, g1 = 0;
      for (int k = 0; k < 5; k++) {
        H00 += J[k][0] * J[k][0];
        H01 += J[k][0] * J[k][1];
        H11 += J[k][1] * J[k][1];
        g0 += J[k][0] * r0[k];
        g1 += J[k][1] * r0[k];
      }
      H00 *= 1.0 + lam;
      H11 *= 1.0 + lam;
      double dd = H00 * H11 - H01 * H01;
      if (std::fabs(dd) < 1e-30) {
        lam *= 4;
        continue;
      }
      double s0 = (-g0 * H11 + g1 * H01) / dd;
      double s1 = (-H00 * g1 + H01 * g0) / dd;
      double dn[2] = {std::max(di[0] + s0, 0.0), std::max(di[1] + s1, 0.0)};
      double rn[5];
      eval5(dn, rn);
      double c1 = 0;
      for (int k = 0; k < 5; k++) c1 += 0.5 * rn[k] * rn[k];
      if (c1 < c0) {
        di[0] = dn[0];
        di[1] = dn[1];
        lam = std::max(lam / 2, 1e-12);
      } else {
        lam = std::min(lam * 4, 1e10);
      }
    }
    d[2 * i] = di[0];
    d[2 * i + 1] = di[1];
  }

  // ---- rot stage ----
  double dq1 = compat ? d[0] : 0.0, dq2 = compat ? d[2] : 0.0;
  lm3(rot, n, iters, 1.0, [&](const double* r, double* out) {
    for (int i = 0; i < n; i++) {
      double d1 = compat ? dq1 : d[2 * i];
      double d2 = compat ? dq2 : d[2 * i + 1];
      reproj_residual(&b1[3 * i], &b2[3 * i], d1, d2, r, tran, &out[3 * i]);
    }
  });

  // ---- tran stage ----
  lm3(tran, n, iters, 1.0, [&](const double* t, double* out) {
    for (int i = 0; i < n; i++) {
      double d1 = compat ? dq1 : d[2 * i];
      double d2 = compat ? dq2 : d[2 * i + 1];
      reproj_residual(&b1[3 * i], &b2[3 * i], d1, d2, rot, t, &out[3 * i]);
    }
  });
}

}  // extern "C"
