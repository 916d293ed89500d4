// Copy of native/graph_builder.cpp, built by camouflage_multimodal_tpu_torch/native.py.
//
// Native host-side region-graph builder.
//
// CPU counterpart of the device kernels in camouflage_multimodal_tpu_torch/ops/
// (slic.py, canny.py, regions.py, rag.py): SLIC superpixels on the same
// fixed grid with the same 5×5-candidate + ±step-box assignment, skimage-
// style Canny with exact flood-fill hysteresis, the 15-dim per-region features of the
// reference pipeline (the reference's models/region_graph/train.py:112-179
// semantics), and the 8-connectivity RAG with the Gaussian-product edge
// weights. Used as a no-accelerator fallback and as an independent
// implementation cross-check for the port's kernels (tests/test_torch_port_native.py).
//
// Build: at first use by camouflage_multimodal_tpu_torch/native.py (libcmtgraph)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Gaussian blur (scipy.ndimage semantics: radius = trunc*sigma + 0.5,
// reflect padding)
// ---------------------------------------------------------------------------

std::vector<double> gaussian_kernel(double sigma, double truncate = 4.0) {
  int radius = int(truncate * sigma + 0.5);
  std::vector<double> k(2 * radius + 1);
  double sum = 0.0;
  for (int i = -radius; i <= radius; i++) {
    k[i + radius] = std::exp(-0.5 * (i / sigma) * (i / sigma));
    sum += k[i + radius];
  }
  for (auto& v : k) v /= sum;
  return k;
}

inline int reflect_idx(int i, int n) {  // scipy 'reflect' = symmetric
  while (i < 0 || i >= n) {
    if (i < 0) i = -i - 1;
    if (i >= n) i = 2 * n - i - 1;
  }
  return i;
}

void gaussian_blur_2d(const double* in, int h, int w, double sigma, double* out) {
  auto k = gaussian_kernel(sigma);
  int r = int(k.size() / 2);
  std::vector<double> tmp(size_t(h) * w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      double acc = 0;
      for (int d = -r; d <= r; d++)
        acc += k[d + r] * in[size_t(y) * w + reflect_idx(x + d, w)];
      tmp[size_t(y) * w + x] = acc;
    }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      double acc = 0;
      for (int d = -r; d <= r; d++)
        acc += k[d + r] * tmp[size_t(reflect_idx(y + d, h)) * w + x];
      out[size_t(y) * w + x] = acc;
    }
}

// ---------------------------------------------------------------------------
// sRGB → CIELAB (D65), matches ops/image.py::rgb_to_lab
// ---------------------------------------------------------------------------

void rgb_to_lab(const float* rgb, int n, double* lab) {
  static const double M[3][3] = {
      {0.412453, 0.357580, 0.180423},
      {0.212671, 0.715160, 0.072169},
      {0.019334, 0.119193, 0.950227}};
  static const double W[3] = {0.95047, 1.0, 1.08883};
  const double delta = 6.0 / 29.0;
  for (int i = 0; i < n; i++) {
    double lin[3];
    for (int c = 0; c < 3; c++) {
      double s = rgb[i * 3 + c];
      lin[c] = s > 0.04045 ? std::pow((s + 0.055) / 1.055, 2.4) : s / 12.92;
    }
    double f[3];
    for (int c = 0; c < 3; c++) {
      double t = (M[c][0] * lin[0] + M[c][1] * lin[1] + M[c][2] * lin[2]) / W[c];
      f[c] = t > delta * delta * delta ? std::cbrt(t)
                                       : t / (3 * delta * delta) + 4.0 / 29.0;
    }
    lab[i * 3 + 0] = 116.0 * f[1] - 16.0;
    lab[i * 3 + 1] = 500.0 * (f[0] - f[1]);
    lab[i * 3 + 2] = 200.0 * (f[1] - f[2]);
  }
}

// ---------------------------------------------------------------------------
// SLIC: skimage-contract formulation mirroring ops/slic.py — step-grid
// seeds, ±step search box around the moving centers, strict-< first-k
// tie-breaking, then connectivity enforcement (component split, min-size
// merge into the raster-first large neighbor, sequential raster relabel).
// ---------------------------------------------------------------------------

static int enforce_connectivity_cpp(int32_t* seg, int H, int W, int n_segments) {
  size_t n = size_t(H) * W;
  int min_size = int(std::lround(0.5 * double(H) * W / n_segments));
  std::vector<int32_t> comp(n, -1);
  std::vector<int> comp_size;
  std::vector<int32_t> stack;
  // 4-connected components in raster order of first pixel
  for (size_t i = 0; i < n; i++) {
    if (comp[i] >= 0) continue;
    int32_t id = int32_t(comp_size.size());
    comp_size.push_back(0);
    stack.clear();
    stack.push_back(int32_t(i));
    comp[i] = id;
    while (!stack.empty()) {
      int32_t p = stack.back();
      stack.pop_back();
      comp_size[id]++;
      int y = p / W, x = p % W;
      const int dy[4] = {-1, 1, 0, 0}, dx[4] = {0, 0, -1, 1};
      for (int k = 0; k < 4; k++) {
        int ny = y + dy[k], nx = x + dx[k];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int32_t q = ny * W + nx;
        if (comp[q] < 0 && seg[q] == seg[p]) {
          comp[q] = id;
          stack.push_back(q);
        }
      }
    }
  }
  int n_comp = int(comp_size.size());
  // merge rounds: small component adopts the component of its raster-first
  // large ring pixel (mirrors ops/connectivity.py)
  for (int round = 0; round < 3; round++) {
    std::vector<int32_t> absorb(n_comp);
    for (int c = 0; c < n_comp; c++) absorb[c] = c;
    bool any = false;
    std::vector<int32_t> best(n_comp, int32_t(n));
    for (size_t i = 0; i < n; i++) {
      int32_t c = comp[i];
      if (comp_size[c] >= min_size) continue;
      int y = int(i) / W, x = int(i) % W;
      const int dy[4] = {-1, 1, 0, 0}, dx[4] = {0, 0, -1, 1};
      for (int k = 0; k < 4; k++) {
        int ny = y + dy[k], nx = x + dx[k];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int32_t q = ny * W + nx;
        if (comp[q] != c && comp_size[comp[q]] >= min_size && q < best[c])
          best[c] = q;
      }
    }
    for (int c = 0; c < n_comp; c++)
      if (best[c] < int32_t(n)) {
        absorb[c] = comp[best[c]];
        any = true;
      }
    if (any) {
      std::vector<int> new_size(n_comp, 0);
      for (size_t i = 0; i < n; i++) {
        comp[i] = absorb[comp[i]];
        new_size[comp[i]]++;
      }
      comp_size = new_size;
    } else {
      break;
    }
  }
  // sequential relabel in raster order of first pixel
  std::vector<int32_t> rank(n_comp, -1);
  int32_t next = 0;
  for (size_t i = 0; i < n; i++) {
    if (rank[comp[i]] < 0) rank[comp[i]] = next++;
    seg[i] = rank[comp[i]];
  }
  return next;
}

void slic_run(const float* image, int H, int W, int n_segments,
              double compactness, double sigma, int num_iters, int32_t* segments,
              int* n_labels_out) {
  int step = std::max(1, int(std::lround(std::sqrt(double(H) * W / n_segments))));
  std::vector<int> sy, sx;
  for (int y = step / 2; y < H; y += step) sy.push_back(y);
  for (int x = step / 2; x < W; x += step) sx.push_back(x);
  int gh = int(sy.size()), gw = int(sx.size());
  int K = gh * gw;

  std::vector<double> lab(size_t(H) * W * 3);
  rgb_to_lab(image, H * W, lab.data());
  std::vector<double> feat(size_t(H) * W * 3);
  if (sigma > 0) {
    std::vector<double> chan(size_t(H) * W), blurred(size_t(H) * W);
    for (int c = 0; c < 3; c++) {
      for (size_t i = 0; i < size_t(H) * W; i++) chan[i] = lab[i * 3 + c];
      gaussian_blur_2d(chan.data(), H, W, sigma, blurred.data());
      for (size_t i = 0; i < size_t(H) * W; i++) feat[i * 3 + c] = blurred[i];
    }
  } else {
    feat = lab;
  }

  double ratio = (compactness / step) * (compactness / step);

  // centers: (L, a, b, y, x) seeded at the exact integer step grid
  std::vector<double> centers(size_t(K) * 5);
  for (int gy = 0; gy < gh; gy++)
    for (int gx = 0; gx < gw; gx++) {
      int iy = sy[gy], ix = sx[gx];
      double* c = &centers[size_t(gy * gw + gx) * 5];
      for (int ch = 0; ch < 3; ch++) c[ch] = feat[(size_t(iy) * W + ix) * 3 + ch];
      c[3] = iy;
      c[4] = ix;
    }

  std::vector<int> cell_y(H), cell_x(W);
  for (int y = 0; y < H; y++) cell_y[y] = std::min(y / step, gh - 1);
  for (int x = 0; x < W; x++) cell_x[x] = std::min(x / step, gw - 1);

  std::fill(segments, segments + size_t(H) * W, 0);
  std::vector<double> acc(size_t(K) * 6);
  for (int it = 0; it < num_iters; it++) {
    // assignment: 5x5 candidate cells, ±step box around the current center
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        const double* p = &feat[(size_t(y) * W + x) * 3];
        double best = 1e300;
        int best_k = segments[size_t(y) * W + x];  // keep label if uncovered
        for (int dy = -2; dy <= 2; dy++)
          for (int dx = -2; dx <= 2; dx++) {
            int ny = cell_y[y] + dy, nx = cell_x[x] + dx;
            if (ny < 0 || ny >= gh || nx < 0 || nx >= gw) continue;
            int kk = ny * gw + nx;
            const double* c = &centers[size_t(kk) * 5];
            if (std::abs(y - int(c[3])) > step || std::abs(x - int(c[4])) > step)
              continue;
            double dc = (p[0] - c[0]) * (p[0] - c[0]) +
                        (p[1] - c[1]) * (p[1] - c[1]) +
                        (p[2] - c[2]) * (p[2] - c[2]);
            double ds = (y - c[3]) * (y - c[3]) + (x - c[4]) * (x - c[4]);
            double d = dc + ratio * ds;
            if (d < best) {
              best = d;
              best_k = kk;
            }
          }
        segments[size_t(y) * W + x] = best_k;
      }
    // update
    std::fill(acc.begin(), acc.end(), 0.0);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        int kk = segments[size_t(y) * W + x];
        double* a = &acc[size_t(kk) * 6];
        const double* p = &feat[(size_t(y) * W + x) * 3];
        a[0] += p[0];
        a[1] += p[1];
        a[2] += p[2];
        a[3] += y;
        a[4] += x;
        a[5] += 1.0;
      }
    for (int kk = 0; kk < K; kk++) {
      double cnt = acc[size_t(kk) * 6 + 5];
      if (cnt > 0)
        for (int c = 0; c < 5; c++)
          centers[size_t(kk) * 5 + c] = acc[size_t(kk) * 6 + c] / cnt;
    }
  }

  *n_labels_out = enforce_connectivity_cpp(segments, H, W, n_segments);
}

// ---------------------------------------------------------------------------
// Canny (skimage semantics, exact hysteresis) — mirrors ops/canny.py
// ---------------------------------------------------------------------------

void sobel(const double* in, int h, int w, int axis, double* out) {
  // scipy: derivative [-1,0,1] along `axis`, smoothing [1,2,1] along other
  std::vector<double> tmp(size_t(h) * w);
  if (axis == 0) {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        tmp[size_t(y) * w + x] = in[size_t(reflect_idx(y + 1, h)) * w + x] -
                                 in[size_t(reflect_idx(y - 1, h)) * w + x];
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        out[size_t(y) * w + x] = tmp[size_t(y) * w + reflect_idx(x - 1, w)] +
                                 2 * tmp[size_t(y) * w + x] +
                                 tmp[size_t(y) * w + reflect_idx(x + 1, w)];
  } else {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        tmp[size_t(y) * w + x] = in[size_t(y) * w + reflect_idx(x + 1, w)] -
                                 in[size_t(y) * w + reflect_idx(x - 1, w)];
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        out[size_t(y) * w + x] = tmp[size_t(reflect_idx(y - 1, h)) * w + x] +
                                 2 * tmp[size_t(y) * w + x] +
                                 tmp[size_t(reflect_idx(y + 1, h)) * w + x];
  }
}

void canny_run(const double* gray, int H, int W, double sigma,
               double low_t, double high_t, uint8_t* edges) {
  size_t n = size_t(H) * W;
  // border-bleed-corrected smoothing (constant-mode blur / blurred ones)
  std::vector<double> sm(n), ones(n, 1.0), bleed(n), padded(n);
  {
    // constant-mode gaussian: emulate by zero padding — do via direct loop
    auto k = gaussian_kernel(sigma);
    int r = int(k.size() / 2);
    std::vector<double> t1(n), t2(n), o1(n), o2(n);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        double a = 0, b = 0;
        for (int d = -r; d <= r; d++) {
          int xx = x + d;
          if (xx >= 0 && xx < W) {
            a += k[d + r] * gray[size_t(y) * W + xx];
            b += k[d + r];
          }
        }
        t1[size_t(y) * W + x] = a;
        o1[size_t(y) * W + x] = b;
      }
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        double a = 0, b = 0;
        for (int d = -r; d <= r; d++) {
          int yy = y + d;
          if (yy >= 0 && yy < H) {
            a += k[d + r] * t1[size_t(yy) * W + x];
            b += k[d + r] * o1[size_t(yy) * W + x];
          }
        }
        sm[size_t(y) * W + x] = a / (b + 1e-12);
      }
  }

  std::vector<double> gy(n), gx(n), mag(n);
  sobel(sm.data(), H, W, 0, gy.data());
  sobel(sm.data(), H, W, 1, gx.data());
  for (size_t i = 0; i < n; i++) mag[i] = std::hypot(gy[i], gx[i]);

  auto M = [&](int y, int x) -> double {
    if (y < 0 || y >= H || x < 0 || x >= W) return 0.0;
    return mag[size_t(y) * W + x];
  };

  std::vector<uint8_t> low(n, 0), high(n, 0);
  for (int y = 1; y < H - 1; y++)
    for (int x = 1; x < W - 1; x++) {
      size_t i = size_t(y) * W + x;
      if (mag[i] <= 0) continue;
      double ay = std::fabs(gy[i]), ax = std::fabs(gx[i]);
      int sy = gy[i] >= 0 ? 1 : -1, sx = gx[i] >= 0 ? 1 : -1;
      bool keep;
      if (ax >= ay) {
        double wgt = ax > 0 ? ay / ax : 0.0;
        double p = (1 - wgt) * M(y, x + sx) + wgt * M(y + sy, x + sx);
        double q = (1 - wgt) * M(y, x - sx) + wgt * M(y - sy, x - sx);
        keep = mag[i] >= p && mag[i] >= q;
      } else {
        double wgt = ay > 0 ? ax / ay : 0.0;
        double p = (1 - wgt) * M(y + sy, x) + wgt * M(y + sy, x + sx);
        double q = (1 - wgt) * M(y - sy, x) + wgt * M(y - sy, x - sx);
        keep = mag[i] >= p && mag[i] >= q;
      }
      if (!keep) continue;
      if (mag[i] >= low_t) low[i] = 1;
      if (mag[i] >= high_t) high[i] = 1;
    }

  // hysteresis: flood fill low-components seeded at strong pixels (8-conn)
  std::memset(edges, 0, n);
  std::vector<size_t> stack;
  for (size_t i = 0; i < n; i++)
    if (high[i] && !edges[i]) {
      stack.push_back(i);
      edges[i] = 1;
      while (!stack.empty()) {
        size_t j = stack.back();
        stack.pop_back();
        int y = int(j / W), x = int(j % W);
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int ny = y + dy, nx = x + dx;
            if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
            size_t jj = size_t(ny) * W + nx;
            if (low[jj] && !edges[jj]) {
              edges[jj] = 1;
              stack.push_back(jj);
            }
          }
      }
    }
}

// ---------------------------------------------------------------------------
// Region features (reference semantics; see ops/regions.py docstring)
// ---------------------------------------------------------------------------

void region_features_run(const float* image, const int32_t* segments,
                         const uint8_t* edges, int H, int W, int K,
                         float* features, uint8_t* node_mask) {
  size_t n = size_t(H) * W;
  std::vector<double> gray(n);
  for (size_t i = 0; i < n; i++)
    gray[i] = 0.2989 * image[i * 3] + 0.5870 * image[i * 3 + 1] +
              0.1140 * image[i * 3 + 2];

  // moments
  std::vector<double> m(size_t(K) * 12, 0.0);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      size_t i = size_t(y) * W + x;
      int r = segments[i];
      double* a = &m[size_t(r) * 12];
      for (int c = 0; c < 3; c++) {
        a[c] += image[i * 3 + c];
        a[3 + c] += double(image[i * 3 + c]) * image[i * 3 + c];
      }
      a[6] += gray[i];
      a[7] += gray[i] * gray[i];
      a[8] += y;
      a[9] += x;
      a[10] += edges[i] ? 1.0 : 0.0;
      a[11] += 1.0;
    }

  // perimeter + boundary-contrast neighbor sums via dedup'd foreign labels
  static const int d1[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
  static const int d2[12][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}, {-2, 0},
                                {2, 0},  {0, -2}, {0, 2},  {-1, -1}, {-1, 1},
                                {1, -1}, {1, 1}};
  std::vector<double> peri(K, 0.0), nb_cnt(K, 0.0), nb_sum(size_t(K) * 3, 0.0);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      size_t i = size_t(y) * W + x;
      int own = segments[i];
      int seen1[4];
      int ns1 = 0;
      for (auto& d : d1) {
        int ny = y + d[0], nx = x + d[1];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int lab = segments[size_t(ny) * W + nx];
        if (lab == own) continue;
        bool dup = false;
        for (int s = 0; s < ns1; s++) dup |= seen1[s] == lab;
        if (!dup) {
          seen1[ns1++] = lab;
          peri[lab] += 1.0;
        }
      }
      int seen2[12];
      int ns2 = 0;
      for (auto& d : d2) {
        int ny = y + d[0], nx = x + d[1];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int lab = segments[size_t(ny) * W + nx];
        if (lab == own) continue;
        bool dup = false;
        for (int s = 0; s < ns2; s++) dup |= seen2[s] == lab;
        if (!dup) {
          seen2[ns2++] = lab;
          nb_cnt[lab] += 1.0;
          for (int c = 0; c < 3; c++) nb_sum[size_t(lab) * 3 + c] += image[i * 3 + c];
        }
      }
    }

  for (int r = 0; r < K; r++) {
    float* f = &features[size_t(r) * 15];
    const double* a = &m[size_t(r) * 12];
    double cnt = a[11];
    node_mask[r] = cnt > 0 ? 1 : 0;
    if (cnt <= 0) {
      std::fill(f, f + 15, 0.f);
      continue;
    }
    double mean_rgb[3], var_rgb[3];
    for (int c = 0; c < 3; c++) {
      mean_rgb[c] = a[c] / cnt;
      var_rgb[c] = std::max(a[3 + c] / cnt - mean_rgb[c] * mean_rgb[c], 0.0);
    }
    double mg = a[6] / cnt;
    double vg = std::max(a[7] / cnt - mg * mg, 0.0);
    double contrast = 0.0;
    if (nb_cnt[r] > 0) {
      double d = 0;
      for (int c = 0; c < 3; c++) {
        double nm = nb_sum[size_t(r) * 3 + c] / nb_cnt[r];
        d += (mean_rgb[c] - nm) * (mean_rgb[c] - nm);
      }
      contrast = std::sqrt(d);
    }
    f[0] = float(mean_rgb[0]);
    f[1] = float(mean_rgb[1]);
    f[2] = float(mean_rgb[2]);
    f[3] = float(std::sqrt(var_rgb[0]));
    f[4] = float(std::sqrt(var_rgb[1]));
    f[5] = float(std::sqrt(var_rgb[2]));
    f[6] = float(mg);
    f[7] = float(std::sqrt(vg));
    f[8] = float((a[9] / cnt) / W);   // center_x
    f[9] = float((a[8] / cnt) / H);   // center_y
    f[10] = float(cnt / (double(H) * W));
    f[11] = float(peri[r] * peri[r] / (4.0 * kPi * cnt + 1e-10));
    f[12] = float(contrast);
    f[13] = float(a[10] / cnt);
    f[14] = float(vg);
  }
}

// ---------------------------------------------------------------------------
// RAG (8-connectivity) + Gaussian-product weights
// ---------------------------------------------------------------------------

void rag_run(const int32_t* segments, int H, int W, int K,
             const float* features, float* weights /* K*K */) {
  std::vector<uint8_t> adj(size_t(K) * K, 0);
  auto mark = [&](int a, int b) {
    if (a != b) {
      adj[size_t(a) * K + b] = 1;
      adj[size_t(b) * K + a] = 1;
    }
  };
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      int s = segments[size_t(y) * W + x];
      if (x + 1 < W) mark(s, segments[size_t(y) * W + x + 1]);
      if (y + 1 < H) {
        mark(s, segments[size_t(y + 1) * W + x]);
        if (x + 1 < W) mark(s, segments[size_t(y + 1) * W + x + 1]);
        if (x - 1 >= 0) mark(s, segments[size_t(y + 1) * W + x - 1]);
      }
    }
  std::memset(weights, 0, sizeof(float) * size_t(K) * K);
  for (int i = 0; i < K; i++)
    for (int j = 0; j < K; j++) {
      if (!adj[size_t(i) * K + j]) continue;
      const float* fi = &features[size_t(i) * 15];
      const float* fj = &features[size_t(j) * 15];
      double dc = 0;
      for (int c = 0; c < 3; c++) dc += double(fi[c] - fj[c]) * (fi[c] - fj[c]);
      dc = std::sqrt(dc);
      double dt = std::fabs(double(fi[6]) - fj[6]);
      double de = std::fabs(double(fi[12]) - fj[12]);
      weights[size_t(i) * K + j] =
          float(std::exp(-dc / 0.15) * std::exp(-dt / 0.08) * std::exp(-de / 0.1));
    }
}

}  // namespace

extern "C" {

// Full host-side graph build. image: float32 (H,W,3) in [0,1].
// Outputs: segments (H,W) i32, features (K,15) f32, node_mask (K,) u8,
// weights (K,K) f32, edges (H,W) u8 canny map. K = max_nodes bucket; the
// grid cluster count gh*gw must be ≤ K (returns -1 otherwise).
int cmt_build_region_graph(const float* image, int H, int W, int n_segments,
                           double compactness, double sigma, int num_iters,
                           int K, int32_t* segments, float* features,
                           uint8_t* node_mask, float* weights, uint8_t* edges) {
  int n_labels = 0;
  slic_run(image, H, W, n_segments, compactness, sigma, num_iters, segments,
           &n_labels);
  if (n_labels > K) return -1;

  size_t n = size_t(H) * W;
  std::vector<double> gray(n);
  for (size_t i = 0; i < n; i++)
    gray[i] = 0.2989 * image[i * 3] + 0.5870 * image[i * 3 + 1] +
              0.1140 * image[i * 3 + 2];
  canny_run(gray.data(), H, W, 2.0, 0.1, 0.2, edges);

  region_features_run(image, segments, edges, H, W, K, features, node_mask);
  rag_run(segments, H, W, K, features, weights);
  return n_labels;
}

}  // extern "C"
