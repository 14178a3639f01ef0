// Contour tracing of the box protocol: the port's counterpart of
// cv2.threshold + cv2.findContours(RETR_TREE, CHAIN_APPROX_SIMPLE) +
// cv2.contourArea + cv2.boundingRect on a uint8-rendered score map.
//
// The tracer is Suzuki and Abe's border follower (1985) with OpenCV's
// conventions: the mask is padded with one zero pixel on every side; a
// raster scan starts an outer border at a 1-pixel whose left neighbour is
// 0 and a hole border at a 1-pixel whose right neighbour is 0; a border is
// followed over the 8-neighbourhood, searched clockwise from the starting
// 0-pixel for its second point and counter-clockwise after that; a border
// pixel whose right neighbour was examined as 0 is marked -label, any other
// unmarked one +label.  A hole border is traced on the foreground pixels
// around the hole.  Each border's parent is Suzuki's: the border B' met last
// in the scan (LNBD) if one is an outer border and the other a hole, else
// B''s parent.  The borders are returned in OpenCV's order: depth-first,
// each border before its children, the children of a border (and the
// top-level borders) from the last found to the first.
//
// A border's area is contourArea's: the absolute shoelace area of the
// traced polygon (a one-pixel or one-line component has area 0); it is
// kept doubled, as an integer.  Its rectangle is boundingRect's: the
// traced points' extent, with width and height counting pixels.
//
// C ABI (ctypes):
//   int64_t contour_sweep(const uint8_t* img, int h, int w,
//                         const int32_t* levels, int n_levels, int multi,
//                         int64_t* out, int64_t cap);
//     For each level t, the borders of img > t.  multi = 0: the first
//     border of largest area (Python's max over the cv2 list); multi = 1:
//     every border, in order.  Writes rows (level index, x, y, width,
//     height, doubled area) while they fit in cap rows; returns the
//     number of rows (more than cap: call again with a larger buffer).
//   int64_t trace_contours(const uint8_t* img, int h, int w, int level,
//                          int32_t* pts, int64_t pts_cap,
//                          int32_t* meta, int64_t meta_cap);
//     The borders of img > level with CHAIN_APPROX_SIMPLE's points:
//     meta rows (first point, point count, parent index or -1, is_hole)
//     in order, pts (x, y) pairs.  Returns the border count, or -1 when a
//     buffer is too small.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC contours.cpp \
//            -o libcontours.so

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
constexpr int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Border {
  int parent;      // index, -1 for the frame
  bool hole;
  int x0, y0, x1, y1;
  int64_t area2;   // doubled absolute shoelace area
  int64_t first_pt, n_pts;
};

struct Tracer {
  int h = 0, w = 0, stride = 0;
  int delta[16];
  std::vector<int32_t> lab;   // padded: 0 background, 1 foreground, +-k
  std::vector<Border> borders;
  std::vector<int32_t> pts;   // APPROX_SIMPLE points when keep_points
  bool keep_points = false;

  void reset(const uint8_t* img, int hh, int ww, int level) {
    h = hh;
    w = ww;
    stride = w + 2;
    lab.assign(static_cast<size_t>(h + 2) * stride, 0);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = img + static_cast<size_t>(y) * w;
      int32_t* dst = lab.data() + static_cast<size_t>(y + 1) * stride + 1;
      for (int x = 0; x < w; ++x) dst[x] = row[x] > level ? 1 : 0;
    }
    for (int s = 0; s < 8; ++s) delta[s] = delta[s + 8] =
        kDy[s] * stride + kDx[s];
    borders.clear();
    pts.clear();
  }

  // Follows the border starting at padded index i0 (OpenCV's
  // icvFetchContour); label >= 2.
  void follow(int i0, bool hole, int label, Border& b) {
    const int32_t* L = lab.data();
    int px = i0 % stride - 1, py = i0 / stride - 1;   // unpadded point
    b.x0 = b.x1 = px;
    b.y0 = b.y1 = py;
    b.first_pt = static_cast<int64_t>(pts.size()) / 2;
    int64_t acc = 0;
    const int sx = px, sy = py;
    int s_end = hole ? 0 : 4, s = s_end;
    int i1;
    do {
      s = (s - 1) & 7;
      i1 = i0 + delta[s];
    } while (L[i1] == 0 && s != s_end);
    if (s == s_end) {  // a single pixel
      lab[i0] = -label;
      if (keep_points) { pts.push_back(px); pts.push_back(py); }
      b.area2 = 0;
      b.n_pts = 1;
      return;
    }
    int i3 = i0, i4 = 0, prev_s = s ^ 4;
    for (;;) {
      s_end = s;
      while (s < 15) {
        i4 = i3 + delta[++s];
        if (L[i4] != 0) break;
      }
      s &= 7;
      if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end))
        lab[i3] = -label;
      else if (lab[i3] == 1)
        lab[i3] = label;
      if (s != prev_s) {
        if (keep_points) { pts.push_back(px); pts.push_back(py); }
        prev_s = s;
      }
      const int nx = px + kDx[s], ny = py + kDy[s];
      acc += static_cast<int64_t>(px) * ny - static_cast<int64_t>(nx) * py;
      px = nx;
      py = ny;
      if (px < b.x0) b.x0 = px;
      if (px > b.x1) b.x1 = px;
      if (py < b.y0) b.y0 = py;
      if (py > b.y1) b.y1 = py;
      if (i4 == i0 && i3 == i1) break;
      i3 = i4;
      s = (s + 4) & 7;
    }
    // the walk ends back at the start: acc is the closed polygon's sum
    (void)sx;
    (void)sy;
    b.area2 = acc < 0 ? -acc : acc;
    b.n_pts = static_cast<int64_t>(pts.size()) / 2 - b.first_pt;
  }

  void trace() {
    int32_t* L = lab.data();
    for (int y = 1; y <= h; ++y) {
      int lnbd = -1;  // the frame
      int32_t* row = L + static_cast<size_t>(y) * stride;
      for (int x = 1; x <= w; ++x) {
        const int32_t f = row[x];
        if (f == 0) continue;
        bool start = false, hole = false;
        if (f == 1 && row[x - 1] == 0) {
          start = true;
        } else if (f >= 1 && row[x + 1] == 0) {
          start = true;
          hole = true;
          if (f > 1) lnbd = f - 2;
        }
        if (start) {
          int parent = -1;
          if (lnbd >= 0) {
            const Border& bp = borders[lnbd];
            parent = (bp.hole == hole) ? bp.parent : lnbd;
          }
          const int label = static_cast<int>(borders.size()) + 2;
          Border b;
          b.parent = parent;
          b.hole = hole;
          follow(y * stride + x, hole, label, b);
          borders.push_back(b);
        }
        const int32_t g = row[x];
        if (g != 1) lnbd = (g < 0 ? -g : g) - 2;
      }
    }
  }

  // OpenCV's output order: depth-first, children from the last found.
  void order(std::vector<int>& out) const {
    const int n = static_cast<int>(borders.size());
    std::vector<int> head(n + 1, -1), next(n, -1);
    // prepend in discovery order: each list runs last found first
    for (int i = 0; i < n; ++i) {
      const int p = borders[i].parent + 1;
      next[i] = head[p];
      head[p] = i;
    }
    out.clear();
    std::vector<int> stack;
    for (int c = head[0]; c != -1; c = next[c]) stack.push_back(c);
    std::reverse(stack.begin(), stack.end());
    while (!stack.empty()) {
      const int v = stack.back();
      stack.pop_back();
      out.push_back(v);
      const size_t mark = stack.size();
      for (int c = head[v + 1]; c != -1; c = next[c]) stack.push_back(c);
      std::reverse(stack.begin() + mark, stack.end());
    }
  }
};

}  // namespace

extern "C" {

int64_t contour_sweep(const uint8_t* img, int h, int w, const int32_t* levels,
                      int n_levels, int multi, int64_t* out, int64_t cap) {
  Tracer t;
  std::vector<int> ord;
  int64_t rows = 0;
  auto emit = [&](int li, const Border& b) {
    if (rows < cap) {
      int64_t* r = out + rows * 6;
      r[0] = li;
      r[1] = b.x0;
      r[2] = b.y0;
      r[3] = b.x1 - b.x0 + 1;
      r[4] = b.y1 - b.y0 + 1;
      r[5] = b.area2;
    }
    ++rows;
  };
  for (int li = 0; li < n_levels; ++li) {
    t.reset(img, h, w, levels[li]);
    t.trace();
    if (t.borders.empty()) continue;
    t.order(ord);
    if (multi) {
      for (int i : ord) emit(li, t.borders[i]);
    } else {
      int best = ord[0];
      for (int i : ord)
        if (t.borders[i].area2 > t.borders[best].area2) best = i;
      emit(li, t.borders[best]);
    }
  }
  return rows;
}

int64_t trace_contours(const uint8_t* img, int h, int w, int level,
                       int32_t* pts, int64_t pts_cap, int32_t* meta,
                       int64_t meta_cap) {
  Tracer t;
  t.keep_points = true;
  t.reset(img, h, w, level);
  t.trace();
  std::vector<int> ord;
  t.order(ord);
  const int64_t n = static_cast<int64_t>(ord.size());
  const int64_t n_pts = static_cast<int64_t>(t.pts.size()) / 2;
  if (n > meta_cap || n_pts > pts_cap) return -1;
  std::vector<int> pos(t.borders.size());
  for (int64_t k = 0; k < n; ++k) pos[ord[k]] = static_cast<int>(k);
  int64_t at = 0;
  for (int64_t k = 0; k < n; ++k) {
    const Border& b = t.borders[ord[k]];
    meta[k * 4 + 0] = static_cast<int32_t>(at);
    meta[k * 4 + 1] = static_cast<int32_t>(b.n_pts);
    meta[k * 4 + 2] = b.parent < 0 ? -1 : pos[b.parent];
    meta[k * 4 + 3] = b.hole ? 1 : 0;
    for (int64_t j = 0; j < b.n_pts; ++j) {
      pts[(at + j) * 2] = t.pts[(b.first_pt + j) * 2];
      pts[(at + j) * 2 + 1] = t.pts[(b.first_pt + j) * 2 + 1];
    }
    at += b.n_pts;
  }
  return n;
}

}  // extern "C"
