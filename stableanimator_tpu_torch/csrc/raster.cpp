// First-party rasterisation kernels for skeleton rendering.
//
// The reference rasterises OpenPose skeletons with OpenCV's drawing
// primitives (cv2.ellipse2Poly + cv2.fillConvexPoly / cv2.circle /
// cv2.line — reference DWPose/skeleton_extraction.py:16-100). Pose renders
// feed the diffusion model, so they must match the reference BYTE-FOR-BYTE;
// this module therefore re-implements the exact discrete algorithms OpenCV
// documents for LINE_8/shift-0 drawing (fixed-point convex-polygon scan
// conversion, midpoint circle with span fill, thick lines as a quad plus
// round caps, 8-connected Bresenham borders) rather than approximating the
// shapes geometrically. Verified byte-identical against cv2 by
// tests/test_preproc.py::TestNativeRaster over randomized primitives.
//
// Version note: this implements the classic (OpenCV 4.x) algorithms, which
// are also exactly what the public cv2 5.0 API exposes for fillConvexPoly /
// circle / ellipse2Poly at any coordinates. cv2 5.0 changed only the
// INTERNAL rasterisation of thick lines whose quad crosses the canvas
// border (cv2.line there no longer equals its own documented
// fillConvexPoly(quad, shift=16) + circle(caps) decomposition; measured:
// 1-2 border-pixel diffs on strokes within thickness+1 px of the edge,
// byte-identical otherwise). We keep the classic semantics: they match the
// public-API composition, the reference's unpinned-at-publication OpenCV
// 4.x, and the diffs vanish in draw_pose's 4x downresize.
//
// Exposed through a C ABI and loaded via ctypes (no pybind11 dependency).
// Build: make -C native  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Canvas {
  uint8_t* data;
  int h, w, c;
  inline uint8_t* px(int x, int y) const {
    return data + (static_cast<int64_t>(y) * w + x) * c;
  }
  inline void put(int x, int y, const uint8_t* color) const {
    if (x < 0 || y < 0 || x >= w || y >= h) return;
    std::memcpy(px(x, y), color, c);
  }
  // inclusive horizontal span; caller guarantees y in range and x clamped
  inline void hline(int y, int x0, int x1, const uint8_t* color) const {
    for (int x = x0; x <= x1; ++x) std::memcpy(px(x, y), color, c);
  }
};

inline int cv_round(double v) { return static_cast<int>(std::lrint(v)); }

// ---------------------------------------------------------------------------
// integer line clip (Cohen-Sutherland as OpenCV's clipLine)
// ---------------------------------------------------------------------------

bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1,
               int64_t& x2, int64_t& y2) {
  if (width <= 0 || height <= 0) return false;
  const int64_t right = width - 1, bottom = height - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (a - y1) * (x2 - x1) / (y2 - y1);
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (a - y2) * (x2 - x1) / (y2 - y1);
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (a - x1) * (y2 - y1) / (x2 - x1);
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (a - x2) * (y2 - y1) / (x2 - x1);
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// ---------------------------------------------------------------------------
// 8-connected Bresenham (OpenCV LineIterator semantics, leftToRight)
// ---------------------------------------------------------------------------

void line8(const Canvas& cv, int ix1, int iy1, int ix2, int iy2,
           const uint8_t* color) {
  int64_t x1 = ix1, y1 = iy1, x2 = ix2, y2 = iy2;
  if (!clip_line(cv.w, cv.h, x1, y1, x2, y2)) return;
  int dx = static_cast<int>(x2 - x1), dy = static_cast<int>(y2 - y1);
  int s = dx < 0 ? -1 : 0;
  dx = (dx ^ s) - s;
  dy = (dy ^ s) - s;
  if (s) {
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  s = dy < 0 ? -1 : 0;
  dy = (dy ^ s) - s;
  const int ystep = s ? -1 : 1;
  const bool swapped = dy > dx;
  if (swapped) std::swap(dx, dy);
  int minus_dx, minus_dy, plus_dx, plus_dy;
  if (!swapped) {
    minus_dx = 1; minus_dy = 0; plus_dx = 0; plus_dy = ystep;
  } else {
    minus_dx = 0; minus_dy = ystep; plus_dx = 1; plus_dy = 0;
  }
  int err = dx - (dy + dy);
  const int plus_delta = dx + dx;
  const int minus_delta = -(dy + dy);
  const int count = dx + 1;
  int x = static_cast<int>(x1), y = static_cast<int>(y1);
  for (int i = 0; i < count; ++i) {
    cv.put(x, y, color);
    const int mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    x += minus_dx + (plus_dx & mask);
    y += minus_dy + (plus_dy & mask);
  }
}

// ---------------------------------------------------------------------------
// fixed-point line for XY_SHIFT-shifted polygon borders (OpenCV Line2)
// ---------------------------------------------------------------------------

void line2(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2,
           const uint8_t* color) {
  const int64_t sw = static_cast<int64_t>(cv.w) << XY_SHIFT;
  const int64_t sh = static_cast<int64_t>(cv.h) << XY_SHIFT;
  if (!clip_line(sw, sh, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t j = dx < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j;
  const int64_t i = dy < 0 ? -1 : 0;
  const int64_t ay = (dy ^ i) - i;

  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    if (j) {
      std::swap(x1, x2);
      std::swap(y1, y2);
      dy = -dy;
    }
    x_step = XY_ONE;
    y_step = dy * XY_ONE / (ax | 1);
    ecount = static_cast<int>((x2 - x1) >> XY_SHIFT);
  } else {
    if (i) {
      std::swap(x1, x2);
      std::swap(y1, y2);
      dx = -dx;
    }
    x_step = dx * XY_ONE / (ay | 1);
    y_step = XY_ONE;
    ecount = static_cast<int>((y2 - y1) >> XY_SHIFT);
  }
  x1 += XY_ONE >> 1;
  y1 += XY_ONE >> 1;

  cv.put(static_cast<int>((x2 + (XY_ONE >> 1)) >> XY_SHIFT),
         static_cast<int>((y2 + (XY_ONE >> 1)) >> XY_SHIFT), color);
  if (x_step == XY_ONE) {
    x1 >>= XY_SHIFT;
    while (ecount >= 0) {
      cv.put(static_cast<int>(x1),
             static_cast<int>(y1 >> XY_SHIFT), color);
      x1++;
      y1 += y_step;
      ecount--;
    }
  } else {
    y1 >>= XY_SHIFT;
    while (ecount >= 0) {
      cv.put(static_cast<int>(x1 >> XY_SHIFT),
             static_cast<int>(y1), color);
      x1 += x_step;
      y1++;
      ecount--;
    }
  }
}

// ---------------------------------------------------------------------------
// convex polygon scan fill (OpenCV FillConvexPoly, LINE_8)
// ---------------------------------------------------------------------------

struct P64 { int64_t x, y; };

void fill_convex_poly(const Canvas& cv, const P64* v, int npts,
                      const uint8_t* color, int shift) {
  struct { int idx, di; int64_t x, dx; int ye; } edge[2];

  const int delta = (1 << shift) >> 1;
  int i, y, imin = 0;
  int edges = npts;
  const int delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;  // LINE_8

  P64 p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;

  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  for (i = 0; i < npts; i++) {
    P64 p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (shift == 0) {
      line8(cv, static_cast<int>(p0.x >> XY_SHIFT),
            static_cast<int>(p0.y >> XY_SHIFT),
            static_cast<int>(p.x >> XY_SHIFT),
            static_cast<int>(p.y >> XY_SHIFT), color);
    } else {
      line2(cv, p0.x, p0.y, p.x, p.y, color);
    }
    p0 = p;
  }

  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;

  if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 ||
      static_cast<int>(xmin) >= cv.w || static_cast<int>(ymin) >= cv.h)
    return;

  ymax = std::min<int64_t>(ymax, cv.h - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y = static_cast<int>(ymin);
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;

  do {
    for (i = 0; i < 2; i++) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        int ty = 0;
        for (; edges-- > 0;) {
          ty = static_cast<int>((v[idx].y + delta) >> shift);
          if (ty > y) {
            int64_t xs = v[idx0].x;
            int64_t xe = v[idx].x;
            if (shift != XY_SHIFT) {
              xs <<= XY_SHIFT - shift;
              xe <<= XY_SHIFT - shift;
            }
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;

    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = static_cast<int>((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = static_cast<int>((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < cv.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= cv.w) xx2 = cv.w - 1;
        cv.hline(y, xx1, xx2, color);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= static_cast<int>(ymax));
}

// ---------------------------------------------------------------------------
// midpoint circle with span fill (OpenCV Circle, fill=1)
// ---------------------------------------------------------------------------

void circle_fill(const Canvas& cv, int cx, int cy, int radius,
                 const uint8_t* color) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const bool inside = cx >= radius && cx < cv.w - radius && cy >= radius &&
                      cy < cv.h - radius;
  while (dx >= dy) {
    const int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      cv.hline(y11, x11, x12, color);
      cv.hline(y12, x11, x12, color);
      cv.hline(y21, x21, x22, color);
      cv.hline(y22, x21, x22, color);
    } else if (x11 < cv.w && x12 >= 0 && y21 < cv.h && y22 >= 0) {
      x11 = std::max(x11, 0);
      x12 = std::min(x12, cv.w - 1);
      if (static_cast<unsigned>(y11) < static_cast<unsigned>(cv.h))
        cv.hline(y11, x11, x12, color);
      if (static_cast<unsigned>(y12) < static_cast<unsigned>(cv.h))
        cv.hline(y12, x11, x12, color);
      if (x21 < cv.w && x22 >= 0) {
        x21 = std::max(x21, 0);
        x22 = std::min(x22, cv.w - 1);
        if (static_cast<unsigned>(y21) < static_cast<unsigned>(cv.h))
          cv.hline(y21, x21, x22, color);
        if (static_cast<unsigned>(y22) < static_cast<unsigned>(cv.h))
          cv.hline(y22, x21, x22, color);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    const int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ---------------------------------------------------------------------------
// ellipse2Poly (OpenCV: per-degree sin table in float)
// ---------------------------------------------------------------------------

const float* sin_table() {
  // OpenCV's SinTable is a HARDCODED literal array of sin(i deg) printed to
  // 7 decimal places (so e.g. entry 360 is exactly 0.0f, not sin(2*pi) =
  // -2.45e-16). Reproducing that decimal quantisation is required for
  // byte-parity: the table feeds .5-exact pixel coordinates whose
  // round-half-even direction flips with the last float bits (verified:
  // 0/3000 poly mismatches with this table vs 11/3000 with plain sinf).
  static float table[451];
  static bool init = false;
  if (!init) {
    for (int i = 0; i <= 450; ++i)
      table[i] = static_cast<float>(
          std::round(std::sin(i * M_PI / 180.0) * 1e7) / 1e7);
    init = true;
  }
  return table;
}

int ellipse2poly(int cx, int cy, int a, int b, int angle, int delta,
                 P64* out /* >= 360/delta + 2 */) {
  const float* st = sin_table();
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  const int arc_start = 0, arc_end = 360;
  const double alpha = st[450 - angle], beta = st[angle];
  int n = 0;
  for (int i = arc_start; i < arc_end + delta; i += delta) {
    int ang = i > arc_end ? arc_end : i;
    // NB: promote to double BEFORE the multiply — OpenCV's axes are Size2d,
    // so axes.width * SinTable[...] is a double*float product; an int*float
    // product would round to f32 first and flip .5-boundary pixels
    const double x = static_cast<double>(a) * st[450 - ang];
    const double y = static_cast<double>(b) * st[ang];
    const int64_t px = cv_round(cx + x * alpha - y * beta);
    const int64_t py = cv_round(cy + x * beta + y * alpha);
    // cv::ellipse2Poly de-duplicates consecutive equal rounded points
    if (n > 0 && out[n - 1].x == px && out[n - 1].y == py) continue;
    out[n].x = px;
    out[n].y = py;
    n++;
  }
  if (n == 1) {
    out[0] = out[1] = P64{cx, cy};
    n = 2;
  }
  return n;
}

}  // namespace

extern "C" {

// cv2.ellipse2Poly((cx,cy),(a,b),angle,0,360,delta) + cv2.fillConvexPoly
void cv_fill_ellipse(uint8_t* canvas, int h, int w, int c, int cx, int cy,
                     int a, int b, int angle, int delta,
                     const uint8_t* color) {
  Canvas cv{canvas, h, w, c};
  P64 pts[364];
  if (delta < 1) delta = 1;
  const int n = ellipse2poly(cx, cy, a, b, angle, delta, pts);
  fill_convex_poly(cv, pts, n, color, 0);
}

// cv2.fillConvexPoly(canvas, pts, color) with integer points, LINE_8
void cv_fill_convex_poly(uint8_t* canvas, int h, int w, int c,
                         const int64_t* pts_xy, int npts,
                         const uint8_t* color) {
  Canvas cv{canvas, h, w, c};
  P64 stackpts[512];
  if (npts <= 0 || npts > 512) return;
  for (int i = 0; i < npts; ++i)
    stackpts[i] = P64{pts_xy[2 * i], pts_xy[2 * i + 1]};
  fill_convex_poly(cv, stackpts, npts, color, 0);
}

// cv2.circle(canvas, (cx,cy), radius, color, thickness=-1)
void cv_fill_circle(uint8_t* canvas, int h, int w, int c, int cx, int cy,
                    int radius, const uint8_t* color) {
  Canvas cv{canvas, h, w, c};
  circle_fill(cv, cx, cy, radius, color);
}

// cv2.line(canvas, p0, p1, color, thickness) for thickness >= 2
// (OpenCV ThickLine: fixed-point quad via FillConvexPoly + round caps)
void cv_thick_line(uint8_t* canvas, int h, int w, int c, int x0, int y0,
                   int x1, int y1, int thickness, const uint8_t* color) {
  Canvas cv{canvas, h, w, c};
  int64_t p0x = static_cast<int64_t>(x0) << XY_SHIFT;
  int64_t p0y = static_cast<int64_t>(y0) << XY_SHIFT;
  const int64_t p1x = static_cast<int64_t>(x1) << XY_SHIFT;
  const int64_t p1y = static_cast<int64_t>(y1) << XY_SHIFT;

  const double inv_one = 1.0 / XY_ONE;
  const double dx = (p0x - p1x) * inv_one, dy = (p1y - p0y) * inv_one;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = static_cast<int64_t>(thickness) << (XY_SHIFT - 1);

  if (std::fabs(r) > 2.2e-16) {
    r = (th + odd * XY_ONE * 0.5) / std::sqrt(r);
    const int64_t dpx = cv_round(dy * r);
    const int64_t dpy = cv_round(dx * r);
    P64 pt[4];
    pt[0] = P64{p0x + dpx, p0y + dpy};
    pt[1] = P64{p0x - dpx, p0y - dpy};
    pt[2] = P64{p1x - dpx, p1y - dpy};
    pt[3] = P64{p1x + dpx, p1y + dpy};
    fill_convex_poly(cv, pt, 4, color, XY_SHIFT);
  }
  // round caps at both ends
  for (int i = 0; i < 2; ++i) {
    const int ccx = static_cast<int>((p0x + (XY_ONE >> 1)) >> XY_SHIFT);
    const int ccy = static_cast<int>((p0y + (XY_ONE >> 1)) >> XY_SHIFT);
    circle_fill(cv, ccx, ccy,
                static_cast<int>((th + (XY_ONE >> 1)) >> XY_SHIFT), color);
    p0x = p1x;
    p0y = p1y;
  }
}

// numpy's (canvas * factor).astype(np.uint8): float multiply, truncate
void scale_canvas(uint8_t* canvas, int64_t n, double factor) {
  for (int64_t i = 0; i < n; ++i)
    canvas[i] = static_cast<uint8_t>(canvas[i] * factor);
}

}  // extern "C"
