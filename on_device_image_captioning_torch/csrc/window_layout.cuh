// Window-layout index arithmetic shared by the window-resident backbone
// kernels. A window layout stores the tokens of a (res x res) grid, rolled
// cyclically by (-shift, -shift), as (image, window, token-in-window) rows:
// row = ((img * Wn + wy) * Wn + wx) * window^2 + ly * window + lx with
// Wn = res / window. The TPU kernels move between such layouts with one-hot
// matrices on the MXU (models/swin.py transition_pieces, ops/stage_boundary.py
// merge_selection); here every move is a source-row computation where a
// kernel reads its input. `ops/window_layout.py::source_rows` mirrors this
// file in numpy and is held to the permutation tables by the CPU tests.
#pragma once

enum RowMap {
  kMapIdentity = 0,    // source row = output row
  kMapTransition = 1,  // window layout at one shift -> window layout at another
  kMapRaster = 2,      // raster rows (img, y, x) -> window layout, shift 0
  kMapMerge = 3,       // 2x2 patch merge: window layout (res) -> window layout (res / 2)
};

// res: side of the SOURCE token grid; window: window side; delta:
// (to_shift - from_shift) mod res for kMapTransition, unused otherwise.
struct Geometry {
  int res;
  int window;
  int delta;
};

// Row of grid position (y, x) of image img in the window layout of a res grid.
__device__ __forceinline__ long window_row(int img, int y, int x, int res,
                                           int window) {
  const int wn = res / window;
  return ((long)img * wn * wn + (y / window) * wn + x / window) *
             (window * window) +
         (y % window) * window + x % window;
}

// Inverse of window_row: (img, y, x) of row r in the window layout of a res grid.
__device__ __forceinline__ void window_pos(long r, int res, int window,
                                           int* img, int* y, int* x) {
  const int n = window * window;
  const int wn = res / window;
  const long per_img = (long)res * res;
  *img = (int)(r / per_img);
  const int f = (int)(r % per_img);
  const int w = f / n, p = f % n;
  *y = (w / wn) * window + p / window;
  *x = (w % wn) * window + p % window;
}

// Source row that output row r reads. seg selects the 2x2 neighbour of
// kMapMerge in the reference's concat order (even,even), (odd,even),
// (even,odd), (odd,odd): row offset seg & 1, column offset seg >> 1.
__device__ __forceinline__ long map_row(int map, long r, int seg, Geometry g) {
  if (map == kMapIdentity) return r;
  int img, y, x;
  if (map == kMapMerge) {
    window_pos(r, g.res / 2, g.window, &img, &y, &x);
    return window_row(img, 2 * y + (seg & 1), 2 * x + (seg >> 1), g.res,
                      g.window);
  }
  window_pos(r, g.res, g.window, &img, &y, &x);
  if (map == kMapRaster) return ((long)img * g.res + y) * g.res + x;
  // kMapTransition: output position (y, x) of the TO layout holds spatial
  // token (y + to_shift, x + to_shift), which the FROM layout keeps at
  // (y + to_shift - from_shift, x + to_shift - from_shift), all mod res.
  return window_row(img, (y + g.delta) % g.res, (x + g.delta) % g.res, g.res,
                    g.window);
}
