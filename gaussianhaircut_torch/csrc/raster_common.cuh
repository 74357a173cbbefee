// Shared by raster_fwd.cu, raster_bwd.cu and raster_probe.cu: the payload
// layout, the per-(pixel, instance) blend arithmetic, the warps' pixel
// footprints, the exact per-warp cull and the staging of a chunk.  Both
// compositing kernels must take the same early-stop decisions, so the
// arithmetic lives here once and every file is compiled with -fmad=false
// (no contraction that could differ between them).
#pragma once

#include <cuda_runtime.h>

namespace ghraster {

// payload rows (gaussianhaircut_torch/ops/rasterize/common.py)
constexpr int kGX = 0, kGY = 1, kCA = 2, kCB = 3, kCC = 4, kOP = 5;
constexpr int kPayloadRows = 24;
constexpr int kColorRow = 8;
constexpr int kNumChannels = 10;
constexpr int kPadChannels = 16;
constexpr int kGradRows = 6 + kNumChannels;
constexpr int kGeoRows = 6;

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

constexpr unsigned kFull = 0xffffffffu;

// Each warp owns an 8x4 block of its tile's pixels (the tile needs a width
// that is a multiple of 8 and a height that is a multiple of 4); warp w is
// block (w % (tile_w / 8), w / (tile_w / 8)), lane l pixel (l % 8, l / 8)
// of it.  A pixel keeps its tile-buffer index y * tile_w + x.
constexpr int kFootW = 8, kFootH = 4;

// The forward and the probe split each tile over kTileSplit blocks, each
// of a run of the tile's warps, so that a block waiting at a barrier
// leaves the SM to the others (a tile's 1024 threads at 64 registers fill
// an SM alone).  tile_split gives the split a tile of `pixels` takes: at
// most kTileSplit, and a whole number of warps per block.
constexpr int kTileSplit = 2;

inline int tile_split(int pixels) {
  int split = kTileSplit;
  while (split > 1 && (pixels / 32) % split) split /= 2;
  return split;
}

struct Pixel {
  int x, y;  // within the tile
};

__device__ __forceinline__ Pixel footprint_pixel(int warp, int lane, int tile_w) {
  const int nwx = tile_w / kFootW;
  return {(warp % nwx) * kFootW + (lane & (kFootW - 1)),
          (warp / nwx) * kFootH + lane / kFootW};
}

// Gaussian exponent, as the plain version writes it:
// power = -0.5 (a dx^2 + c dy^2) - b dx dy with dx = gx - px.
__device__ __forceinline__ float gauss_power(float a, float b, float c,
                                             float dx, float dy) {
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// ---------------------------------------------------------------------------
// The exact per-warp cull.  A pair (pixel, instance) is a candidate when the
// kernels' float test accepts it: power <= 0 (in the forward also a NaN
// power) and min(0.99, op exp(power)) >= 1/255.  Only a candidate can blend
// or stop its pixel, so a warp may skip an instance none of whose pixels is
// a candidate, and every output stays bit for bit what it was.
//
// warp_mask gives the warps whose 8x4 block meets a box that holds every
// candidate pixel of the instance.  With q = a dx^2 + 2 b dx dy + c dy^2,
// exact arithmetic accepts q <= 2 L, L = ln(op / (1/255)).  The float power
// differs from the exact one by at most 4u (Q + |power|), u = 2^-24,
// Q = a dx^2 + c dy^2 <= K q, K = (a + c)^2 / det; so a candidate has
// q <= 2 L' / (1 - 8 u K - 4 u), L' = L + 1e-3 (the 1e-3 covers exp's
// error and underflow).  The box is that ellipse's, a dx^2 .. <= 2 L' / ...
// with half-extents sqrt(qmax c / det) and sqrt(qmax a / det), padded by one
// pixel (more than the rounding of dx = gx - px).  All in double, whose
// +, -, *, / and sqrt round as the plain mirror's (plain_core.
// warp_masks_plain) do.
//
// Never culled (every bit set): non-finite values; |gx|, |gy| >= 2^20 or
// |a|, |b|, |c|, |op| >= 2^40 or a tile beyond 2^20 pixels (there the float
// power could overflow, and a NaN power blends in the forward); a conic that
// is not positive definite or has K > 2^20.  Always culled: op < 1/255
// (alpha <= op then, so no pixel passes).
constexpr double kCullPad = 1.0;
constexpr double kCullSlack = 1e-3;
constexpr double kCullMaxPos = 1048576.0;         // 2^20
constexpr double kCullMaxVal = 1099511627776.0;   // 2^40
constexpr double kCullMaxCond = 1048576.0;        // 2^20
constexpr double kCullU = 5.9604644775390625e-08;  // 2^-24

__device__ __forceinline__ unsigned warp_mask(float gx, float gy, float a, float b,
                                              float c, float op, int x0, int y0,
                                              int tile_w, int tile_h) {
  const int nwx = tile_w / kFootW, nwy = tile_h / kFootH;
  const int nw = nwx * nwy;
  const unsigned all = nw >= 32 ? kFull : ((1u << nw) - 1u);
  const double X = gx, Y = gy, A = a, B = b, Cc = c, O = op;
  const bool tame = fabs(X) < kCullMaxPos && fabs(Y) < kCullMaxPos &&
                    fabs(A) < kCullMaxVal && fabs(B) < kCullMaxVal &&
                    fabs(Cc) < kCullMaxVal && fabs(O) < kCullMaxVal &&
                    x0 + tile_w <= kCullMaxPos && y0 + tile_h <= kCullMaxPos;
  if (!tame) return all;  // also every NaN
  if (op < kAlphaMin) return 0u;
  const double det = A * Cc - B * B;
  if (!(A > 0.0) || !(det > 0.0)) return all;
  const double tr = A + Cc;
  const double cond = tr * tr / det;
  if (cond > kCullMaxCond) return all;
  const double lim = log(O / static_cast<double>(kAlphaMin)) + kCullSlack;
  const double qmax = 2.0 * lim / (1.0 - 8.0 * kCullU * cond - 4.0 * kCullU);
  const double ex = sqrt(qmax * Cc / det) + kCullPad;
  const double ey = sqrt(qmax * A / det) + kCullPad;
  const double bx0 = X - ex, bx1 = X + ex, by0 = Y - ey, by1 = Y + ey;
  unsigned cols = 0u;
  for (int i = 0; i < nwx; ++i) {
    const double lo = static_cast<double>(x0 + i * kFootW);
    if (lo <= bx1 && lo + (kFootW - 1) >= bx0) cols |= 1u << i;
  }
  unsigned mask = 0u;
  for (int i = 0; i < nwy; ++i) {
    const double lo = static_cast<double>(y0 + i * kFootH);
    if (lo <= by1 && lo + (kFootH - 1) >= by0) mask |= cols << (i * nwx);
  }
  return mask;
}

// Where a tile starts, in pixels of its image.  A grid of B images stacks
// them as a virtual grid of B * grid_y tile rows (image b's rows are
// [b * grid_y, (b + 1) * grid_y)), so a tile's row within its own image is
// (tile / grid_x) % grid_y, the TPU kernels' rule (pallas_core.py:471-475,
// 827-829).  A grid that covers a window of one image's rows starts at row0
// (a whole number of tile rows): the tile-row mesh step renders such
// windows, and the pixel coordinates stay the whole image's, so a window's
// tiles are the whole render's bit for bit.
struct TileOrigin {
  int x0, y0;
};

__device__ __forceinline__ TileOrigin tile_origin(int tile, int grid_x, int grid_y,
                                                  int tile_w, int tile_h, int row0 = 0) {
  return {(tile % grid_x) * tile_w, row0 + ((tile / grid_x) % grid_y) * tile_h};
}

// Stage one chunk into shared memory, instance-major: instance j as 16
// floats s_inst[4 j .. 4 j + 3] = (gx, gy, a, b), (c, op, colour 0, 1),
// (colour 2..5), (colour 6..9), so that a warp reads an instance with four
// broadcast 16-byte loads; and its warp mask as s_mask[j].  Threads j < ch
// load instance j's geometry (coalesced across j) and compute its mask; all
// threads copy the colours.
constexpr int kInstFloats = kGeoRows + kNumChannels;   // 16

__device__ __forceinline__ void stage_chunk(const float* __restrict__ pay,
                                            float4* s_inst, unsigned* s_mask, int ch,
                                            TileOrigin o, int tile_w, int tile_h) {
  float* s = reinterpret_cast<float*>(s_inst);
  for (int j = threadIdx.x; j < ch; j += blockDim.x) {
    float g[kGeoRows];
#pragma unroll
    for (int r = 0; r < kGeoRows; ++r) {
      g[r] = pay[r * ch + j];
      s[j * kInstFloats + r] = g[r];
    }
    s_mask[j] = warp_mask(g[kGX], g[kGY], g[kCA], g[kCB], g[kCC], g[kOP],
                          o.x0, o.y0, tile_w, tile_h);
  }
  const float* col = pay + kColorRow * ch;
  for (int i = threadIdx.x; i < kNumChannels * ch; i += blockDim.x) {
    const int r = i / ch;
    s[(i - r * ch) * kInstFloats + kGeoRows + r] = col[i];
  }
}

// Instance j's ten colours from the staged chunk.
__device__ __forceinline__ void staged_colours(const float4* s_inst, int j,
                                               float (&col)[kNumChannels]) {
  const float4 q1 = s_inst[4 * j + 1], q2 = s_inst[4 * j + 2], q3 = s_inst[4 * j + 3];
  col[0] = q1.z; col[1] = q1.w;
  col[2] = q2.x; col[3] = q2.y; col[4] = q2.z; col[5] = q2.w;
  col[6] = q3.x; col[7] = q3.y; col[8] = q3.z; col[9] = q3.w;
}

}  // namespace ghraster
