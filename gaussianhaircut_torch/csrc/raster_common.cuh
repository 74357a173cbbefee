// Shared by raster_fwd.cu and raster_bwd.cu: the payload layout and the
// per-(pixel, instance) blend arithmetic.  Both kernels must take the same
// early-stop decisions, so the arithmetic lives here once and both files are
// compiled with -fmad=false (no contraction that could differ between them).
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

// Gaussian exponent, as the plain version writes it:
// power = -0.5 (a dx^2 + c dy^2) - b dx dy with dx = gx - px.
__device__ __forceinline__ float gauss_power(float a, float b, float c,
                                             float dx, float dy) {
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// Stage one chunk's geometry rows 0..5 and colour rows 8..17 into shared
// memory: s_geo [6][ch], s_col [10][ch].
__device__ __forceinline__ void stage_chunk(const float* __restrict__ pay,
                                            float* s_geo, float* s_col,
                                            int ch) {
  const int n = (kGeoRows + kNumChannels) * ch;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ch;
    const int lane = i - r * ch;
    if (r < kGeoRows) {
      s_geo[i] = pay[r * ch + lane];
    } else {
      s_col[(r - kGeoRows) * ch + lane] = pay[(kColorRow + r - kGeoRows) * ch + lane];
    }
  }
}

}  // namespace ghraster
