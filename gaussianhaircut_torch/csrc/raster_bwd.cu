// Compositing backward for NVIDIA Hopper (sm_90a).
//
// Replaces: gaussianhaircut_tpu/ops/rasterize/pallas_core.py
//   raster_core_pallas_bwd -> _bwd_kernel / _bwd_chunk.
//
// What it computes: per-instance gradients summed over the tile's pixels,
// dpay [TC, 16, CH] = (d mean2D x, y in pixels, d conic a, b, c, d opacity,
// d colour 0..9).  Each pixel re-walks its instances front to back,
// recomputing alpha, T before the instance and the contribute mask exactly
// as raster_fwd.cu does.  The back-to-front suffix of backward.cu is
// total - prefix, with total = sum over the 16 channels of g * out (so the
// final-T channel 15, which carries the background's cotangent, reaches
// d alpha).  d alpha = u T_before - suffix / (1 - alpha), u = g . colour;
// the gradient ignores the 0.99 clamp (backward.cu:502-558).
//
// What bounds it on the H100: the per-pair arithmetic (the forward's
// ~20 FP32 operations plus ~30 for the 16 gradient terms) and the
// reduction of those 16 terms over 1024 pixels for every instance -- warp
// shuffles, i.e. issue slots, not bytes.
//
// Design: one block per tile, one thread per pixel.  No float atomics: the
// result is bit-reproducible.  Every instance's 16 terms are reduced in a
// fixed order -- a warp-shuffle tree to one partial per warp, then a
// fixed-order sum of the 32 warp partials through shared memory.  Instances
// are processed in groups of 32, so one __syncthreads pair serves 32
// instances (group buffer: 32 warps x 16 terms x 32 instances = 64 KB of
// dynamic shared memory).  A warp in which no pixel touches an instance
// skips its shuffles (__any_sync).  Chunks after the tile's last live pixel
// are not visited; the wrapper zero-fills dpay.

#include "raster_common.cuh"

using namespace ghraster;

namespace {
constexpr int kGroup = 32;   // instances per reduction group
constexpr unsigned kFull = 0xffffffffu;
}  // namespace

extern "C" __global__ void __launch_bounds__(1024)
raster_bwd_kernel(const float* __restrict__ payload,
                  const int* __restrict__ chunk_start,
                  const int* __restrict__ nchunks,
                  const float* __restrict__ tile_buf,
                  const float* __restrict__ gbuf,
                  float* __restrict__ dpay,
                  int grid_x, int tile_w, int ch) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  float* s_geo = smem;                               // [6][ch]
  float* s_col = s_geo + kGeoRows * ch;              // [10][ch]
  float* s_red = s_col + kNumChannels * ch;          // [nwarps][16][kGroup]

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int warp = pix / 32;
  const int lane = pix % 32;
  const int tile_h = blockDim.x / tile_w;
  const float px = static_cast<float>((tile % grid_x) * tile_w + pix % tile_w);
  const float py = static_cast<float>((tile / grid_x) * tile_h + pix / tile_w);

  const size_t pbase = (static_cast<size_t>(tile) * blockDim.x + pix) * kPadChannels;
  float g[kNumChannels];
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < kPadChannels; ++c) {
    const float gc = gbuf[pbase + c];
    total += gc * tile_buf[pbase + c];
    if (c < kNumChannels) g[c] = gc;
  }

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  const int c0 = chunk_start[tile];
  const int nc = nchunks[tile];
  for (int k = 0; k < nc; ++k) {
    const int chunk = c0 + k;
    __syncthreads();
    stage_chunk(payload + static_cast<size_t>(chunk) * kPayloadRows * ch,
                s_geo, s_col, ch);
    __syncthreads();
    for (int j0 = 0; j0 < ch; j0 += kGroup) {
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = j0 + jj;
        float v[kGradRows];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) v[r] = 0.0f;
        bool contrib = false;
        if (!done) {
          const float a = s_geo[kCA * ch + j];
          const float b = s_geo[kCB * ch + j];
          const float c = s_geo[kCC * ch + j];
          const float dx = s_geo[kGX * ch + j] - px;
          const float dy = s_geo[kGY * ch + j] - py;
          const float power = gauss_power(a, b, c, dx, dy);
          if (power <= 0.0f) {
            const float expp = expf(power);
            const float raw = s_geo[kOP * ch + j] * expp;
            const float alpha = fminf(kAlphaClamp, raw);
            if (alpha >= kAlphaMin) {
              const float test = T * (1.0f - alpha);
              if (test < kTEps) {
                done = true;
              } else {
                contrib = true;
                const float w = alpha * T;
                float u = 0.0f;
#pragma unroll
                for (int cc = 0; cc < kNumChannels; ++cc) {
                  u += g[cc] * s_col[cc * ch + j];
                  v[6 + cc] = g[cc] * w;
                }
                prefix += u * w;
                const float suffix = total - prefix;
                const float dalpha = u * T - suffix / (1.0f - alpha);
                const float m = dalpha * raw;
                v[0] = -(a * dx + b * dy) * m;
                v[1] = -(c * dy + b * dx) * m;
                v[2] = -0.5f * m * dx * dx;
                v[3] = -m * dx * dy;
                v[4] = -0.5f * m * dy * dy;
                v[5] = dalpha * expp;
                T = test;
              }
            }
          }
        }
        if (__any_sync(kFull, contrib)) {
#pragma unroll
          for (int r = 0; r < kGradRows; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[r] += __shfl_down_sync(kFull, v[r], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kGradRows; ++r)
            s_red[(warp * kGradRows + r) * kGroup + jj] = v[r];
        }
      }
      __syncthreads();
      // fixed-order sum of the warp partials: thread t owns (row t / 32,
      // instance t % 32) of the group
      for (int t = pix; t < kGradRows * kGroup; t += blockDim.x) {
        const int r = t / kGroup;
        const int jj = t % kGroup;
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += s_red[(w * kGradRows + r) * kGroup + jj];
        dpay[(static_cast<size_t>(chunk) * kGradRows + r) * ch + j0 + jj] = s;
      }
      __syncthreads();
    }
    if (__syncthreads_count(!done) == 0) break;
  }
}

// dpay must be zero-filled by the caller (chunks after a tile's early stop
// are not written).  Launches on `stream`; returns cudaGetLastError().
extern "C" int raster_bwd(const float* payload, const int* chunk_start,
                          const int* nchunks, const float* tile_buf,
                          const float* gbuf, float* dpay, int num_tiles,
                          int grid_x, int tile_w, int tile_h, int ch,
                          void* stream) {
  const int threads = tile_w * tile_h;
  const size_t smem = (static_cast<size_t>(kGeoRows + kNumChannels) * ch
                       + static_cast<size_t>(threads / 32) * kGradRows * kGroup)
                      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    raster_bwd_kernel<<<num_tiles, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, tile_buf, gbuf, dpay, grid_x, tile_w, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
