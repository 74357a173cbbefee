// Compositing forward for NVIDIA Hopper (sm_90a).
//
// Replaces: gaussianhaircut_tpu/ops/rasterize/pallas_core.py
//   raster_core_pallas_fwd -> _fwd_kernel (per-chunk maths
//   _chunk_blend_quantities).
//
// What it computes: for each 32x32 tile, front-to-back alpha compositing of
// the tile's depth-sorted instances (forward.cu:351-388 of the CUDA
// reference): alpha = min(0.99, op * exp(power)); an instance is skipped when
// power > 0 or alpha < 1/255; a pixel stops when T would drop below 1e-4.
// Output: tile_buf [T, PIX, 16] = colour channels 0..9, zeros 10..13, the
// done latch in 14 and the final transmittance in 15 -- the JAX kernel's
// contract, so assemble_image is unchanged.
//
// What bounds it on the H100: the exp and ~15 FP32 operations of every
// (pixel, instance) pair a pixel visits before it stops, i.e. the FP32
// pipes; bytes are small (each chunk's 16 KB of payload is read once per
// tile, each output pixel written once).
//
// Design: one block per tile and one thread per pixel, so every pixel
// stops on its own (the TPU design could only stop a whole tile).  The
// block walks its tile's chunks; each chunk's 256 instances (6 geometry +
// 10 colour floats) are staged in shared memory once and read by all 1024
// pixels.  After each chunk, __syncthreads_count of live pixels ends the
// tile when none is left.  No quadratic-form matmul, no log-space
// transmittance, no bf16 splits: plain FP32 arithmetic in the linear domain.

#include "raster_common.cuh"

using namespace ghraster;

extern "C" __global__ void __launch_bounds__(1024)
raster_fwd_kernel(const float* __restrict__ payload,
                  const int* __restrict__ chunk_start,
                  const int* __restrict__ nchunks,
                  float* __restrict__ tile_buf,
                  int grid_x, int tile_w, int ch) {
  extern __shared__ float smem[];
  float* s_geo = smem;                    // [6][ch]
  float* s_col = smem + kGeoRows * ch;    // [10][ch]

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int tile_h = blockDim.x / tile_w;
  const float px = static_cast<float>((tile % grid_x) * tile_w + pix % tile_w);
  const float py = static_cast<float>((tile / grid_x) * tile_h + pix / tile_w);

  float T = 1.0f;
  bool done = false;
  float acc[kNumChannels];
#pragma unroll
  for (int c = 0; c < kNumChannels; ++c) acc[c] = 0.0f;

  const int c0 = chunk_start[tile];
  const int nc = nchunks[tile];
  for (int k = 0; k < nc; ++k) {
    __syncthreads();  // previous chunk fully consumed
    stage_chunk(payload + static_cast<size_t>(c0 + k) * kPayloadRows * ch,
                s_geo, s_col, ch);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < ch; ++j) {
        const float dx = s_geo[kGX * ch + j] - px;
        const float dy = s_geo[kGY * ch + j] - py;
        const float power = gauss_power(s_geo[kCA * ch + j], s_geo[kCB * ch + j],
                                        s_geo[kCC * ch + j], dx, dy);
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaClamp, s_geo[kOP * ch + j] * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test = T * (1.0f - alpha);
        if (test < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < kNumChannels; ++c) acc[c] += s_col[c * ch + j] * w;
        T = test;
      }
    }
    if (__syncthreads_count(!done) == 0) break;
  }

  float4* out = reinterpret_cast<float4*>(
      tile_buf + (static_cast<size_t>(tile) * blockDim.x + pix) * kPadChannels);
  out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  out[2] = make_float4(acc[8], acc[9], 0.0f, 0.0f);
  out[3] = make_float4(0.0f, 0.0f, done ? 1.0f : 0.0f, T);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int raster_fwd(const float* payload, const int* chunk_start,
                          const int* nchunks, float* tile_buf, int num_tiles,
                          int grid_x, int tile_w, int tile_h, int ch,
                          void* stream) {
  const int threads = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(kGeoRows + kNumChannels) * ch * sizeof(float);
  if (num_tiles > 0) {
    raster_fwd_kernel<<<num_tiles, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, tile_buf, grid_x, tile_w, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
