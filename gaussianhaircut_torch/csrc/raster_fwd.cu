// Compositing forward for NVIDIA Hopper (sm_90a).
//
// Replaces: gaussianhaircut_tpu/ops/rasterize/pallas_core.py
//   raster_core_pallas_fwd -> _fwd_kernel (per-chunk maths
//   _chunk_blend_quantities).
//
// What it computes: for each tile, front-to-back alpha compositing of the
// tile's depth-sorted instances (forward.cu:351-388 of the CUDA reference):
// alpha = min(0.99, op * exp(power)); an instance is skipped when power > 0
// or alpha < 1/255; a pixel stops when T would drop below 1e-4.
// Output: tile_buf [T, PIX, 16] = colour channels 0..9, zeros 10..13, the
// done latch in 14 and the final transmittance in 15 -- the JAX kernel's
// contract, so assemble_image is unchanged.
//
// What bounds it on the H100: the exp and ~15 FP32 operations of every
// (pixel, instance) pair a pixel visits before it stops, i.e. the FP32
// pipes; bytes are small (each chunk's 16 KB of payload is read once per
// tile, each output pixel written once).
//
// Design: one thread per pixel, so every pixel stops on its own (the TPU
// design could only stop a whole tile).  Each tile is split over
// tile_split blocks (2 at 32x32: 512 threads each, two resident per SM, so
// one block's barrier does not idle the SM), and blocks take tiles heaviest
// first (tile_order: descending chunk counts), so a long tile does not
// start in the last wave.  Each chunk's instances are staged in shared
// memory once per block, instance-major (four broadcast 16-byte loads per
// instance), together with each instance's warp mask (raster_common.cuh:
// the warps whose 8x4 pixel block can hold a candidate pair).  A warp walks
// only the instances whose bit it holds -- a ballot over 32 masks at a
// time, then the set bits in order -- and stops walking once all its pixels
// are done; the skipped pairs could neither blend nor stop a pixel, so the
// output is bit for bit the plain version's.  __syncthreads_count of live
// pixels after each chunk ends the block's walk when none is left, and is
// also the barrier before the next chunk is staged.  Plain FP32 arithmetic
// in the linear domain.

#include "raster_common.cuh"

using namespace ghraster;

extern "C" __global__ void __launch_bounds__(1024)
raster_fwd_kernel(const float* __restrict__ payload,
                  const int* __restrict__ chunk_start,
                  const int* __restrict__ nchunks,
                  const int* __restrict__ tile_order,
                  float* __restrict__ tile_buf,
                  int grid_x, int grid_y, int tile_w, int tile_h, int ch, int split,
                  int row0) {
  extern __shared__ float4 smem4[];
  float4* s_inst = smem4;                                         // [ch][4]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_inst + 4 * ch);  // [ch]

  const int tile = tile_order[blockIdx.x / split];
  const int warp = (blockIdx.x % split) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TileOrigin o = tile_origin(tile, grid_x, grid_y, tile_w, tile_h, row0);
  const Pixel p = footprint_pixel(warp, lane, tile_w);
  const float px = static_cast<float>(o.x0 + p.x);
  const float py = static_cast<float>(o.y0 + p.y);

  float T = 1.0f;
  bool done = false;
  float acc[kNumChannels];
#pragma unroll
  for (int c = 0; c < kNumChannels; ++c) acc[c] = 0.0f;

  const int c0 = chunk_start[tile];
  const int nc = nchunks[tile];
  for (int k = 0; k < nc; ++k) {
    // the vote that ended the previous chunk is the barrier before staging
    stage_chunk(payload + static_cast<size_t>(c0 + k) * kPayloadRows * ch,
                s_inst, s_mask, ch, o, tile_w, tile_h);
    __syncthreads();
    for (int h = 0; h < ch; h += 32) {
      if (__all_sync(kFull, done)) break;
      unsigned word = __ballot_sync(kFull, (s_mask[h + lane] >> warp) & 1u);
      while (word) {
        const int j = h + __ffs(word) - 1;
        word &= word - 1;
        if (done) continue;
        const float4 q0 = s_inst[4 * j], q1 = s_inst[4 * j + 1];  // gx gy a b | c op
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = gauss_power(q0.z, q0.w, q1.x, dx, dy);
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaClamp, q1.y * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test = T * (1.0f - alpha);
        if (test < kTEps) {
          done = true;
          continue;
        }
        const float w = alpha * T;
        float col[kNumChannels];
        staged_colours(s_inst, j, col);
#pragma unroll
        for (int c = 0; c < kNumChannels; ++c) acc[c] += col[c] * w;
        T = test;
      }
    }
    if (__syncthreads_count(!done) == 0) break;
  }

  float4* out = reinterpret_cast<float4*>(
      tile_buf + (static_cast<size_t>(tile) * tile_w * tile_h + p.y * tile_w + p.x)
                 * kPadChannels);
  out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  out[2] = make_float4(acc[8], acc[9], 0.0f, 0.0f);
  out[3] = make_float4(0.0f, 0.0f, done ? 1.0f : 0.0f, T);
}

// Writes every used chunk's warp masks, masks [TC, ch] (the bits as int32),
// with the forward's staging: what the card's cull decides, to be held
// against plain_core.warp_masks_plain.  Chunks in no tile's range stay as
// the caller filled them.
extern "C" __global__ void __launch_bounds__(1024)
raster_warp_masks_kernel(const float* __restrict__ payload,
                         const int* __restrict__ chunk_start,
                         const int* __restrict__ nchunks,
                         unsigned* __restrict__ masks,
                         int grid_x, int grid_y, int tile_w, int ch, int row0) {
  extern __shared__ float4 smem4[];
  float4* s_inst = smem4;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_inst + 4 * ch);
  const int tile = blockIdx.x;
  const TileOrigin o = tile_origin(tile, grid_x, grid_y, tile_w, blockDim.x / tile_w, row0);
  const int c0 = chunk_start[tile];
  for (int k = 0; k < nchunks[tile]; ++k) {
    __syncthreads();
    stage_chunk(payload + static_cast<size_t>(c0 + k) * kPayloadRows * ch,
                s_inst, s_mask, ch, o, tile_w, blockDim.x / tile_w);
    __syncthreads();
    for (int j = threadIdx.x; j < ch; j += blockDim.x)
      masks[static_cast<size_t>(c0 + k) * ch + j] = s_mask[j];
  }
}

static size_t staging_bytes(int ch) {
  return static_cast<size_t>(kInstFloats) * ch * sizeof(float)
         + static_cast<size_t>(ch) * sizeof(unsigned);
}

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// The grid holds num_tiles / (grid_x * grid_y) images of grid_y tile rows
// each, or one image's rows from row0 on (tile_origin).
extern "C" int raster_fwd(const float* payload, const int* chunk_start,
                          const int* nchunks, const int* tile_order,
                          float* tile_buf, int num_tiles, int grid_x, int grid_y,
                          int tile_w, int tile_h, int ch, int row0, void* stream) {
  const int split = tile_split(tile_w * tile_h);
  if (num_tiles > 0) {
    raster_fwd_kernel<<<num_tiles * split, tile_w * tile_h / split, staging_bytes(ch),
                        static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, tile_order, tile_buf, grid_x, grid_y, tile_w,
        tile_h, ch, split, row0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int raster_warp_masks(const float* payload, const int* chunk_start,
                                 const int* nchunks, unsigned* masks, int num_tiles,
                                 int grid_x, int grid_y, int tile_w, int tile_h, int ch,
                                 int row0, void* stream) {
  if (num_tiles > 0) {
    raster_warp_masks_kernel<<<num_tiles, tile_w * tile_h, staging_bytes(ch),
                               static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, masks, grid_x, grid_y, tile_w, ch, row0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of raster_fwd_kernel resident on one SM at the launch's shape.
extern "C" int raster_fwd_blocks_per_sm(int tile_w, int tile_h, int ch) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, raster_fwd_kernel, tile_w * tile_h / tile_split(tile_w * tile_h),
      staging_bytes(ch));
  return blocks;
}
