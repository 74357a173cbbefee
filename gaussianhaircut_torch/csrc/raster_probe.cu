// Fixed-cost probe of the compositing forward, for NVIDIA Hopper (sm_90a).
//
// Replaces: tools/tpu_profile_r4.py _h_fixed_probe (section H of the TPU
//   profile): the forward kernel's skeleton with trivial maths, so that the
//   forward's time minus the probe's time is the cost of the pair maths.
//
// What it computes: for each tile, the sum over the tile's chunks of the sum
// of payload row 0 over the chunk's lanes, broadcast into every entry of the
// tile's [PIX, 16] block of tile_buf.  A tile with no chunk stays 0.
//
// The skeleton is raster_fwd.cu's, not the TPU's: each tile split over
// tile_split blocks, tiles heaviest first (tile_order), one thread per
// pixel of the warps' 8x4 footprints, the same stage_chunk from raster_common.cuh (geometry,
// colours and the warp masks) before the same __syncthreads, the same
// __syncthreads_count vote after each chunk (which is also the barrier
// before the next chunk is staged), and the same float4 flush of 16
// channels per pixel.  Its only maths: each chunk, the block's warps reduce
// the staged row 0 (gx), 32 instances each, by shuffles, and every pixel adds the fixed-order sum of
// those warp partials to its 16 accumulators.  The vote doubles as the
// barrier that publishes the partials, so the probe keeps the forward's
// barrier count.
//
// Variants, by the template switch kStage:
//   kStage = true   the probe above (raster_probe);
//   kStage = false  stages nothing and reads no payload: the loop over the
//                   chunks, its barriers and vote, and the flush; each chunk
//                   adds 1 (raster_probe_grid_only, the TPU's H_grid_only).
// The TPU's H_noout variant (a constant output block index) has no
// counterpart: this kernel writes each tile's block once, from registers,
// so there is no per-step output block to track.
//
// What bounds it on the H100: bytes, and few of them (each used chunk's 16
// staged rows read once, the tile buffer written once); what it measures is
// the per-chunk latency of staging and barriers, which no bound captures.

#include "raster_common.cuh"

using namespace ghraster;

template <bool kStage>
__global__ void __launch_bounds__(1024)
raster_probe_kernel(const float* __restrict__ payload,
                    const int* __restrict__ chunk_start,
                    const int* __restrict__ nchunks,
                    const int* __restrict__ tile_order,
                    float* __restrict__ tile_buf, int grid_x, int tile_w, int tile_h,
                    int ch, int split) {
  extern __shared__ float4 smem4[];
  float4* s_inst = smem4;                                         // [ch][4]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_inst + 4 * ch);  // [ch]
  float* s_part = reinterpret_cast<float*>(s_mask + ch);          // [ch / 32]

  const int tile = tile_order[blockIdx.x / split];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps_row = ch >> 5;
  // one image: its tile rows are all the grid's
  const TileOrigin o = tile_origin(tile, grid_x, gridDim.x / split / grid_x, tile_w, tile_h);
  const Pixel p = footprint_pixel((blockIdx.x % split) * nwarps + warp, lane, tile_w);

  bool done = false;
  float acc[kPadChannels];
#pragma unroll
  for (int c = 0; c < kPadChannels; ++c) acc[c] = 0.0f;

  const int c0 = chunk_start[tile];
  const int nc = nchunks[tile];
  for (int k = 0; k < nc; ++k) {
    if (kStage) {
      stage_chunk(payload + static_cast<size_t>(c0 + k) * kPayloadRows * ch,
                  s_inst, s_mask, ch, o, tile_w, tile_h);
    }
    __syncthreads();
    for (int w = warp; kStage && w < nwarps_row; w += nwarps) {
      float v = s_inst[4 * ((w << 5) + lane)].x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) s_part[w] = v;
    }
    // the forward's vote; it is also the barrier after which the partials
    // are visible to every thread
    const int live = __syncthreads_count(!done);
    float sum = 1.0f;
    if (kStage) {
      sum = 0.0f;
      for (int w = 0; w < nwarps_row; ++w) sum += s_part[w];
    }
#pragma unroll
    for (int c = 0; c < kPadChannels; ++c) acc[c] += sum;
    done = !(acc[0] == acc[0]);  // never set by finite input: no pixel stops
    if (live == 0) break;
  }

  float4* out = reinterpret_cast<float4*>(
      tile_buf + (static_cast<size_t>(tile) * tile_w * tile_h + p.y * tile_w + p.x)
                 * kPadChannels);
  out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  out[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
  out[3] = make_float4(acc[12], acc[13], acc[14], acc[15]);
}

static size_t smem_bytes(int ch) {
  return static_cast<size_t>(kInstFloats) * ch * sizeof(float)
         + static_cast<size_t>(ch) * sizeof(unsigned)
         + static_cast<size_t>(ch / 32) * sizeof(float);
}

template <bool kStage>
static int launch_probe(const float* payload, const int* chunk_start,
                        const int* nchunks, const int* tile_order, float* tile_buf,
                        int num_tiles, int grid_x, int tile_w, int tile_h, int ch,
                        void* stream) {
  const size_t smem = smem_bytes(ch);
  const int split = tile_split(tile_w * tile_h);
  if (num_tiles > 0) {
    raster_probe_kernel<kStage><<<num_tiles * split, tile_w * tile_h / split, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, tile_order, tile_buf, grid_x, tile_w, tile_h, ch,
        split);
  }
  return static_cast<int>(cudaGetLastError());
}

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int raster_probe(const float* payload, const int* chunk_start,
                            const int* nchunks, const int* tile_order,
                            float* tile_buf, int num_tiles, int grid_x, int tile_w,
                            int tile_h, int ch, void* stream) {
  return launch_probe<true>(payload, chunk_start, nchunks, tile_order, tile_buf,
                            num_tiles, grid_x, tile_w, tile_h, ch, stream);
}

extern "C" int raster_probe_grid_only(const float* payload, const int* chunk_start,
                                      const int* nchunks, const int* tile_order,
                                      float* tile_buf, int num_tiles, int grid_x,
                                      int tile_w, int tile_h, int ch, void* stream) {
  return launch_probe<false>(payload, chunk_start, nchunks, tile_order, tile_buf,
                             num_tiles, grid_x, tile_w, tile_h, ch, stream);
}

// Blocks of the probe kernel resident on one SM at the launch's shape.
extern "C" int raster_probe_blocks_per_sm(int tile_w, int tile_h, int ch) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, raster_probe_kernel<true>, tile_w * tile_h / tile_split(tile_w * tile_h),
      smem_bytes(ch));
  return blocks;
}
