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
// reduction of those 16 terms over the tile's pixels for every instance --
// warp shuffles and barriers, i.e. issue slots, not bytes.
//
// Design: one block per tile, one thread per pixel, tiles heaviest first
// (tile_order).  No float atomics: the result is bit-reproducible.  (A tile
// split over two or four blocks, each summing its warps' partials and the
// last to finish adding the blocks' sums, measured no faster: the walk is
// bound by issue slots, not by barrier waits.)
// - Cull: each chunk is staged instance-major with its warp masks
//   (raster_common.cuh), and a warp walks only the instances whose bit it
//   holds, in order (a ballot over 32 masks, then the set bits).  A warp whose pixels are all done
//   stops walking and records from which instance on it wrote nothing
//   (s_stop); it still takes part in the barriers.
// - Reduce-scatter: a warp sums an instance's 16 terms over its 32 pixels
//   with a butterfly that halves the rows at each step (8 + 4 + 2 + 1
//   shuffles, then 1 more across lane pairs): 16 shuffles, after which lanes
//   2r and 2r + 1 hold row r, and the 16 even lanes store the 16 rows at
//   once.  A warp in which no pixel contributed stores zeros without
//   shuffling.  One instance at a time rather than two (31 shuffles per
//   pair): the same count per instance, no shuffles of a zero instance when
//   only one of a pair's bits is set, and 16 fewer live registers.
// - Cross-warp sum: instances go in groups of 64 per pair of barriers
//   (group buffer [warps][16][65] floats = 130 KB, the 65 avoiding bank
//   conflicts); after the first barrier each of the 1024 threads owns one
//   (row, instance) of the group and adds the partials of the warps in that
//   instance's mask that walked it, in ascending warp order from +0.0f.  A
//   warp left out could only have added exact zeros, which do not change a
//   fixed-order sum, so the bits depend on nothing but the input.
// - Barriers: one after staging, two per group; the last group's second
//   barrier is the vote that ends the tile and the barrier before the next
//   chunk is staged.  Chunks after the tile's last live pixel are not
//   visited; the wrapper zero-fills dpay.

#include "raster_common.cuh"

using namespace ghraster;

namespace {
constexpr int kGroup = 64;             // instances per reduction group
constexpr int kRedStride = kGroup + 1;  // floats between two rows of s_red

// Sums v[0..15] over the warp's 32 lanes; returns row lane / 2.
__device__ __forceinline__ float reduce_scatter16(float (&v)[kGradRows], int lane) {
  float v8[8], v4[4], v2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = b4 ? v[8 + i] : v[i];
    const float send = b4 ? v[i] : v[8 + i];
    v8[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b3 ? v8[4 + i] : v8[i];
    const float send = b3 ? v8[i] : v8[4 + i];
    v4[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? v4[2 + i] : v4[i];
    const float send = b2 ? v4[i] : v4[2 + i];
    v2[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  const float keep = b1 ? v2[1] : v2[0];
  const float send = b1 ? v2[0] : v2[1];
  const float v1 = keep + __shfl_xor_sync(kFull, send, 2);
  return v1 + __shfl_xor_sync(kFull, v1, 1);
}
}  // namespace

extern "C" __global__ void __launch_bounds__(1024)
raster_bwd_kernel(const float* __restrict__ payload,
                  const int* __restrict__ chunk_start,
                  const int* __restrict__ nchunks,
                  const int* __restrict__ tile_order,
                  const float* __restrict__ tile_buf,
                  const float* __restrict__ gbuf,
                  float* __restrict__ dpay,
                  int grid_x, int grid_y, int tile_w, int ch, int row0) {
  extern __shared__ float4 smem4[];
  const int nwarps = blockDim.x / 32;
  float4* s_inst = smem4;                                         // [ch][4]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_inst + 4 * ch);  // [ch]
  int* s_stop = reinterpret_cast<int*>(s_mask + ch);          // [nwarps]
  float* s_red = reinterpret_cast<float*>(s_stop + nwarps);   // [nwarps][16][kRedStride]

  const int tile = tile_order[blockIdx.x];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile_h = blockDim.x / tile_w;
  const TileOrigin o = tile_origin(tile, grid_x, grid_y, tile_w, tile_h, row0);
  const Pixel p = footprint_pixel(warp, lane, tile_w);
  const float px = static_cast<float>(o.x0 + p.x);
  const float py = static_cast<float>(o.y0 + p.y);

  const size_t pbase = (static_cast<size_t>(tile) * blockDim.x + p.y * tile_w + p.x)
                       * kPadChannels;
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
    stage_chunk(payload + static_cast<size_t>(chunk) * kPayloadRows * ch,
                s_inst, s_mask, ch, o, tile_w, tile_h);
    if (threadIdx.x < nwarps) s_stop[threadIdx.x] = ch;
    __syncthreads();
    bool walking = true;   // warp-uniform: false once every pixel is done
    int live = 1;
    for (int j0 = 0; j0 < ch; j0 += kGroup) {
      const int gsize = min(kGroup, ch - j0);
      // (1) the warp's partials of the group's instances it walks
      for (int h = 0; walking && h < gsize; h += 32) {
        if (__all_sync(kFull, done)) {
          walking = false;
          if (lane == 0) s_stop[warp] = j0 + h;
          break;
        }
        unsigned word = __ballot_sync(kFull, (s_mask[j0 + h + lane] >> warp) & 1u);
        while (word) {
          const int jj = h + __ffs(word) - 1;
          word &= word - 1;
          const int j = j0 + jj;
          float v[kGradRows];
#pragma unroll
          for (int r = 0; r < kGradRows; ++r) v[r] = 0.0f;
          bool contrib = false;
          if (!done) {
            const float4 q0 = s_inst[4 * j], q1 = s_inst[4 * j + 1];  // gx gy a b | c op
            const float a = q0.z;
            const float b = q0.w;
            const float c = q1.x;
            const float dx = q0.x - px;
            const float dy = q0.y - py;
            const float power = gauss_power(a, b, c, dx, dy);
            if (power <= 0.0f) {
              const float expp = expf(power);
              const float raw = q1.y * expp;
              const float alpha = fminf(kAlphaClamp, raw);
              if (alpha >= kAlphaMin) {
                const float test = T * (1.0f - alpha);
                if (test < kTEps) {
                  done = true;
                } else {
                  contrib = true;
                  const float w = alpha * T;
                  float col[kNumChannels];
                  staged_colours(s_inst, j, col);
                  float u = 0.0f;
#pragma unroll
                  for (int cc = 0; cc < kNumChannels; ++cc) {
                    u += g[cc] * col[cc];
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
          const float row = __any_sync(kFull, contrib) ? reduce_scatter16(v, lane) : 0.0f;
          if (!(lane & 1))
            s_red[(warp * kGradRows + lane / 2) * kRedStride + jj] = row;
        }
      }
      __syncthreads();
      // (2) thread t owns (row t / kGroup, instance t % kGroup) of the group
      for (int t = threadIdx.x; t < kGradRows * kGroup; t += blockDim.x) {
        const int r = t / kGroup;
        const int jj = t % kGroup;
        if (jj >= gsize) continue;
        const int j = j0 + jj;
        unsigned m = s_mask[j];
        float s = 0.0f;
        while (m) {
          const int w = __ffs(m) - 1;
          m &= m - 1;
          if (j < s_stop[w]) s += s_red[(w * kGradRows + r) * kRedStride + jj];
        }
        dpay[(static_cast<size_t>(chunk) * kGradRows + r) * ch + j] = s;
      }
      if (j0 + kGroup < ch) {
        __syncthreads();
      } else {
        live = __syncthreads_count(!done);
      }
    }
    if (live == 0) break;
  }
}

// dpay must be zero-filled by the caller (chunks after a tile's early stop
// are not written).  The grid holds num_tiles / (grid_x * grid_y) images, or
// one image's rows from row0 on (tile_origin).  Launches on `stream`;
// returns cudaGetLastError().
static size_t smem_bytes(int threads, int ch) {
  const int nwarps = threads / 32;
  return static_cast<size_t>(kInstFloats) * ch * sizeof(float)
         + static_cast<size_t>(ch) * sizeof(unsigned)
         + static_cast<size_t>(nwarps) * sizeof(int)
         + static_cast<size_t>(nwarps) * kGradRows * kRedStride * sizeof(float);
}

extern "C" int raster_bwd(const float* payload, const int* chunk_start,
                          const int* nchunks, const int* tile_order,
                          const float* tile_buf, const float* gbuf, float* dpay,
                          int num_tiles, int grid_x, int grid_y, int tile_w, int tile_h,
                          int ch, int row0, void* stream) {
  const int threads = tile_w * tile_h;
  const size_t smem = smem_bytes(threads, ch);
  cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    raster_bwd_kernel<<<num_tiles, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        payload, chunk_start, nchunks, tile_order, tile_buf, gbuf, dpay, grid_x,
        grid_y, tile_w, ch, row0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of raster_bwd_kernel resident on one SM at the launch's shape.
extern "C" int raster_bwd_blocks_per_sm(int tile_w, int tile_h, int ch) {
  const int threads = tile_w * tile_h;
  const size_t smem = smem_bytes(threads, ch);
  int blocks = 0;
  cudaFuncSetAttribute(raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, raster_bwd_kernel, threads, smem);
  return blocks;
}
