// Stage 2's optimizer tail in one multi-tensor pass, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's stage-2 step leaves its optimizer
// tail to XLA, which fuses it inside the jitted step; the port ran it eagerly
// as a loop over the parameter leaves (train/stage2.py: train_step), some 26
// elementwise launches per leaf (the NaN guard, the global-norm clip, AdamW,
// the guard's where) and 4 per leaf of the EMA: ~5,760 launches per step over
// the 194 leaves of the full-width strand models, each a few microseconds on
// the card behind 10-20 of host dispatch.  Here it takes three launches.
//
// What it computes, over L leaves (g the gradient, p the parameter, m and v
// AdamW's moments, e the EMA of p where the leaf has one):
//   optim_tail_reduce:   per block, the sum of g * g (in double) and the
//                        count of non-finite g over the block's chunks;
//   optim_tail_finalize: one block sums those partials in a fixed order into
//                        grad_norm = sqrt(sum), ok = (no non-finite g),
//                        scale = min(1, (1 / max(grad_norm, 1e-12)) * clip)
//                        (1 without a clip), the bias corrections
//                        c1 = 1 - b1^(count + 1), c2 = 1 - b2^(count + 1)
//                        from the device count, and count += ok;
//   optim_tail_update:   per element, where ok: g' = g * scale,
//                        m = b1 m + (1 - b1) g', v = b2 v + (1 - b2) g' g',
//                        p += -lr ((m / c1) / (sqrt(v / c2) + eps) + wd p);
//                        then, where the leaf has an EMA, on a skipped step
//                        too, e = dk e + (1 - dk) p with the new p.
// The operations and their order are those of train/optim.py (adamw_update,
// clip_by_global_norm, the EMA loop), each rounded to float as PyTorch's
// elementwise kernels round it (the build's -fmad=false keeps a*b + c from
// fusing), so the result differs from the per-leaf composition only by the
// grouping of the norm's sum.  Everything is float32, the norm's sum float64.
//
// Layout: leaf l is cut into chunks of kTailChunk elements, the last one
// short; chunk_start[l] is the first chunk of leaf l (a prefix sum, so chunk
// c belongs to the last leaf l with chunk_start[l] <= c, and starts at
// element (c - chunk_start[l]) * kTailChunk of it).  train/optim_tail.py:
// chunk_ranges mirrors this.  kTailChunk is a multiple of 4, so every chunk
// of a leaf whose pointers are 16-byte aligned starts aligned, and float4
// loads cover it but for its last len % 4 elements.  A grid of SMs x
// kTailBlocksPerSm blocks strides over the chunks, so a small leaf costs one
// chunk of one block, not a launch.  The leaf table travels by value in the
// kernel's parameters (__grid_constant__, ~20.8 KB; CUDA >= 12.1 takes up to
// 32,764 bytes): the gradients' pointers change every step, and no copy to
// the card is needed.
//
// What bounds it on the H100: bytes.  reduce reads g; update reads g, p, m
// and v and writes p, m and v, and reads and writes e where there is one: at
// the strand stage's 60.94M parameters (52.30M with an EMA) 2.37 GB, 0.71 ms
// at 3.35 TB/s.  The design moves each of them once per step, where the
// per-leaf loop made ~26 passes.
//
// No float atomics, no allocation and no synchronisation: the partials are
// summed in a fixed order by the second launch, so two runs on one card agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace: the C entry points take a TailTable, and a type of an
// unnamed namespace would give them internal linkage
namespace ghoptim {

constexpr int kTailThreads = 256;
constexpr int kTailBlocksPerSm = 4;   // resident blocks per SM, by launch bounds
constexpr int kTailChunk = 4096;      // elements per chunk, a multiple of 4
constexpr int kTailMaxLeaves = 400;   // leaves per table (one launch of each)

struct TailTable {
  int num_leaves;
  int num_chunks;
  int chunk_start[kTailMaxLeaves + 1];
  long long numel[kTailMaxLeaves];
  const float* g[kTailMaxLeaves];
  float* p[kTailMaxLeaves];
  float* m[kTailMaxLeaves];
  float* v[kTailMaxLeaves];
  float* e[kTailMaxLeaves];            // nullptr: no EMA for this leaf
};

// the finalize's results, read by every block of the update
enum { kScale = 0, kOk, kC1, kC2, kGradNorm };

struct Chunk {
  int leaf;
  long long offset;
  int len;
};

__device__ __forceinline__ Chunk chunk_of(const TailTable& t, int c) {
  int lo = 0, hi = t.num_leaves;   // the last leaf with chunk_start <= c
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  Chunk ch;
  ch.leaf = lo;
  ch.offset = static_cast<long long>(c - t.chunk_start[lo]) * kTailChunk;
  const long long left = t.numel[lo] - ch.offset;
  ch.len = left < kTailChunk ? static_cast<int>(left) : kTailChunk;
  return ch;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ void accumulate(float x, double& sq, int& bad) {
  sq += static_cast<double>(x) * static_cast<double>(x);
  bad += isfinite(x) ? 0 : 1;
}

// the block's sums in a fixed order: shuffles within each warp, then warp 0
// over the warps' partials; the result is valid in thread 0
__device__ __forceinline__ void block_sum(double& sq, int& bad) {
  __shared__ double s_sq[kTailThreads / 32];
  __shared__ int s_bad[kTailThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_down_sync(0xffffffffu, sq, o);
    bad += __shfl_down_sync(0xffffffffu, bad, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_sq[warp] = sq;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < kTailThreads / 32 ? s_sq[lane] : 0.0;
    bad = lane < kTailThreads / 32 ? s_bad[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      sq += __shfl_down_sync(0xffffffffu, sq, o);
      bad += __shfl_down_sync(0xffffffffu, bad, o);
    }
  }
}

__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSm)
optim_tail_reduce_kernel(const __grid_constant__ TailTable t, double* __restrict__ part_sq,
                         int* __restrict__ part_bad) {
  double sq = 0.0;
  int bad = 0;
  for (int c = blockIdx.x; c < t.num_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(t, c);
    const float* g = t.g[ch.leaf] + ch.offset;
    int head = 0;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int n4 = ch.len >> 2;
      for (int i = threadIdx.x; i < n4; i += kTailThreads) {
        const float4 x = g4[i];
        accumulate(x.x, sq, bad);
        accumulate(x.y, sq, bad);
        accumulate(x.z, sq, bad);
        accumulate(x.w, sq, bad);
      }
      head = n4 << 2;
    }
    for (int i = head + threadIdx.x; i < ch.len; i += kTailThreads) accumulate(g[i], sq, bad);
  }
  block_sum(sq, bad);
  if (threadIdx.x == 0) {
    part_sq[blockIdx.x] = sq;
    part_bad[blockIdx.x] = bad;
  }
}

__global__ void __launch_bounds__(kTailThreads)
optim_tail_finalize_kernel(const double* __restrict__ part_sq, const int* __restrict__ part_bad,
                           int nparts, int* __restrict__ count, float* __restrict__ scalars,
                           float clip, float b1, float b2) {
  double sq = 0.0;
  int bad = 0;
  for (int i = threadIdx.x; i < nparts; i += kTailThreads) {
    sq += part_sq[i];
    bad += part_bad[i];
  }
  block_sum(sq, bad);
  if (threadIdx.x != 0) return;
  const float gn = static_cast<float>(sqrt(sq));
  // clip_by_global_norm: clamp(max_norm / clamp(gnorm, min=1e-12), max=1),
  // where a Python float over a tensor is reciprocal(tensor) * max_norm
  float scale = 1.0f;
  if (clip > 0.0f) {
    const float r = 1.0f / fmaxf(gn, 1e-12f);
    scale = fminf(r * clip, 1.0f);
  }
  const int next = *count + 1;
  const float cnt = static_cast<float>(next);
  scalars[kScale] = scale;
  scalars[kOk] = bad == 0 ? 1.0f : 0.0f;
  scalars[kC1] = 1.0f - powf(b1, cnt);
  scalars[kC2] = 1.0f - powf(b2, cnt);
  scalars[kGradNorm] = gn;
  if (bad == 0) *count = next;
}

struct AdamW {
  float scale, c1, c2, neg_lr, b1, omb1, b2, omb2, eps, wd;

  // optim.adamw_update for one element, in its order of operations
  __device__ __forceinline__ void operator()(float g, float& p, float& m, float& v) const {
    const float gs = g * scale;
    m = b1 * m + omb1 * gs;
    float g2 = omb2 * gs;
    g2 = g2 * gs;
    v = b2 * v + g2;
    const float u = (m / c1) / (sqrtf(v / c2) + eps) + wd * p;
    p = p + neg_lr * u;
  }
};

struct Ema {
  float dk, omdk;
  __device__ __forceinline__ void operator()(float p, float& e) const { e = dk * e + omdk * p; }
};

// one chunk of the update: kStep runs AdamW (the step is ok), kEma the EMA
template <bool kStep, bool kEma>
__device__ __forceinline__ void update_chunk(const TailTable& t, const Chunk& ch,
                                             const AdamW& adam, const Ema& ema) {
  const int l = ch.leaf;
  const float* g = t.g[l] + ch.offset;
  float* p = t.p[l] + ch.offset;
  float* m = t.m[l] + ch.offset;
  float* v = t.v[l] + ch.offset;
  float* e = kEma ? t.e[l] + ch.offset : nullptr;
  int head = 0;
  if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) && (!kEma || aligned16(e))) {
    const int n4 = ch.len >> 2;
    for (int i = threadIdx.x; i < n4; i += kTailThreads) {
      float4 p4 = reinterpret_cast<float4*>(p)[i];
      if (kStep) {
        const float4 g4 = reinterpret_cast<const float4*>(g)[i];
        float4 m4 = reinterpret_cast<float4*>(m)[i];
        float4 v4 = reinterpret_cast<float4*>(v)[i];
        adam(g4.x, p4.x, m4.x, v4.x);
        adam(g4.y, p4.y, m4.y, v4.y);
        adam(g4.z, p4.z, m4.z, v4.z);
        adam(g4.w, p4.w, m4.w, v4.w);
        reinterpret_cast<float4*>(p)[i] = p4;
        reinterpret_cast<float4*>(m)[i] = m4;
        reinterpret_cast<float4*>(v)[i] = v4;
      }
      if (kEma) {
        float4 e4 = reinterpret_cast<float4*>(e)[i];
        ema(p4.x, e4.x);
        ema(p4.y, e4.y);
        ema(p4.z, e4.z);
        ema(p4.w, e4.w);
        reinterpret_cast<float4*>(e)[i] = e4;
      }
    }
    head = n4 << 2;
  }
  for (int i = head + threadIdx.x; i < ch.len; i += kTailThreads) {
    float pi = p[i];
    if (kStep) {
      float mi = m[i], vi = v[i];
      adam(g[i], pi, mi, vi);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
    if (kEma) ema(pi, e[i]);
  }
}

__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSm)
optim_tail_update_kernel(const __grid_constant__ TailTable t, const float* __restrict__ scalars,
                         float neg_lr, float b1, float omb1, float b2, float omb2, float eps,
                         float wd, float dk, float omdk) {
  const bool ok = scalars[kOk] != 0.0f;
  const AdamW adam{scalars[kScale], scalars[kC1], scalars[kC2], neg_lr, b1, omb1, b2, omb2,
                   eps, wd};
  const Ema ema{dk, omdk};
  for (int c = blockIdx.x; c < t.num_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(t, c);
    const bool has_ema = t.e[ch.leaf] != nullptr;
    if (ok) {
      if (has_ema) update_chunk<true, true>(t, ch, adam, ema);
      else update_chunk<true, false>(t, ch, adam, ema);
    } else if (has_ema) {
      update_chunk<false, true>(t, ch, adam, ema);
    }
  }
}

}  // namespace ghoptim

using namespace ghoptim;

// The layout constants and sizeof(TailTable), so that the wrapper's mirror
// of the table can be checked: out[0..4] = chunk, threads, blocks per SM,
// leaves per table, table bytes.
extern "C" int optim_tail_layout(int* out) {
  out[0] = kTailChunk;
  out[1] = kTailThreads;
  out[2] = kTailBlocksPerSm;
  out[3] = kTailMaxLeaves;
  out[4] = static_cast<int>(sizeof(TailTable));
  return 0;
}

extern "C" int optim_tail_reduce(const TailTable* table, int grid, double* part_sq,
                                 int* part_bad, void* stream) {
  optim_tail_reduce_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, part_sq, part_bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int optim_tail_finalize(const double* part_sq, const int* part_bad, int nparts,
                                   int* count, float* scalars, float clip, float b1, float b2,
                                   void* stream) {
  optim_tail_finalize_kernel<<<1, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_sq, part_bad, nparts, count, scalars, clip, b1, b2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int optim_tail_update(const TailTable* table, int grid, const float* scalars,
                                 float neg_lr, float b1, float omb1, float b2, float omb2,
                                 float eps, float wd, float dk, float omdk, void* stream) {
  optim_tail_update_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, scalars, neg_lr, b1, omb1, b2, omb2, eps, wd, dk, omdk);
  return static_cast<int>(cudaGetLastError());
}
