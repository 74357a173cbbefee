// The port's optimizer passes, for NVIDIA Hopper (sm_90a): stage 2's tail
// (reduce, finalize, update) and stage 1's Adam (adam_guard, adam_update),
// each over one table of leaves in a fixed number of launches.
//
// Stage 2's optimizer tail.
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
//
// Stage 1's Adam.
//
// Replaces no TPU kernel either: XLA fuses stage 1's update inside the jitted
// step, and the port ran train/stage1.py: apply_grads as ~300 elementwise
// launches per step (optim.grads_are_finite, optim.adam_update, the guard's
// where, optim.where_ok and the camera rows' optim.adam_rows_update).  Here
// it takes two, over an AdamTable of up to kAdamMaxLeaves leaves: the
// Gaussian leaves, which share one step count, and the camera residuals' row
// leaves, each row of which has a count of its own.  Each leaf has its own
// learning rate and says whether its gradient feeds the guard (stage 1 leaves
// viewspace out).  g, p, m and v are read; p', m' and v' are fresh tensors,
// so the caller's state is not touched.  g is read where autograd left it:
// contiguous, or rows of a stride (the features' gradients, slices of one
// [N, 16, 3] tensor), so nothing is copied first.
//   optim_tail_adam_guard:  per block, the count of non-finite g in guarded
//                           leaves over the block's chunks, one count for the
//                           leaves of the shared count and one for the rows;
//   optim_tail_adam_update: every block sums those counts (integers, so any
//                           order gives the same sums) into ok (no non-finite
//                           guarded g) and rows_ok (rows_on, and no non-finite
//                           g in a row leaf).  Per element of a leaf of the
//                           shared count, with c1 = 1 - b1^(count + 1) and
//                           c2 = 1 - b2^(count + 1):
//                             m1 = b1 m + (1 - b1) g, v1 = b2 v + ((1 - b2) g) g,
//                             u = (-lr (m1 / c1)) / (sqrt(v1 / c2) + eps),
//                             p' = p + (ok ? u : 0), m' = ok ? m1 : m,
//                             v' = ok ? v1 : v;
//                           per element of row r of a row leaf the same, with
//                           sel = rows_ok and drawn[r] > 0 in place of ok, the
//                           row's count n = count_r + sel, c1 and c2 at
//                           max(n, 1), and v1 = b2 v + (1 - b2) (g g).  Block
//                           0 writes count' = count + ok, ok itself and each
//                           row's n.
// The operations and their order are those of train/optim.py (adam_update,
// adam_rows_update) and of the guard's torch.where, each rounded to float as
// PyTorch's kernels round it, so the results are the composition's bit for
// bit: a skipped step keeps the moments and the counts and gives p + 0.  Both
// forms take c1 and c2 from one powf (Adam::at_count) under the build's
// -fmad=false; that it gives torch.pow's floats on the card is a measured
// fact, not a derived one: chip_smoke.py's optim_tail phase checks the row
// form at every count from 1 to stage 1's 30,000 iterations.  What
// bounds it: bytes.  adam_guard reads the guarded g; adam_update reads g, p,
// m and v and writes p', m' and v': at stage 1's 1M Gaussians with SH 3 (64M
// floats, 61M guarded) 2.04 GB, 0.61 ms at 3.35 TB/s, where the composition
// made ~20 passes.  No atomics: two runs agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace: the C entry points take a TailTable, and a type of an
// unnamed namespace would give them internal linkage
namespace ghoptim {

constexpr int kTailThreads = 256;
constexpr int kTailBlocksPerSm = 4;   // resident blocks per SM, by launch bounds
constexpr int kTailChunk = 4096;      // elements per chunk, a multiple of 4
constexpr int kTailMaxLeaves = 400;   // leaves per table (one launch of each)
constexpr int kAdamMaxLeaves = 16;    // leaves per AdamTable

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

struct AdamTable {
  int num_leaves;
  int num_chunks;
  int chunk_start[kAdamMaxLeaves + 1];
  long long numel[kAdamMaxLeaves];
  long long g_stride[kAdamMaxLeaves];  // elements from one row of g to the next, where g_width
  int g_width[kAdamMaxLeaves];         // 0: g is contiguous; else g is rows of g_width
                                       // elements g_stride apart (autograd's slices of a
                                       // concatenation: the features' [N, 1, 3], [N, 15, 3])
  int row_width[kAdamMaxLeaves];       // 0: a leaf of the shared count; else a row leaf's
                                       // elements per row
  int guarded[kAdamMaxLeaves];         // 1: the leaf's g feeds its guard
  float neg_lr[kAdamMaxLeaves];        // -lr
  const float* g[kAdamMaxLeaves];
  const float* p[kAdamMaxLeaves];
  const float* m[kAdamMaxLeaves];
  const float* v[kAdamMaxLeaves];
  float* p_out[kAdamMaxLeaves];
  float* m_out[kAdamMaxLeaves];
  float* v_out[kAdamMaxLeaves];
};

// the finalize's results, read by every block of the update
enum { kScale = 0, kOk, kC1, kC2, kGradNorm };

struct Chunk {
  int leaf;
  long long offset;
  int len;
};

// chunk c of a TailTable or an AdamTable (both start with the same fields)
template <class Table>
__device__ __forceinline__ Chunk chunk_of(const Table& t, int c) {
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
// over the warps' partials; the result is valid in thread 0.  A is double
// for stage 2's squares, int for stage 1's second count
template <class A>
__device__ __forceinline__ void block_sum(A& sq, int& bad) {
  __shared__ A s_sq[kTailThreads / 32];
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
    sq = lane < kTailThreads / 32 ? s_sq[lane] : A(0);
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

// a chunk's gradient, element i of the chunk at [i]: g contiguous, or rows
// of width elements stride apart
struct Grad {
  const float* g;       // contiguous: the chunk's first element; rows: its first row
  long long stride;
  int width;            // 0: contiguous
  int col;              // the chunk's first element's column in its row
  __device__ __forceinline__ float operator[](int i) const {
    if (width == 0) return g[i];
    const int k = col + i, r = k / width;
    return g[r * stride + (k - r * width)];
  }
};

__device__ __forceinline__ Grad grad_of(const AdamTable& t, const Chunk& ch) {
  const int w = t.g_width[ch.leaf];
  if (w == 0) return Grad{t.g[ch.leaf] + ch.offset, 0, 0, 0};
  const long long r0 = ch.offset / w;
  return Grad{t.g[ch.leaf] + r0 * t.g_stride[ch.leaf], t.g_stride[ch.leaf], w,
              static_cast<int>(ch.offset - r0 * w)};
}

__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSm)
optim_tail_adam_guard_kernel(const __grid_constant__ AdamTable t, int* __restrict__ part_bad) {
  int bad = 0, bad_rows = 0;
  for (int c = blockIdx.x; c < t.num_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(t, c);
    if (!t.guarded[ch.leaf]) continue;
    const Grad g = grad_of(t, ch);
    int n = 0;
    int head = 0;
    if (g.width == 0 && aligned16(g.g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g.g);
      const int n4 = ch.len >> 2;
      for (int i = threadIdx.x; i < n4; i += kTailThreads) {
        const float4 x = g4[i];
        n += (isfinite(x.x) ? 0 : 1) + (isfinite(x.y) ? 0 : 1) + (isfinite(x.z) ? 0 : 1)
             + (isfinite(x.w) ? 0 : 1);
      }
      head = n4 << 2;
    }
    for (int i = head + threadIdx.x; i < ch.len; i += kTailThreads) n += isfinite(g[i]) ? 0 : 1;
    if (t.row_width[ch.leaf] > 0) bad_rows += n; else bad += n;
  }
  block_sum(bad_rows, bad);
  if (threadIdx.x == 0) {
    part_bad[2 * blockIdx.x] = bad;
    part_bad[2 * blockIdx.x + 1] = bad_rows;
  }
}

struct Adam {
  float neg_lr, c1, c2, b1, omb1, b2, omb2, eps;

  // the bias corrections at step count n, as 1 - torch.pow(b, float(n));
  // the leaves of the shared count and the row leaves both take them here
  __device__ __forceinline__ void at_count(int n) {
    const float cnt = static_cast<float>(n);
    c1 = 1.0f - powf(b1, cnt);
    c2 = 1.0f - powf(b2, cnt);
  }

  // optim.adam_update for one element behind the guard's where, in its order
  // of operations; kRow: optim.adam_rows_update's (1 - b2) * (g * g)
  template <bool kRow>
  __device__ __forceinline__ void step(bool ok, float g, float& p, float& m, float& v) const {
    const float m1 = b1 * m + omb1 * g;
    float g2;
    if (kRow) {
      g2 = g * g;
      g2 = omb2 * g2;
    } else {
      g2 = omb2 * g;
      g2 = g2 * g;
    }
    const float v1 = b2 * v + g2;
    const float u = (neg_lr * (m1 / c1)) / (sqrtf(v1 / c2) + eps);
    p = p + (ok ? u : 0.0f);
    if (ok) {
      m = m1;
      v = v1;
    }
  }
};

// one chunk of a leaf of the shared count
__device__ __forceinline__ void adam_chunk(const AdamTable& t, const Chunk& ch, const Adam& adam,
                                           bool ok) {
  const int l = ch.leaf;
  const Grad g = grad_of(t, ch);
  const float* p = t.p[l] + ch.offset;
  const float* m = t.m[l] + ch.offset;
  const float* v = t.v[l] + ch.offset;
  float* po = t.p_out[l] + ch.offset;
  float* mo = t.m_out[l] + ch.offset;
  float* vo = t.v_out[l] + ch.offset;
  int head = 0;
  if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(po) && aligned16(mo)
      && aligned16(vo)) {
    const bool g_vec = g.width == 0 && aligned16(g.g);
    const int n4 = ch.len >> 2;
    for (int i = threadIdx.x; i < n4; i += kTailThreads) {
      const float4 g4 = g_vec ? reinterpret_cast<const float4*>(g.g)[i]
                              : make_float4(g[4 * i], g[4 * i + 1], g[4 * i + 2], g[4 * i + 3]);
      float4 p4 = reinterpret_cast<const float4*>(p)[i];
      float4 m4 = reinterpret_cast<const float4*>(m)[i];
      float4 v4 = reinterpret_cast<const float4*>(v)[i];
      adam.step<false>(ok, g4.x, p4.x, m4.x, v4.x);
      adam.step<false>(ok, g4.y, p4.y, m4.y, v4.y);
      adam.step<false>(ok, g4.z, p4.z, m4.z, v4.z);
      adam.step<false>(ok, g4.w, p4.w, m4.w, v4.w);
      reinterpret_cast<float4*>(po)[i] = p4;
      reinterpret_cast<float4*>(mo)[i] = m4;
      reinterpret_cast<float4*>(vo)[i] = v4;
    }
    head = n4 << 2;
  }
  for (int i = head + threadIdx.x; i < ch.len; i += kTailThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam.step<false>(ok, g[i], pi, mi, vi);
    po[i] = pi;
    mo[i] = mi;
    vo[i] = vi;
  }
}

// one chunk of a row leaf: each row with its own count and selection
__device__ __forceinline__ void adam_rows_chunk(const AdamTable& t, const Chunk& ch, Adam adam,
                                                bool rows_ok, const float* __restrict__ drawn,
                                                const int* __restrict__ row_count) {
  const int l = ch.leaf;
  const int width = t.row_width[l];
  const Grad g = grad_of(t, ch);
  for (int i = threadIdx.x; i < ch.len; i += kTailThreads) {
    const long long e = ch.offset + i;
    const int r = static_cast<int>(e / width);
    const bool sel = rows_ok && drawn[r] > 0.0f;
    const int n = row_count[r] + (sel ? 1 : 0);
    adam.at_count(n < 1 ? 1 : n);
    float pi = t.p[l][e], mi = t.m[l][e], vi = t.v[l][e];
    adam.step<true>(sel, g[i], pi, mi, vi);
    t.p_out[l][e] = pi;
    t.m_out[l][e] = mi;
    t.v_out[l][e] = vi;
  }
}

__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSm)
optim_tail_adam_update_kernel(const __grid_constant__ AdamTable t,
                              const int* __restrict__ part_bad, int nparts,
                              const int* __restrict__ count, int* __restrict__ count_out,
                              bool* __restrict__ ok_out, const float* __restrict__ drawn,
                              const int* __restrict__ row_count, int* __restrict__ row_count_out,
                              int num_rows, int rows_on, float b1, float omb1, float b2,
                              float omb2, float eps) {
  __shared__ int s_ok[2];
  int bad = 0, bad_rows = 0;
  for (int i = threadIdx.x; i < nparts; i += kTailThreads) {
    bad += part_bad[2 * i];
    bad_rows += part_bad[2 * i + 1];
  }
  block_sum(bad_rows, bad);
  if (threadIdx.x == 0) {
    s_ok[0] = bad == 0;
    s_ok[1] = rows_on != 0 && bad_rows == 0;
  }
  __syncthreads();
  const bool ok = s_ok[0] != 0, rows_ok = s_ok[1] != 0;
  const int next = *count + 1;
  Adam adam{0.0f, 1.0f, 1.0f, b1, omb1, b2, omb2, eps};
  adam.at_count(next);
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      *count_out = ok ? next : *count;
      *ok_out = ok;
    }
    for (int r = threadIdx.x; r < num_rows; r += kTailThreads)
      row_count_out[r] = row_count[r] + (rows_ok && drawn[r] > 0.0f ? 1 : 0);
  }
  for (int c = blockIdx.x; c < t.num_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(t, c);
    adam.neg_lr = t.neg_lr[ch.leaf];
    if (t.row_width[ch.leaf] > 0) adam_rows_chunk(t, ch, adam, rows_ok, drawn, row_count);
    else adam_chunk(t, ch, adam, ok);
  }
}

}  // namespace ghoptim

using namespace ghoptim;

// The layout constants and the tables' sizes, so that the wrapper's mirrors
// of the tables can be checked: out[0..6] = chunk, threads, blocks per SM,
// leaves per TailTable, TailTable bytes, leaves per AdamTable, AdamTable bytes.
extern "C" int optim_tail_layout(int* out) {
  out[0] = kTailChunk;
  out[1] = kTailThreads;
  out[2] = kTailBlocksPerSm;
  out[3] = kTailMaxLeaves;
  out[4] = static_cast<int>(sizeof(TailTable));
  out[5] = kAdamMaxLeaves;
  out[6] = static_cast<int>(sizeof(AdamTable));
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

extern "C" int optim_tail_adam_guard(const AdamTable* table, int grid, int* part_bad,
                                     void* stream) {
  optim_tail_adam_guard_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, part_bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int optim_tail_adam_update(const AdamTable* table, int grid, const int* part_bad,
                                      int nparts, const int* count, int* count_out, bool* ok_out,
                                      const float* drawn, const int* row_count,
                                      int* row_count_out, int num_rows, int rows_on, float b1,
                                      float omb1, float b2, float omb2, float eps,
                                      void* stream) {
  optim_tail_adam_update_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, part_bad, nparts, count, count_out, ok_out, drawn, row_count, row_count_out,
      num_rows, rows_on, b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}
