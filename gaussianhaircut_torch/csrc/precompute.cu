// The precompute in one pass per Gaussian, forward and backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's precompute
// (render/renderer.py: prepare_raster_inputs_rowmajor) is plain jnp, which XLA
// fuses inside the jitted step.  The port ran it eagerly as a chain of small
// PyTorch ops on [P, 3, 3] tensors (render/renderer.py: precompute_plain):
// each 3x3 product a cuBLAS batched SGEMM with one matrix per 32x32 tile, the
// backward autograd over the whole chain, ~750 launches per camera in all.
//
// What it computes, per Gaussian, in float32 (the composition's operations
// and constants; ops/projection.py, ops/sh.py; its rounding too, below):
//   s = scaling * modifier; Sigma = (S R)^T (S R);
//   t = xyz V[:3, :3] + V[3, :3] (row-vector view matrix V);
//   J from t with tx / tz, ty / tz clamped to +-1.3 tan_fov, the focals
//   (1 / (2 tan_fov)) * width, height; T = V[:3, :3] J;
//   cov2d = T^T Sigma T + 0.3 on the diagonal; conic = adj / (det + 1e-12);
//   ndc = p[:3] / (p[3] + 1e-7) + viewspace with p = xyz M[:3] + M[3];
//   rgb = max(eval_sh(deg, features, unit(xyz - campos)) + 0.5, 0), NaN kept;
//   dir2d = (R[j] s[j]) T, j the first largest scale (NaN counts as largest),
//   and dir2d and orient_conf times use_direction where the fields carry it;
//   colors = [rgb, label, 1, dir2d, orient_conf, tz], depth = tz.
// The forward rounds as the composition does on the card: each matrix
// product's sum as fused multiply-adds in ascending order, which is how
// cuBLAS sums the composition's 3- and 16-term products there, and every
// other step as its own rounded operation, as PyTorch's elementwise ops do
// (the build's -fmad=false keeps them unfused).  So ndc, conic and depth,
// which the binning and the compositing kernels decide on (tiles, the alpha
// test, the depth order), are the composition's bit for bit, and a run
// takes the same discrete decisions as a reference that composes the same
// ops.
// The backward recomputes all of it from the inputs and runs the chain rule
// by hand, formula by formula as tests/precompute_twin.py writes it (which
// the CPU tests hold against autograd of the composition); the clamps pass a
// gradient on their bounds as torch.clamp does.  Where a camera tensor needs
// a gradient, each thread's contribution to the 33 camera values it reaches
// (V[:, :3], M, campos, tan_fovx, tan_fovy) is summed per block in a fixed
// order in double into part[block][33], and precompute_cam_reduce sums the
// blocks in a fixed order in double.  No atomics: two runs agree bit for bit.
//
// What bounds it on the H100: bytes.  Per Gaussian at 16 SH rows the forward
// reads 276 B and writes 68 B; the backward reads 324 B (xyz, features,
// scaling, rot, use_direction and the gradients of ndc, conic, colors and
// depth) and writes 260 B (the viewspace's gradient is the NDC's, passed through by
// the wrapper).  At 1M Gaussians: 0.10 + 0.18 ms at 3.35 TB/s.  The few
// hundred operations per Gaussian are far below the card's rate.
//
// Layout: one thread per Gaussian, kThreads per block.  A block's rows of a
// [P, w] array are one contiguous run of kThreads * w floats (w > 1): the
// block copies it into shared memory with 16-byte loads where the array is
// 16-byte aligned, and each thread reads its own row there, at a row stride
// of w rounded up to an odd number, so that a warp's 32 rows fall in 32
// banks.  Outputs go back the same way.  Arrays of one float per Gaussian
// are read and written in place, which is coalesced already.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCamValues = 33;   // V[i][j] (i < 4, j < 3), M (16), campos (3), tan x, tan y
constexpr int kCamFloats = 37;   // the packed camera: V (16), M (16), campos (3), tan x, tan y
constexpr int kMaxRows = 25;     // SH rows a Gaussian may store
constexpr int kReduceThreads = 256;
enum { kV = 0, kM = 16, kCampos = 32, kTanX = 35, kTanY = 36 };

// ops/sh.py's constants
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f, kC2_1 = -1.0925484305920792f,
                kC2_2 = 0.31539156525252005f, kC2_3 = -1.0925484305920792f,
                kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f, kC3_1 = 2.890611442640554f,
                kC3_2 = -0.4570457994644658f, kC3_3 = 0.3731763325901154f,
                kC3_4 = -0.4570457994644658f, kC3_5 = 1.445305721320277f,
                kC3_6 = -0.5900435899266435f;

__host__ __device__ constexpr int odd(int w) { return w | 1; }

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// rows [first, first + n) of a [P, w] array into shared memory at row
// stride odd(w); first is a multiple of kThreads, so the run starts 16-byte
// aligned wherever the array does
__device__ void stage_in(float* __restrict__ s, const float* __restrict__ g, long long first,
                         int n, int w) {
  const float* src = g + first * w;
  const int total = n * w, sw = odd(w);
  int head = 0;
  if (aligned16(src)) {
    const int n4 = total >> 2;
    for (int v = threadIdx.x; v < n4; v += kThreads) {
      const float4 q = reinterpret_cast<const float4*>(src)[v];
      const float vals[4] = {q.x, q.y, q.z, q.w};
      int r = (v << 2) / w, c = (v << 2) - r * w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[r * sw + c] = vals[k];
        if (++c == w) { c = 0; ++r; }
      }
    }
    head = n4 << 2;
  }
  for (int e = head + threadIdx.x; e < total; e += kThreads) {
    const int r = e / w;
    s[r * sw + e - r * w] = src[e];
  }
}

// the mirror of stage_in: shared rows back to rows [first, first + n)
__device__ void stage_out(float* __restrict__ g, const float* __restrict__ s, long long first,
                          int n, int w) {
  float* dst = g + first * w;
  const int total = n * w, sw = odd(w);
  int head = 0;
  if (aligned16(dst)) {
    const int n4 = total >> 2;
    for (int v = threadIdx.x; v < n4; v += kThreads) {
      float vals[4];
      int r = (v << 2) / w, c = (v << 2) - r * w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vals[k] = s[r * sw + c];
        if (++c == w) { c = 0; ++r; }
      }
      reinterpret_cast<float4*>(dst)[v] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    head = n4 << 2;
  }
  for (int e = head + threadIdx.x; e < total; e += kThreads) {
    const int r = e / w;
    dst[e] = s[r * sw + e - r * w];
  }
}

// ops/sh.py: sh_basis, term by term in its order of operations
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if constexpr (DEG > 0) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2_0 * xy;
    b[5] = kC2_1 * yz;
    b[6] = kC2_2 * (2.0f * zz - xx - yy);
    b[7] = kC2_3 * xz;
    b[8] = kC2_4 * (xx - yy);
    if constexpr (DEG > 2) {
      b[9] = kC3_0 * y * (3.0f * xx - yy);
      b[10] = kC3_1 * xy * z;
      b[11] = kC3_2 * y * (4.0f * zz - xx - yy);
      b[12] = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC3_4 * x * (4.0f * zz - xx - yy);
      b[14] = kC3_5 * z * (xx - yy);
      b[15] = kC3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// (d/dx, d/dy, d/dz) of sum_k gb[k] basis_k
template <int DEG>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z, const float* gb,
                                              float& gx, float& gy, float& gz) {
  gx = 0.0f;
  gy = 0.0f;
  gz = 0.0f;
  if constexpr (DEG > 0) {
    gy = gy - kC1 * gb[1];
    gz = gz + kC1 * gb[2];
    gx = gx - kC1 * gb[3];
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    gx = gx + kC2_0 * y * gb[4] - 2.0f * kC2_2 * x * gb[6] + kC2_3 * z * gb[7]
         + 2.0f * kC2_4 * x * gb[8];
    gy = gy + kC2_0 * x * gb[4] + kC2_1 * z * gb[5] - 2.0f * kC2_2 * y * gb[6]
         - 2.0f * kC2_4 * y * gb[8];
    gz = gz + kC2_1 * y * gb[5] + 4.0f * kC2_2 * z * gb[6] + kC2_3 * x * gb[7];
    if constexpr (DEG > 2) {
      gx = gx + (kC3_0 * 6.0f * xy * gb[9] + kC3_1 * yz * gb[10]
                 - kC3_2 * 2.0f * xy * gb[11] - kC3_3 * 6.0f * xz * gb[12]
                 + kC3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13]
                 + kC3_5 * 2.0f * xz * gb[14] + kC3_6 * 3.0f * (xx - yy) * gb[15]);
      gy = gy + (kC3_0 * 3.0f * (xx - yy) * gb[9] + kC3_1 * xz * gb[10]
                 + kC3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11]
                 - kC3_3 * 6.0f * yz * gb[12] - kC3_4 * 2.0f * xy * gb[13]
                 - kC3_5 * 2.0f * yz * gb[14] - kC3_6 * 6.0f * xy * gb[15]);
      gz = gz + (kC3_1 * xy * gb[10] + kC3_2 * 8.0f * yz * gb[11]
                 + kC3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12]
                 + kC3_4 * 8.0f * xz * gb[13] + kC3_5 * (xx - yy) * gb[14]);
    }
  }
}

// a0 b0 + a1 b1 + a2 b2 as cuBLAS sums a 3-term product on the card: fused
// multiply-adds in ascending order
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
}

// the forward's intermediates of one Gaussian, which the backward recomputes
struct Geom {
  float s[3];                         // scaling * modifier
  float m[3][3], sig[3][3];           // S R and Sigma = m^T m
  float t[3];                         // view-space position
  float recx, recy, fx, fy, limx, limy;
  float ux, uy, cx, cy, txc, tyc;     // t / tz, clamped, times tz
  float j00, j20, j11, j21;           // the EWA Jacobian's non-zero entries
  float T[3][2];                      // V[:3, :3] J, its two non-zero columns
  float A[2][3];                      // T^T Sigma
  float ca, cb, cc, det_inv;          // cov2d (+0.3) and 1 / (det + 1e-12)
  float p[4], pw;                     // clip-space position and 1 / (w + 1e-7)
  float d[3], n2, r, dir[3];          // xyz - campos, |.|^2, its clamped norm, unit
  int j;                              // the principal axis
  float dv[3];                        // R[j] s[j]
  float dir2[2];                      // dv T, before use_direction

  __device__ __forceinline__ void compute(const float* x, const float* scl, const float* R,
                                          const float* cam, float mod, int width,
                                          int height) {
    const float* V = cam + kV;
    const float* M = cam + kM;
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] = scl[a] * mod;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) m[a][b] = s[a] * R[3 * a + b];
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) sig[b][c] = dot3(m[0][b], m[0][c], m[1][b], m[1][c], m[2][b], m[2][c]);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = dot3(x[0], V[k], x[1], V[4 + k], x[2], V[8 + k]) + V[12 + k];
    const float tz = t[2];
    const float tanx = cam[kTanX], tany = cam[kTanY];
    recx = 1.0f / (2.0f * tanx);
    recy = 1.0f / (2.0f * tany);
    fx = recx * static_cast<float>(width);
    fy = recy * static_cast<float>(height);
    limx = 1.3f * tanx;
    limy = 1.3f * tany;
    ux = t[0] / tz;
    uy = t[1] / tz;
    // torch.clamp(u, -lim, lim): NaN stays NaN
    cx = ux < -limx ? -limx : (ux > limx ? limx : ux);
    cy = uy < -limy ? -limy : (uy > limy ? limy : uy);
    txc = cx * tz;
    tyc = cy * tz;
    j00 = fx / tz;
    j11 = fy / tz;
    j20 = -(fx * txc) / (tz * tz);
    j21 = -(fy * tyc) / (tz * tz);
    // J's first column is (j00, 0, j20), its second (0, j11, j21): a zero
    // term adds nothing to the chain
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T[i][0] = __fmaf_rn(V[4 * i + 2], j20, V[4 * i] * j00);
      T[i][1] = __fmaf_rn(V[4 * i + 2], j21, V[4 * i + 1] * j11);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        A[a][k] = dot3(T[0][a], sig[0][k], T[1][a], sig[1][k], T[2][a], sig[2][k]);
    ca = dot3(A[0][0], T[0][0], A[0][1], T[1][0], A[0][2], T[2][0]) + 0.3f;
    cb = dot3(A[0][0], T[0][1], A[0][1], T[1][1], A[0][2], T[2][1]);
    cc = dot3(A[1][0], T[0][1], A[1][1], T[1][1], A[1][2], T[2][1]) + 0.3f;
    det_inv = 1.0f / (ca * cc - cb * cb + 1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = dot3(x[0], M[k], x[1], M[4 + k], x[2], M[8 + k]) + M[12 + k];
    pw = 1.0f / (p[3] + 1e-7f);
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = x[i] - cam[kCampos + i];
    n2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    r = sqrtf(n2 < 1e-24f ? 1e-24f : n2);
#pragma unroll
    for (int i = 0; i < 3; ++i) dir[i] = d[i] / r;
    // argmax: the first largest, NaN counting as largest
    j = 0;
#pragma unroll
    for (int a = 1; a < 3; ++a)
      if (s[a] > s[j] || (isnan(s[a]) && !isnan(s[j]))) j = a;
    const float sj = s[j];
#pragma unroll
    for (int i = 0; i < 3; ++i) dv[i] = R[3 * j + i] * sj;
#pragma unroll
    for (int c = 0; c < 2; ++c) dir2[c] = dot3(dv[0], T[0][c], dv[1], T[1][c], dv[2], T[2][c]);
  }
};

template <int DEG>
__global__ void __launch_bounds__(kThreads)
precompute_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ features,
                      const float* __restrict__ scaling, const float* __restrict__ rot,
                      const float* __restrict__ label, const float* __restrict__ orient_conf,
                      const float* __restrict__ viewspace, const float* __restrict__ use_dir,
                      const float* __restrict__ cam, float* __restrict__ ndc,
                      float* __restrict__ conic, float* __restrict__ colors,
                      float* __restrict__ depth, int P, int rows, int width, int height,
                      float mod) {
  constexpr int NK = (DEG + 1) * (DEG + 1);
  extern __shared__ float smem[];
  __shared__ float s_cam[kCamFloats];
  const int fw = 3 * rows, sfw = odd(fw);
  float* s_xyz = smem;
  float* s_scl = s_xyz + kThreads * 3;
  float* s_vs = s_scl + kThreads * 3;
  float* s_rot = s_vs + kThreads * 3;
  float* s_feat = s_rot + kThreads * 9;
  float* s_ndc = s_feat + kThreads * sfw;
  float* s_conic = s_ndc + kThreads * 3;
  float* s_col = s_conic + kThreads * 3;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int n = min(static_cast<long long>(kThreads), P - first);
  if (threadIdx.x < kCamFloats) s_cam[threadIdx.x] = cam[threadIdx.x];
  stage_in(s_xyz, xyz, first, n, 3);
  stage_in(s_scl, scaling, first, n, 3);
  stage_in(s_vs, viewspace, first, n, 3);
  stage_in(s_rot, rot, first, n, 9);
  stage_in(s_feat, features, first, n, fw);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < n) {
    const long long i = first + tid;
    Geom g;
    g.compute(s_xyz + 3 * tid, s_scl + 3 * tid, s_rot + 9 * tid, s_cam, mod, width, height);
    const float* vs = s_vs + 3 * tid;
#pragma unroll
    for (int k = 0; k < 3; ++k) s_ndc[3 * tid + k] = g.p[k] * g.pw + vs[k];
    s_conic[3 * tid] = g.cc * g.det_inv;
    s_conic[3 * tid + 1] = -g.cb * g.det_inv;
    s_conic[3 * tid + 2] = g.ca * g.det_inv;
    float b[NK];
    sh_basis<DEG>(g.dir[0], g.dir[1], g.dir[2], b);
    const float* sh = s_feat + sfw * tid;
    float* col = s_col + odd(10) * tid;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * sh[c];
#pragma unroll
      for (int k = 1; k < NK; ++k) acc = __fmaf_rn(b[k], sh[3 * k + c], acc);
      const float raw = acc + 0.5f;
      col[c] = raw < 0.0f ? 0.0f : raw;
    }
    // without use_direction u is 1, and x * 1 is x
    const float u = use_dir ? use_dir[i] : 1.0f;
    col[3] = label[i];
    col[4] = 1.0f;
    col[5] = g.dir2[0] * u;
    col[6] = g.dir2[1] * u;
    col[7] = dot3(g.dv[0], 0.0f, g.dv[1], 0.0f, g.dv[2], 0.0f) * u;
    col[8] = orient_conf[i] * u;
    col[9] = g.t[2];
    depth[i] = g.t[2];
  }
  __syncthreads();
  stage_out(ndc, s_ndc, first, n, 3);
  stage_out(conic, s_conic, first, n, 3);
  stage_out(colors, s_col, first, n, 10);
}

// the block's sum of v over its threads in a fixed order (shuffles within
// each warp, then the warps in order); valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_warp[w];
  return total;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
precompute_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ features,
                      const float* __restrict__ scaling, const float* __restrict__ rot,
                      const float* __restrict__ use_dir,
                      const float* __restrict__ cam, const float* __restrict__ g_ndc,
                      const float* __restrict__ g_conic, const float* __restrict__ g_colors,
                      const float* __restrict__ g_depth, float* __restrict__ g_xyz,
                      float* __restrict__ g_features, float* __restrict__ g_scaling,
                      float* __restrict__ g_rot, float* __restrict__ g_label,
                      float* __restrict__ g_oc, double* __restrict__ cam_part, int P,
                      int rows, int width, int height, float mod) {
  constexpr int NK = (DEG + 1) * (DEG + 1);
  extern __shared__ float smem[];
  __shared__ float s_cam[kCamFloats];
  __shared__ double s_part[kThreads / 32][kCamValues];
  const int fw = 3 * rows, sfw = odd(fw);
  // the inputs' rows; each thread overwrites its own rows of xyz, scaling,
  // rot and features with their gradients once it has read them
  float* s_xyz = smem;
  float* s_scl = s_xyz + kThreads * 3;
  float* s_rot = s_scl + kThreads * 3;
  float* s_gndc = s_rot + kThreads * 9;
  float* s_gconic = s_gndc + kThreads * 3;
  float* s_gcol = s_gconic + kThreads * 3;
  float* s_feat = s_gcol + kThreads * odd(10);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int n = min(static_cast<long long>(kThreads), P - first);
  if (threadIdx.x < kCamFloats) s_cam[threadIdx.x] = cam[threadIdx.x];
  stage_in(s_xyz, xyz, first, n, 3);
  stage_in(s_scl, scaling, first, n, 3);
  stage_in(s_rot, rot, first, n, 9);
  stage_in(s_feat, features, first, n, fw);
  if (g_ndc) stage_in(s_gndc, g_ndc, first, n, 3);
  if (g_conic) stage_in(s_gconic, g_conic, first, n, 3);
  if (g_colors) stage_in(s_gcol, g_colors, first, n, 10);
  __syncthreads();
  const int tid = threadIdx.x;
  float cv[kCamValues];
#pragma unroll
  for (int v = 0; v < kCamValues; ++v) cv[v] = 0.0f;
  if (tid < n) {
    const long long i = first + tid;
    float* xr = s_xyz + 3 * tid;
    float* sr = s_scl + 3 * tid;
    float* Rr = s_rot + 9 * tid;
    const float x[3] = {xr[0], xr[1], xr[2]};
    float R[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rr[k];
    Geom g;
    g.compute(x, sr, R, s_cam, mod, width, height);
    const float* V = s_cam + kV;
    const float* M = s_cam + kM;
    const float tz = g.t[2];
    const float u = use_dir ? use_dir[i] : 1.0f;
    float gn[3] = {0.0f, 0.0f, 0.0f}, gq[3] = {0.0f, 0.0f, 0.0f}, gc[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) gc[k] = g_colors ? s_gcol[odd(10) * tid + k] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (g_ndc) gn[k] = s_gndc[3 * tid + k];
      if (g_conic) gq[k] = s_gconic[3 * tid + k];
    }
    const float gd = g_depth ? g_depth[i] : 0.0f;
    float gx[3] = {0.0f, 0.0f, 0.0f}, gs[3] = {0.0f, 0.0f, 0.0f}, gR[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) gR[a][b] = 0.0f;

    // colours: the SH, through the unit direction into xyz and campos
    float b[NK], gb[NK];
    sh_basis<DEG>(g.dir[0], g.dir[1], g.dir[2], b);
    float* sh = s_feat + sfw * tid;
    float graw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * sh[c];
#pragma unroll
      for (int k = 1; k < NK; ++k) acc = __fmaf_rn(b[k], sh[3 * k + c], acc);
      graw[c] = acc + 0.5f >= 0.0f ? gc[c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      gb[k] = sh[3 * k] * graw[0] + sh[3 * k + 1] * graw[1] + sh[3 * k + 2] * graw[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) sh[3 * k + c] = b[k] * graw[c];
    }
    for (int e = 3 * NK; e < fw; ++e) sh[e] = 0.0f;
    float gdr[3];
    sh_basis_grad<DEG>(g.dir[0], g.dir[1], g.dir[2], gb, gdr[0], gdr[1], gdr[2]);
    const float gr = -(gdr[0] * g.d[0] + gdr[1] * g.d[1] + gdr[2] * g.d[2]) / (g.r * g.r);
    const float gn2 = g.n2 >= 1e-24f ? gr * 0.5f / g.r : 0.0f;
    float gdd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gdd[k] = gdr[k] / g.r + 2.0f * g.d[k] * gn2;
      gx[k] = gx[k] + gdd[k];
    }
    // the NDC
    float gp[4];
#pragma unroll
    for (int k = 0; k < 3; ++k) gp[k] = gn[k] * g.pw;
    const float gpw = gn[0] * g.p[0] + gn[1] * g.p[1] + gn[2] * g.p[2];
    gp[3] = -gpw * g.pw * g.pw;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gx[k] = gx[k] + (M[4 * k] * gp[0] + M[4 * k + 1] * gp[1] + M[4 * k + 2] * gp[2]
                       + M[4 * k + 3] * gp[3]);
    // the conic, into the 2-D covariance, T and the 3-D covariance
    const float gdi = gq[0] * g.cc - gq[1] * g.cb + gq[2] * g.ca;
    const float gdet = -gdi * g.det_inv * g.det_inv;
    const float G00 = gq[2] * g.det_inv + gdet * g.cc;
    const float G01 = -gq[1] * g.det_inv - 2.0f * g.cb * gdet;
    const float G11 = gq[0] * g.det_inv + gdet * g.ca;
    float gA[2][3], gT[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gA[0][k] = G00 * g.T[k][0] + G01 * g.T[k][1];
      gA[1][k] = G11 * g.T[k][1];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gT[k][0] = g.A[0][k] * G00
                 + (g.sig[k][0] * gA[0][0] + g.sig[k][1] * gA[0][1] + g.sig[k][2] * gA[0][2]);
      gT[k][1] = g.A[0][k] * G01 + g.A[1][k] * G11
                 + (g.sig[k][0] * gA[1][0] + g.sig[k][1] * gA[1][1] + g.sig[k][2] * gA[1][2]);
    }
    float gSig[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k) gSig[a][k] = g.T[a][0] * gA[0][k] + g.T[a][1] * gA[1][k];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float gm = g.m[a][0] * (gSig[k][0] + gSig[0][k])
                         + g.m[a][1] * (gSig[k][1] + gSig[1][k])
                         + g.m[a][2] * (gSig[k][2] + gSig[2][k]);
        gs[a] = gs[a] + gm * R[3 * a + k];
        gR[a][k] = gR[a][k] + gm * g.s[a];
      }
    // the 2-D direction, through T and the principal axis
    const float gdir0 = gc[5] * u, gdir1 = gc[6] * u;
    float gdv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gdv[k] = g.T[k][0] * gdir0 + g.T[k][1] * gdir1;
      gT[k][0] = gT[k][0] + g.dv[k] * gdir0;
      gT[k][1] = gT[k][1] + g.dv[k] * gdir1;
    }
    const float sj = g.s[g.j];
    const float gsj = gdv[0] * R[3 * g.j] + gdv[1] * R[3 * g.j + 1] + gdv[2] * R[3 * g.j + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool hit = g.j == a;
      gs[a] = gs[a] + (hit ? gsj : 0.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) gR[a][k] = gR[a][k] + (hit ? gdv[k] * sj : 0.0f);
    }
    // T = V J, into J and the view matrix
    const float gJ00 = V[0] * gT[0][0] + V[4] * gT[1][0] + V[8] * gT[2][0];
    const float gJ20 = V[2] * gT[0][0] + V[6] * gT[1][0] + V[10] * gT[2][0];
    const float gJ11 = V[1] * gT[0][1] + V[5] * gT[1][1] + V[9] * gT[2][1];
    const float gJ21 = V[2] * gT[0][1] + V[6] * gT[1][1] + V[10] * gT[2][1];
    float gV[4][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gV[k][0] = gT[k][0] * g.j00;
      gV[k][1] = gT[k][1] * g.j11;
      gV[k][2] = gT[k][0] * g.j20 + gT[k][1] * g.j21;
    }
    // J_d = f / tz and J_n = -(f t_c) / tz^2, t_c = clamp(u, -lim, lim) tz,
    // u = t / tz, per axis -> the gradients of f, t, tz and lim
    float gf[2], gtv[2], glim[2], gtz = gc[9] + gd;
    {
      const float gJd[2] = {gJ00, gJ11}, gJn[2] = {gJ20, gJ21};
      const float f[2] = {g.fx, g.fy}, tc[2] = {g.txc, g.tyc}, cl[2] = {g.cx, g.cy};
      const float uu[2] = {g.ux, g.uy}, lim[2] = {g.limx, g.limy};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float gfa = gJd[a] / tz;
        float gtza = -gJd[a] * f[a] / (tz * tz);
        const float q = f[a] * tc[a], den = tz * tz;
        const float g_q = -gJn[a] / den;
        gtza = gtza + 2.0f * tz * (gJn[a] * q / (den * den));
        gfa = gfa + g_q * tc[a];
        const float g_tc = g_q * f[a];
        const float g_c = g_tc * tz;
        gtza = gtza + g_tc * cl[a];
        const bool inside = uu[a] >= -lim[a] && uu[a] <= lim[a];
        const float g_u = inside ? g_c : 0.0f;
        glim[a] = (uu[a] > lim[a] ? g_c : 0.0f) - (uu[a] < -lim[a] ? g_c : 0.0f);
        gf[a] = gfa;
        gtv[a] = g_u / tz;
        gtz = gtz + (gtza - g_u * g.t[a] / (tz * tz));
      }
    }
    const float gt[3] = {gtv[0], gtv[1], gtz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gx[k] = gx[k] + (V[4 * k] * gt[0] + V[4 * k + 1] * gt[1] + V[4 * k + 2] * gt[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) gV[k][c] = gV[k][c] + x[k] * gt[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) gV[3][c] = gt[c];

    // this Gaussian's gradients, over its own shared rows
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xr[k] = gx[k];
      sr[k] = gs[k] * mod;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k) Rr[3 * a + k] = gR[a][k];
    if (g_label) g_label[i] = gc[3];
    if (g_oc) g_oc[i] = gc[8] * u;

    if (cam_part) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) cv[3 * a + c] = gV[a][c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[12 + 4 * a + k] = a < 3 ? x[a] * gp[k] : gp[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) cv[28 + k] = -gdd[k];
      cv[31] = -(gf[0] * static_cast<float>(width)) * g.recx * g.recx * 2.0f + 1.3f * glim[0];
      cv[32] = -(gf[1] * static_cast<float>(height)) * g.recy * g.recy * 2.0f + 1.3f * glim[1];
    }
  }
  __syncthreads();
  if (g_xyz) stage_out(g_xyz, s_xyz, first, n, 3);
  if (g_scaling) stage_out(g_scaling, s_scl, first, n, 3);
  if (g_rot) stage_out(g_rot, s_rot, first, n, 9);
  if (g_features) stage_out(g_features, s_feat, first, n, fw);
  if (cam_part) {   // uniform over the block
    // the block's sum of each camera value in a fixed order: shuffles
    // within each warp, then thread v adds the warps' sums of value v in order
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int v = 0; v < kCamValues; ++v) {
      double x = static_cast<double>(cv[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
      if ((threadIdx.x & 31) == 0) s_part[warp][v] = x;
    }
    __syncthreads();
    if (threadIdx.x < kCamValues) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sum += s_part[w][threadIdx.x];
      cam_part[static_cast<long long>(blockIdx.x) * kCamValues + threadIdx.x] = sum;
    }
  }
}

// the camera's gradient: block v sums value v over the blocks' partials in a
// fixed order (each thread a strided run, then block_sum) and writes it to
// its slot of the packed camera; the view matrix's last column is 0
__global__ void __launch_bounds__(kReduceThreads)
precompute_cam_reduce_kernel(const double* __restrict__ part, int blocks,
                             float* __restrict__ out) {
  __shared__ double s_warp[kReduceThreads / 32];
  const int v = blockIdx.x;
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads)
    acc += part[static_cast<long long>(b) * kCamValues + v];
  const double sum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) {
    const int slot = v < 12 ? 4 * (v / 3) + v % 3 : v + 4;
    out[slot] = static_cast<float>(sum);
    if (v < 4) out[4 * v + 3] = 0.0f;
  }
}

size_t fwd_smem(int rows) {
  return sizeof(float) * kThreads * (3 + 3 + 3 + 9 + odd(3 * rows) + 3 + 3 + odd(10));
}

size_t bwd_smem(int rows) {
  return sizeof(float) * kThreads * (3 + 3 + 9 + 3 + 3 + odd(10) + odd(3 * rows));
}

// launches kernel with smem bytes of dynamic shared memory, raising the
// kernel's limit first where the bytes pass the default 48 KB
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[0..3] = threads per block, camera values per block, camera floats, SH
// rows a Gaussian may store
extern "C" int precompute_layout(int* out) {
  out[0] = kThreads;
  out[1] = kCamValues;
  out[2] = kCamFloats;
  out[3] = kMaxRows;
  return 0;
}

extern "C" int precompute_fwd(const float* xyz, const float* features, const float* scaling,
                              const float* rot, const float* label, const float* orient_conf,
                              const float* viewspace, const float* use_dir, const float* cam,
                              float* ndc, float* conic, float* colors, float* depth, int P,
                              int rows, int deg, int width, int height, float mod,
                              void* stream) {
  if (rows < (deg + 1) * (deg + 1) || rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (P + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(rows);
#define GH_FWD(D)                                                                        \
  launch(precompute_fwd_kernel<D>, grid, smem, st, xyz, features, scaling, rot, label,   \
         orient_conf, viewspace, use_dir, cam, ndc, conic, colors, depth, P, rows, width, \
         height, mod)
  switch (deg) {
    case 0: return GH_FWD(0);
    case 1: return GH_FWD(1);
    case 2: return GH_FWD(2);
    case 3: return GH_FWD(3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GH_FWD
}

extern "C" int precompute_bwd(const float* xyz, const float* features, const float* scaling,
                              const float* rot, const float* use_dir,
                              const float* cam, const float* g_ndc, const float* g_conic,
                              const float* g_colors, const float* g_depth, float* g_xyz,
                              float* g_features, float* g_scaling, float* g_rot,
                              float* g_label, float* g_oc, double* cam_part, int P, int rows,
                              int deg, int width, int height, float mod, void* stream) {
  if (rows < (deg + 1) * (deg + 1) || rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (P + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(rows);
#define GH_BWD(D)                                                                          \
  launch(precompute_bwd_kernel<D>, grid, smem, st, xyz, features, scaling, rot, use_dir, cam, \
         g_ndc, g_conic, g_colors, g_depth, g_xyz, g_features, g_scaling,     \
         g_rot, g_label, g_oc, cam_part, P, rows, width, height, mod)
  switch (deg) {
    case 0: return GH_BWD(0);
    case 1: return GH_BWD(1);
    case 2: return GH_BWD(2);
    case 3: return GH_BWD(3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GH_BWD
}

extern "C" int precompute_cam_reduce(const double* part, int blocks, float* out, void* stream) {
  precompute_cam_reduce_kernel<<<kCamValues, kReduceThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(part, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
