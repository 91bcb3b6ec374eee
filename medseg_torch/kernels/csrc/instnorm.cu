// N1: the affine instance norm of the UNETR and Swin UNETR conv blocks
// (UnetResBlock, UnetBasicBlock), per (b, c) plane of an NCDHW tensor (B*C
// planes of V voxels), fp32 or bf16 in and out, fp32 statistics:
//
//   forward   xh = (x - mean) * rstd,  z = xh * gamma + beta [+ r],  y = act(z)
//   backward  dz = dy * act'(z),  dgamma = sum dz*xh,  dbeta = sum dz  (over b, V)
//             dx = gamma*rstd * (dz - mean_V(dz) - xh * mean_V(dz*xh)),  dr = dz
//
// with act the leaky ReLU of the blocks (slope 0.01; act'(z) = 1 where z > 0,
// else 0.01, as torch's) or none, r an optional residual in x's dtype, mean
// and rstd = 1/sqrt(var + eps) of the plane (biased variance).
//
// Replaces no TPU kernel: the JAX package leaves this norm to XLA
// (medseg/models/blocks.py InstanceNorm), which fuses it with its neighbours.
// Added because the port's eager norm ran about 12 kernels forward and 15-20
// backward over fp32 copies of the activation, the largest device item of
// the training steps.
//
// What bounds it on the H100: device memory. A few operations per element
// against 4-10 bytes of traffic (bf16): at 3.35 TB/s the SMs wait on loads.
// The design moves each tensor about once:
//   - forward, planes of at most 64 KB (V <= 32^3 in bf16, 16384 voxels in
//     fp32): one block per plane reads it once into shared memory, reduces
//     the mean, then the centred squares from shared memory, and writes y
//     (instnorm_fwd_plane_kernel): 2 B read and 2 B written per element;
//   - forward, larger planes (48^3-128^3): a statistics pass
//     (instnorm_stats_kernel: each block takes a chunk of 256 threads x 4
//     16-byte words, holds it in registers and writes its exact centred
//     (mean, M2)), then the apply pass (instnorm_fwd_apply_kernel: each block
//     merges its plane's chunk partials by the parallel-axis rule,
//     M2 = sum M2_k + n_k (mean_k - mean)^2, which is Chan et al.'s merge
//     taken over all chunks at once, and normalises its chunk); no raw
//     ss/n - mean^2 anywhere;
//   - backward, two passes over chunks: instnorm_bwd_sums_kernel writes each
//     chunk's (sum dz, sum dz*xh); instnorm_bwd_dx_kernel adds its plane's
//     partials and writes dx (and dr); the blocks of chunk 0 at b = 0 also
//     add every b's plane sums for dgamma and dbeta. Nothing fp32 the size
//     of x is read or written: the backward takes x (and r) as they are and
//     the per-plane mean and rstd;
//   - act'(z) is the forward's own decision: the backward recomputes z from
//     the same x, r, mean, rstd, gamma and beta by the same operations,
//     each rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nothing
//     contracted into an FMA), so it gets the forward's fp32 bits;
//   - 16-byte loads and stores (8 bf16 or 4 fp32 voxels) where V is a
//     multiple of that and every tensor starts on 16 bytes (the wrapper's
//     vec), one voxel at a time otherwise, in the same kernels;
//   - every sum in a fixed order (each thread's own in sequence, the warp's
//     by a shuffle tree, the warps in order; chunks by index): two calls on
//     the same inputs give the same bits, and nothing is atomic or zeroed.
// The wrapper allocates every output and scratch buffer with torch.empty on
// the current stream and nothing here synchronises, so the launches capture
// into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int NT = 256;             // threads of the chunked kernels
constexpr int WORDS = 4;            // 16-byte words a thread takes in a chunk
constexpr int PLANE_MAX_THREADS = 512;
constexpr int PLANE_MAX_BYTES = 64 * 1024;  // largest plane the one-pass forward holds
constexpr int STATIC_SMEM = 48 * 1024;

// How a 16-byte word holds the dtype: N voxels.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void get(const uint4& w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 put(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t two(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half, round to nearest even
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void get(const uint4& w, float* v) {
    v[0] = lo(w.x);
    v[1] = hi(w.x);
    v[2] = lo(w.y);
    v[3] = hi(w.y);
    v[4] = lo(w.z);
    v[5] = hi(w.z);
    v[6] = lo(w.w);
    v[7] = hi(w.w);
  }
  static __device__ __forceinline__ uint4 put(const float* v) {
    return make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7]));
  }
};

// One plane's normalisation.
struct Norm {
  float mean, rstd, gamma, beta;
};

__device__ __forceinline__ float xhat_of(float x, const Norm& p) {
  return __fmul_rn(__fsub_rn(x, p.mean), p.rstd);
}

// z before the activation, as the forward rounds it; the backward's act'
// decision recomputes these bits
template <bool RES>
__device__ __forceinline__ float z_of(float xh, float r, const Norm& p) {
  const float z = __fadd_rn(__fmul_rn(xh, p.gamma), p.beta);
  return RES ? __fadd_rn(z, r) : z;
}

template <bool ACT>
__device__ __forceinline__ float act(float z) {
  return ACT ? (z > 0.f ? z : __fmul_rn(z, kLeakySlope)) : z;
}

template <bool ACT>
__device__ __forceinline__ float act_grad(float dy, float z) {
  return ACT ? (z > 0.f ? dy : __fmul_rn(dy, kLeakySlope)) : dy;
}

// The sum of v over the block, in a fixed order; every thread gets the same
// bits. red holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);  // a butterfly: every lane adds the same pairs
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

// A chunk of a plane as one block of NT threads holds it: E = WORDS * N
// slots a thread. With vec, slot k of thread t is voxel
// c0 + ((k / N) * NT + t) * N + k % N (16-byte words, neighbouring threads
// on neighbouring words); without, voxel c0 + k * NT + t.
template <typename T>
struct Chunk {
  static constexpr int N = Pack<T>::N;
  static constexpr int E = WORDS * N;
  static constexpr int ELEMS = NT * E;  // voxels of a chunk
  long long c0, end;                    // the chunk's voxels [c0, end) of the plane

  __device__ Chunk(int chunk, long long V)
      : c0((long long)chunk * ELEMS), end(min((long long)(chunk + 1) * ELEMS, V)) {}

  __device__ __forceinline__ long long voxel(int k, int vec) const {
    return vec ? c0 + ((long long)(k / N) * NT + threadIdx.x) * N + k % N
               : c0 + (long long)k * NT + threadIdx.x;
  }

  // the thread's slots of plane p (a plane's first voxel); 0 past the end
  __device__ __forceinline__ void load(const T* __restrict__ p, int vec, float (&v)[E]) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        const long long at = voxel(i * N, 1);
        if (at < end) {
          Pack<T>::get(__ldg(reinterpret_cast<const uint4*>(p + at)), v + i * N);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) v[i * N + j] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const long long at = voxel(k, 0);
        v[k] = at < end ? to_float<T>(p[at]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(T* __restrict__ p, int vec, const float (&v)[E]) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        const long long at = voxel(i * N, 1);
        if (at < end) *reinterpret_cast<uint4*>(p + at) = Pack<T>::put(v + i * N);
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const long long at = voxel(k, 0);
        if (at < end) p[at] = from_float<T>(v[k]);
      }
    }
  }
};

// The plane's (mean, M2) from its chunks' partials part[k] = (mean_k, M2_k):
// mean = sum n_k mean_k / V, M2 = sum M2_k + n_k (mean_k - mean)^2, each sum
// in a fixed order; every thread gets the same bits.
__device__ __forceinline__ float2 merge_moments(const float2* __restrict__ part, int nchunks,
                                                long long V, int elems, float* red) {
  float s = 0.f;
  for (int k = threadIdx.x; k < nchunks; k += blockDim.x) {
    const float n = (float)min((long long)elems, V - (long long)k * elems);
    s += n * part[k].x;
  }
  const float mean = block_sum(s, red) / (float)V;
  float q = 0.f;
  for (int k = threadIdx.x; k < nchunks; k += blockDim.x) {
    const float n = (float)min((long long)elems, V - (long long)k * elems);
    const float2 m = part[k];
    const float d = m.x - mean;
    q += m.y + n * d * d;
  }
  return make_float2(mean, block_sum(q, red));
}

// The plane's (sum dz, sum dz*xh) from its chunks' partials, in a fixed order.
__device__ __forceinline__ float2 merge_sums(const float2* __restrict__ part, int nchunks,
                                             float* red) {
  float s1 = 0.f, s2 = 0.f;
  for (int k = threadIdx.x; k < nchunks; k += blockDim.x) {
    const float2 m = part[k];
    s1 += m.x;
    s2 += m.y;
  }
  s1 = block_sum(s1, red);
  return make_float2(s1, block_sum(s2, red));
}

__device__ __forceinline__ float rstd_of(float m2, long long V, float eps) {
  return 1.f / sqrtf(m2 / (float)V + eps);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One block per plane (blockIdx.x = b * C + c), the plane in shared memory.
template <typename T, bool ACT, bool RES>
__global__ void __launch_bounds__(PLANE_MAX_THREADS)
    instnorm_fwd_plane_kernel(const T* __restrict__ x, const T* __restrict__ r,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int C, int V, float eps, int vec) {
  constexpr int N = Pack<T>::N;
  extern __shared__ uint4 s_words[];  // the plane: V values of T
  __shared__ float red[PLANE_MAX_THREADS / 32];
  T* s_vals = reinterpret_cast<T*>(s_words);
  const int plane = blockIdx.x;
  const long long base = (long long)plane * V;
  const T* xp = x + base;
  const int words = V / N;

  float s = 0.f;
  if (vec) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xp) + w);
      s_words[w] = raw;
      float v[N];
      Pack<T>::get(raw, v);
#pragma unroll
      for (int j = 0; j < N; ++j) s += v[j];
    }
  } else {
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const T t = xp[i];
      s_vals[i] = t;
      s += to_float<T>(t);
    }
  }
  const float mean = block_sum(s, red) / (float)V;  // its barriers order the stores above

  float q = 0.f;
  if (vec) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      float v[N];
      Pack<T>::get(s_words[w], v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = v[j] - mean;
        q += d * d;
      }
    }
  } else {
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const float d = to_float<T>(s_vals[i]) - mean;
      q += d * d;
    }
  }
  const float rstd = rstd_of(block_sum(q, red), V, eps);
  const Norm p{mean, rstd, gamma[plane % C], beta[plane % C]};
  if (threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }

  const T* rp = RES ? r + base : nullptr;
  T* yp = y + base;
  if (vec) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      float v[N], rv[N];
      Pack<T>::get(s_words[w], v);
      if (RES) Pack<T>::get(__ldg(reinterpret_cast<const uint4*>(rp) + w), rv);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = act<ACT>(z_of<RES>(xhat_of(v[j], p), RES ? rv[j] : 0.f, p));
      reinterpret_cast<uint4*>(yp)[w] = Pack<T>::put(v);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const float rv = RES ? to_float<T>(rp[i]) : 0.f;
      yp[i] = from_float<T>(act<ACT>(z_of<RES>(xhat_of(to_float<T>(s_vals[i]), p), rv, p)));
    }
  }
}

// The chunks' exact centred moments: part[plane * nchunks + chunk] =
// (mean_k, M2_k) of the chunk's n_k voxels.
template <typename T>
__global__ void __launch_bounds__(NT)
    instnorm_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, long long V,
                          int nchunks, int vec) {
  __shared__ float red[NT / 32];
  const long long plane = blockIdx.x / nchunks;
  const Chunk<T> ch(blockIdx.x % nchunks, V);
  float v[Chunk<T>::E];
  ch.load(x + plane * V, vec, v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < Chunk<T>::E; ++k) s += v[k];  // 0 past the end
  const float n = (float)(ch.end - ch.c0);
  const float mean = block_sum(s, red) / n;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < Chunk<T>::E; ++k) {
    if (ch.voxel(k, vec) < ch.end) {
      const float d = v[k] - mean;
      q += d * d;
    }
  }
  q = block_sum(q, red);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(mean, q);
}

// Each block merges its plane's partials, normalises its chunk; the blocks
// of chunk 0 write the plane's mean and rstd (all blocks of a plane compute
// the same bits).
template <typename T, bool ACT, bool RES>
__global__ void __launch_bounds__(NT)
    instnorm_fwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ r,
                              const float2* __restrict__ part, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ y,
                              float* __restrict__ mean_out, float* __restrict__ rstd_out, int C,
                              long long V, int nchunks, float eps, int vec) {
  constexpr int E = Chunk<T>::E;
  __shared__ float red[NT / 32];
  const int plane = blockIdx.x / nchunks, chunk = blockIdx.x % nchunks;
  const Chunk<T> ch(chunk, V);
  const long long base = (long long)plane * V;
  float v[E], rv[E];
  ch.load(x + base, vec, v);  // in flight while the partials are merged
  if (RES) ch.load(r + base, vec, rv);
  const float2 m = merge_moments(part + (long long)plane * nchunks, nchunks, V, Chunk<T>::ELEMS,
                                 red);
  const float rstd = rstd_of(m.y, V, eps);
  const Norm p{m.x, rstd, gamma[plane % C], beta[plane % C]};
  if (chunk == 0 && threadIdx.x == 0) {
    mean_out[plane] = m.x;
    rstd_out[plane] = rstd;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = act<ACT>(z_of<RES>(xhat_of(v[k], p), RES ? rv[k] : 0.f, p));
  ch.store(y + base, vec, v);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dz and xh of the thread's slots of a chunk, recomputed from x (and r)
template <typename T, bool ACT, bool RES>
__device__ __forceinline__ void dz_xh(const Chunk<T>& ch, const T* dy, const T* x, const T* r,
                                      const Norm& p, int vec, float (&dz)[Chunk<T>::E],
                                      float (&xh)[Chunk<T>::E]) {
  constexpr int E = Chunk<T>::E;
  float rv[E];
  ch.load(dy, vec, dz);
  ch.load(x, vec, xh);
  if (RES) ch.load(r, vec, rv);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    xh[k] = xhat_of(xh[k], p);
    dz[k] = act_grad<ACT>(dz[k], z_of<RES>(xh[k], RES ? rv[k] : 0.f, p));
  }
}

// part[plane * nchunks + chunk] = (sum dz, sum dz * xh) over the chunk.
template <typename T, bool ACT, bool RES>
__global__ void __launch_bounds__(NT)
    instnorm_bwd_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                             const T* __restrict__ r, const float* __restrict__ mean,
                             const float* __restrict__ rstd, const float* __restrict__ gamma,
                             const float* __restrict__ beta, float2* __restrict__ part, int C,
                             long long V, int nchunks, int vec) {
  constexpr int E = Chunk<T>::E;
  __shared__ float red[NT / 32];
  const int plane = blockIdx.x / nchunks;
  const Chunk<T> ch(blockIdx.x % nchunks, V);
  const long long base = (long long)plane * V;
  const Norm p{mean[plane], rstd[plane], gamma[plane % C], beta[plane % C]};
  float dz[E], xh[E];
  dz_xh<T, ACT, RES>(ch, dy + base, x + base, RES ? r + base : nullptr, p, vec, dz, xh);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {  // past the end dz is 0
    s1 += dz[k];
    s2 += dz[k] * xh[k];
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s1, s2);
}

// dx (and dr) of the chunk; the blocks of chunk 0 at b = 0 also write
// dgamma[c] and dbeta[c], every b's plane sums added in order of b.
template <typename T, bool ACT, bool RES>
__global__ void __launch_bounds__(NT)
    instnorm_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                           const T* __restrict__ r, const float* __restrict__ mean,
                           const float* __restrict__ rstd, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float2* __restrict__ part,
                           T* __restrict__ dx, T* __restrict__ dr, float* __restrict__ dgamma,
                           float* __restrict__ dbeta, int B, int C, long long V, int nchunks,
                           int vec) {
  constexpr int E = Chunk<T>::E;
  __shared__ float red[NT / 32];
  const int plane = blockIdx.x / nchunks, chunk = blockIdx.x % nchunks;
  const Chunk<T> ch(chunk, V);
  const long long base = (long long)plane * V;
  const Norm p{mean[plane], rstd[plane], gamma[plane % C], beta[plane % C]};
  float dz[E], xh[E];
  dz_xh<T, ACT, RES>(ch, dy + base, x + base, RES ? r + base : nullptr, p, vec, dz, xh);
  const float2 s = merge_sums(part + (long long)plane * nchunks, nchunks, red);
  const float m1 = s.x / (float)V, m2 = s.y / (float)V, k_ = p.gamma * p.rstd;
  if (RES) ch.store(dr + base, vec, dz);
#pragma unroll
  for (int k = 0; k < E; ++k) dz[k] = k_ * (dz[k] - m1 - xh[k] * m2);
  ch.store(dx + base, vec, dz);
  if (chunk == 0 && plane < C) {  // b = 0: this channel's dgamma and dbeta
    float g = 0.f, bt = 0.f;
    for (int b = 0; b < B; ++b) {
      const float2 sb = merge_sums(part + ((long long)b * C + plane) * nchunks, nchunks, red);
      bt += sb.x;
      g += sb.y;
    }
    if (threadIdx.x == 0) {
      dgamma[plane] = g;
      dbeta[plane] = bt;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void* x;
  const void* r;
  const float* gamma;
  const float* beta;
  void* y;
  float* mean;
  float* rstd;
  float2* part;
  int B, C;
  long long V;
  int nchunks, threads;
  float eps;
  int vec;
};

struct BwdArgs {
  const void* dy;
  const void* x;
  const void* r;
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  float2* part;
  void* dx;
  void* dr;
  float* dgamma;
  float* dbeta;
  int B, C;
  long long V;
  int nchunks, vec;
};

template <typename T, bool ACT, bool RES>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const long long planes = (long long)a.B * a.C;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  T* y = static_cast<T*>(a.y);
  if (a.nchunks == 0) {  // one pass, the plane in shared memory
    const int smem = (int)(a.V * (long long)sizeof(T));
    if (smem > PLANE_MAX_BYTES || a.threads < 32 || a.threads > PLANE_MAX_THREADS ||
        a.threads % 32 || planes > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    if (smem > STATIC_SMEM) {
      cudaError_t e = cudaFuncSetAttribute(instnorm_fwd_plane_kernel<T, ACT, RES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    instnorm_fwd_plane_kernel<T, ACT, RES><<<(unsigned)planes, a.threads, smem, st>>>(
        x, r, a.gamma, a.beta, y, a.mean, a.rstd, a.C, (int)a.V, a.eps, a.vec);
    return cudaGetLastError();
  }
  const long long blocks = planes * a.nchunks;
  if (a.nchunks != (a.V + Chunk<T>::ELEMS - 1) / Chunk<T>::ELEMS || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  instnorm_stats_kernel<T><<<(unsigned)blocks, NT, 0, st>>>(x, a.part, a.V, a.nchunks, a.vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  instnorm_fwd_apply_kernel<T, ACT, RES><<<(unsigned)blocks, NT, 0, st>>>(
      x, r, a.part, a.gamma, a.beta, y, a.mean, a.rstd, a.C, a.V, a.nchunks, a.eps, a.vec);
  return cudaGetLastError();
}

template <typename T, bool ACT, bool RES>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const long long blocks = (long long)a.B * a.C * a.nchunks;
  if (a.nchunks != (a.V + Chunk<T>::ELEMS - 1) / Chunk<T>::ELEMS || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  instnorm_bwd_sums_kernel<T, ACT, RES><<<(unsigned)blocks, NT, 0, st>>>(
      dy, x, r, a.mean, a.rstd, a.gamma, a.beta, a.part, a.C, a.V, a.nchunks, a.vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  instnorm_bwd_dx_kernel<T, ACT, RES><<<(unsigned)blocks, NT, 0, st>>>(
      dy, x, r, a.mean, a.rstd, a.gamma, a.beta, a.part, static_cast<T*>(a.dx),
      static_cast<T*>(a.dr), a.dgamma, a.dbeta, a.B, a.C, a.V, a.nchunks, a.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(int act_, int res, const FwdArgs& a, cudaStream_t st) {
  if (act_)
    return res ? launch_fwd<T, true, true>(a, st) : launch_fwd<T, true, false>(a, st);
  return res ? launch_fwd<T, false, true>(a, st) : launch_fwd<T, false, false>(a, st);
}

template <typename T>
cudaError_t dispatch_bwd(int act_, int res, const BwdArgs& a, cudaStream_t st) {
  if (act_)
    return res ? launch_bwd<T, true, true>(a, st) : launch_bwd<T, true, false>(a, st);
  return res ? launch_bwd<T, false, true>(a, st) : launch_bwd<T, false, false>(a, st);
}

}  // namespace
}  // namespace medseg

extern "C" {

// Both return a cudaError_t value: 0 when the kernels were launched. x, r,
// y, dy, dx and dr are (B, C, V) in the dtype (bf16 != 0: bfloat16), r and
// dr null without a residual;
// gamma, beta, dgamma and dbeta (C) and mean and rstd (B, C) fp32. vec != 0
// takes 16-byte words, which the caller may ask for only where V is a
// multiple of 8 (bf16) or 4 (fp32) and every tensor starts on 16 bytes.
//
// medseg_instnorm_fwd: nchunks 0 runs the one-pass kernel with `threads`
// threads a plane (32-512, a multiple of 32; V * sizeof(dtype) <= 64 KB);
// otherwise nchunks = ceil(V / chunk) with chunk = 256 * 4 * (8 or 4)
// voxels, and part holds B * C * nchunks float2 of scratch.
int medseg_instnorm_fwd(int device, int bf16, int act, int res, const void* x, const void* r,
                        const float* gamma, const float* beta, void* y, float* mean, float* rstd,
                        float* part, int B, int C, long long V, int nchunks, int threads,
                        float eps, int vec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || C < 1 || V < 1 || nchunks < 0 || (res && r == nullptr))
    return (int)cudaErrorInvalidValue;
  const medseg::FwdArgs a{x, r, gamma, beta, y, mean, rstd, reinterpret_cast<float2*>(part), B, C,
                          V, nchunks, threads, eps, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::dispatch_fwd<__nv_bfloat16>(act, res, a, st)
           : medseg::dispatch_fwd<float>(act, res, a, st);
  return (int)e;
}

// medseg_instnorm_bwd: nchunks = ceil(V / chunk) as above, part B * C *
// nchunks float2 of scratch; writes dx, dr (with a residual), dgamma and
// dbeta.
int medseg_instnorm_bwd(int device, int bf16, int act, int res, const void* dy, const void* x,
                        const void* r, const float* mean, const float* rstd, const float* gamma,
                        const float* beta, float* part, void* dx, void* dr, float* dgamma,
                        float* dbeta, int B, int C, long long V, int nchunks, int vec,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || C < 1 || V < 1 || nchunks < 1 || (res && (r == nullptr || dr == nullptr)))
    return (int)cudaErrorInvalidValue;
  const medseg::BwdArgs a{dy,   x,  r,      mean,  rstd, gamma, beta, reinterpret_cast<float2*>(part),
                          dx,   dr, dgamma, dbeta, B,    C,     V,    nchunks,
                          vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::dispatch_bwd<__nv_bfloat16>(act, res, a, st)
           : medseg::dispatch_bwd<float>(act, res, a, st);
  return (int)e;
}

}  // extern "C"
