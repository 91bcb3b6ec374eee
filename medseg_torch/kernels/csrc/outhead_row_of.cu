// Out head of a batch of sliding windows fused with their overlap-add into
// the volume accumulator. NCDHW windows, a (K, D, H, W) accumulator.
//
// Replaces the TPU kernel medseg/kernels/conv_of.py outhead_row_of
// (_outhead_row_kernel) (K4). That kernel W-folds the n_w windows of one
// rowblock into a bf16 row on a sequential grid, and XLA folds H and D
// afterwards. Here one launch adds the windows straight into the volume
// accumulator, so no per-window logits and no folded rows exist in memory:
//   comb_b[c]  = leaky(az[b,c]*z[b,c] + bz[b,c] + ar[b,c]*res[b,c] + br[b,c]),
//                rounded to the compute dtype (as K3)
//   acc[k, p] += sum over the windows b covering p of
//                (sum_c K[k,c]*comb_b[c] + bias[k]) * scale[b]      (fp32)
// with one rounding to the accumulator's dtype (fp32 or bf16) per class and
// voxel. The sum over windows is taken in fp32 registers, in window order.
//
// Ownership, not atomics: one thread owns one voxel of the bounding box of
// the batch's windows (the walk's rowblocks make that box dense), loops over
// the windows that cover it and does one read-modify-write of acc per class.
// Launches on a stream run in order, so no two threads ever write one voxel:
// the result is deterministic. Voxels no window covers are left untouched.
//
// What bounds it on the H100: device memory, as for K3. Per covered window
// and voxel it reads 2*C values and the fp32 scale (2*16 bf16 + 4 = 68 B)
// for 2*C*K = 512 FLOP, plus one read and one write of K accumulator values
// per box voxel: ~5 FLOP/byte, far below the card's ~300. So consecutive
// threads take consecutive voxels along W (every load of a channel plane and
// every accumulator access is coalesced), the K x C head, its bias and the
// batch's per-window affines sit in shared memory, the C combined values and
// the K sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int MAXB = 16;  // windows per launch (the wrapper splits larger batches)
constexpr int NTHREADS = 256;

struct RowArgs {
  const void* z;       // (B, C, rd, rh, rw) compute dtype
  const void* r;       // (B, C, rd, rh, rw)
  const float* az;     // (B, C) norm affines
  const float* bz;
  const float* ar;
  const float* br;
  const void* kout;    // (K, C) compute dtype
  const float* bias;   // (K,)
  const float* scale;  // (B, 1, rd, rh, rw) blend weight
  void* acc;           // (K, Dp, Hp, Wp) fp32 or bf16
  int B, C, K;
  int rd, rh, rw;
  int Dp, Hp, Wp;
  int box0[3];  // bounding box of the batch's windows: origin and extent
  int box[3];
  int starts[MAXB][3];
};

template <typename T, typename A, int MAXC, int MAXK>
__global__ void __launch_bounds__(NTHREADS) outhead_row_kernel(const RowArgs p) {
  extern __shared__ float sm[];
  const int C = p.C, K = p.K;
  float* s_k = sm;              // [K][C]
  float* s_bias = s_k + K * C;  // [K]
  float* s_aff = s_bias + K;    // [B][4][C]: az, bz, ar, br
  const T* kout = static_cast<const T*>(p.kout);
  for (int i = threadIdx.x; i < K * C; i += NTHREADS) s_k[i] = to_float<T>(kout[i]);
  for (int i = threadIdx.x; i < K; i += NTHREADS) s_bias[i] = p.bias[i];
  for (int i = threadIdx.x; i < p.B * C; i += NTHREADS) {
    const int b = i / C, c = i - b * C;
    s_aff[(4 * b + 0) * C + c] = p.az[i];
    s_aff[(4 * b + 1) * C + c] = p.bz[i];
    s_aff[(4 * b + 2) * C + c] = p.ar[i];
    s_aff[(4 * b + 3) * C + c] = p.br[i];
  }
  __syncthreads();

  const long long n_box = (long long)p.box[0] * p.box[1] * p.box[2];
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= n_box) return;
  const int ow = (int)(t % p.box[2]);
  const long long t2 = t / p.box[2];
  const int oh = (int)(t2 % p.box[1]);
  const int od = (int)(t2 / p.box[1]);
  const int gd = p.box0[0] + od, gh = p.box0[1] + oh, gw = p.box0[2] + ow;

  const T* z = static_cast<const T*>(p.z);
  const T* r = static_cast<const T*>(p.r);
  const long long V = (long long)p.rd * p.rh * p.rw;
  float sum[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) sum[k] = 0.f;
  bool covered = false;
  for (int b = 0; b < p.B; ++b) {
    const int ld = gd - p.starts[b][0], lh = gh - p.starts[b][1], lw = gw - p.starts[b][2];
    if (ld < 0 || ld >= p.rd || lh < 0 || lh >= p.rh || lw < 0 || lw >= p.rw) continue;
    covered = true;
    const long long v = ((long long)ld * p.rh + lh) * p.rw + lw;
    const float* aff = s_aff + 4 * b * C;
    float comb[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      comb[c] = 0.f;
      if (c < C) {
        const long long off = ((long long)b * C + c) * V + v;
        const float u = to_float<T>(z[off]) * aff[c] + aff[C + c] +
                        to_float<T>(r[off]) * aff[2 * C + c] + aff[3 * C + c];
        comb[c] = round_to<T>(leaky(u));
      }
    }
    const float sc = p.scale[(long long)b * V + v];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k < K) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) a = fmaf(s_k[k * C + c], comb[c], a);
        sum[k] += (a + s_bias[k]) * sc;
      }
    }
  }
  if (!covered) return;
  A* acc = static_cast<A*>(p.acc);
  const long long VA = (long long)p.Dp * p.Hp * p.Wp;
  const long long va = ((long long)gd * p.Hp + gh) * p.Wp + gw;
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K) acc[k * VA + va] = from_float<A>(to_float<A>(acc[k * VA + va]) + sum[k]);
}

template <typename T, typename A, int MAXC, int MAXK>
cudaError_t launch_row(const RowArgs& p, cudaStream_t st) {
  const long long n_box = (long long)p.box[0] * p.box[1] * p.box[2];
  const size_t smem = (size_t)(p.K * p.C + p.K + 4 * p.B * p.C) * sizeof(float);
  const unsigned blocks = (unsigned)((n_box + NTHREADS - 1) / NTHREADS);
  outhead_row_kernel<T, A, MAXC, MAXK><<<blocks, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t dispatch_row(const RowArgs& p, cudaStream_t st) {
  // register slots for the C combined values and the K sums of a thread;
  // few instantiations, as each fully unrolled one adds to the build time
  if (p.C <= 16) {
    if (p.K <= 16) return launch_row<T, A, 16, 16>(p, st);
    if (p.K <= 32) return launch_row<T, A, 16, 32>(p, st);
  } else if (p.C <= 32) {
    if (p.K <= 16) return launch_row<T, A, 32, 16>(p, st);
    if (p.K <= 32) return launch_row<T, A, 32, 32>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernel was launched. z, res and
// kout are in the compute dtype (bf16 != 0: bfloat16), acc in fp32
// (acc_bf16 == 0) or bfloat16. starts: B host triples (d, h, w), each window
// inside acc; box0/box: the windows' bounding box.
int medseg_outhead_row(int device, int bf16, int acc_bf16, const void* z, const void* r,
                       const float* az, const float* bz, const float* ar, const float* br,
                       const void* kout, const float* bias, const float* scale, void* acc, int B,
                       int C, int K, int rd, int rh, int rw, int Dp, int Hp, int Wp,
                       const int* starts, const int* box0, const int* box, void* stream) {
  if (B < 1 || B > medseg::MAXB) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  medseg::RowArgs p{};
  p.z = z;
  p.r = r;
  p.az = az;
  p.bz = bz;
  p.ar = ar;
  p.br = br;
  p.kout = kout;
  p.bias = bias;
  p.scale = scale;
  p.acc = acc;
  p.B = B;
  p.C = C;
  p.K = K;
  p.rd = rd;
  p.rh = rh;
  p.rw = rw;
  p.Dp = Dp;
  p.Hp = Hp;
  p.Wp = Wp;
  for (int i = 0; i < 3; ++i) {
    p.box0[i] = box0[i];
    p.box[i] = box[i];
  }
  for (int b = 0; b < B; ++b)
    for (int i = 0; i < 3; ++i) p.starts[b][i] = starts[3 * b + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (bf16)
    e = acc_bf16 ? medseg::dispatch_row<bf, bf>(p, st) : medseg::dispatch_row<bf, float>(p, st);
  else
    e = acc_bf16 ? medseg::dispatch_row<float, bf>(p, st)
                 : medseg::dispatch_row<float, float>(p, st);
  return (int)e;
}

}  // extern "C"
