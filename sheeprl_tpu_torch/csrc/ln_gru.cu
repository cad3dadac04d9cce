// Fused LayerNorm-GRU step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel sheeprl_tpu/ops/gru.py::_ln_gru_kernel (launched by
// _pallas_forward, gru.py:77). One step of the Dreamer-V3 recurrent cell:
//
//   g  = concat(x, h)[B,K] @ W[K,3H] + b               (f32 accumulate)
//   n  = LayerNorm over all 3H of g (eps), * scale + shift
//   r  = sigmoid(n[:H]);  c = tanh(r * n[H:2H]);  u = sigmoid(n[2H:] - 1)
//   h' = u * c + (1 - u) * h
//
// Bound on an H100. At the serving shapes (DV3 S: K=1024, 3H=1536, B=1..64) the
// work is one pass over W: 6.29 MB of f32 weights against 2*B*K*3H flops, i.e.
// B/2 flops per weight byte. Below B=40 that is under the card's f32 ridge
// point (67 TFLOP/s / 3.35 TB/s = 20 flops/byte), so the serving step (B =
// slots = 4) is bytes-bound by W: 6.29 MB / 3.35 TB/s = 1.9 us at the full
// power limit. From B=40 on, the f32 flops (no tensor cores) bound it.
//
// Design (a simple, correct first version; wgmma/TMA/clusters are later work):
//   1. ln_gru_gemm_partial: a split-K GEMM tiled over (64 columns) x (16 rows)
//      x (one K chunk per split). Every block reads its W tile once from device
//      memory, so W is read once in total per row tile, and the split over K
//      puts enough blocks in flight (~2 per SM) to pull W at the memory rate
//      even when B is 1. Each split writes its f32 partial sums to a small
//      scratch [splits, B, 3H] (L2-resident: 0.3 MB at S, B=4) -- no atomics,
//      so the result is the same on every run.
//   2. ln_gru_finish: one block per batch row sums the partials and the bias
//      into shared memory (3H floats: 6 KB at S, 48 KB at XL), takes the
//      LayerNorm statistics in two passes (mean, then mean of squared
//      deviations -- the reference's order), and applies the gates.
// The TPU kernel kept W whole in 16 MB of VMEM, which capped it at the XS and
// S sizes; here W streams from device memory and L2, so every DV3 size up to
// XL (K=5120, 3H=12288) runs. Only float32 is taken; the wrapper refuses
// other dtypes.

#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 64;    // output columns per block
constexpr int kTileB = 16;    // batch rows per block
constexpr int kTileK = 32;    // K depth staged per iteration
constexpr int kThreads = 256; // 64 columns x 4 row groups of 4 rows
constexpr int kRowsPerThread = kTileB / (kThreads / kTileN);
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kThreads)
ln_gru_gemm_partial(const float* __restrict__ inp, const float* __restrict__ w,
                    float* __restrict__ partial, int B, int K, int N, int k_per_split) {
  __shared__ float xs[kTileB][kTileK];
  __shared__ float ws[kTileK][kTileN];

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kTileN;
  const int row0 = blockIdx.y * kTileB;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int c = tid % kTileN;
  const int rg = tid / kTileN;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    // W tile [kTileK, kTileN]: consecutive threads read consecutive columns
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int kk = i / kTileN, cc = i % kTileN;
      const int gk = k0 + kk, gc = col0 + cc;
      ws[kk][cc] = (gk < k_end && gc < N) ? w[(size_t)gk * N + gc] : 0.f;
    }
    // input tile [kTileB, kTileK]
    for (int i = tid; i < kTileB * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[r][kk] = (gr < B && gk < k_end) ? inp[(size_t)gr * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float wv = ws[kk][c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // a warp shares rg, so this read is a broadcast
        acc[r] = fmaf(xs[rg * kRowsPerThread + r][kk], wv, acc[r]);
      }
    }
    __syncthreads();
  }

  const int gc = col0 + c;
  if (gc >= N) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gr = row0 + rg * kRowsPerThread + r;
    if (gr < B) partial[((size_t)blockIdx.z * B + gr) * N + gc] = acc[r];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. `red` holds 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();  // `red` is reused by the next call
  return t;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kFinishThreads)
ln_gru_finish(const float* __restrict__ partial, int splits, const float* __restrict__ hx,
              const float* __restrict__ b, const float* __restrict__ scale,
              const float* __restrict__ shift, float* __restrict__ out, int B, int H, float eps) {
  extern __shared__ float g[];  // [3H] gates of this row
  __shared__ float red[32];
  const int row = blockIdx.x;
  const int N = 3 * H;

  float s = 0.f;
  for (int col = threadIdx.x; col < N; col += blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < splits; ++k) v += partial[((size_t)k * B + row) * N + col];
    v += b[col];
    g[col] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)N;
  float ss = 0.f;
  for (int col = threadIdx.x; col < N; col += blockDim.x) {
    const float d = g[col] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / (float)N;
  const float rstd = rsqrtf(var + eps);

  const float* h = hx + (size_t)row * H;
  float* o = out + (size_t)row * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float nr = (g[j] - mean) * rstd * scale[j] + shift[j];
    const float nc = (g[H + j] - mean) * rstd * scale[H + j] + shift[H + j];
    const float nu = (g[2 * H + j] - mean) * rstd * scale[2 * H + j] + shift[2 * H + j];
    const float reset = sigmoidf(nr);
    const float cand = tanhf(reset * nc);
    const float update = sigmoidf(nu - 1.f);
    o[j] = update * cand + (1.f - update) * h[j];
  }
}

}  // namespace

// Launches both kernels on `stream`. All pointers are device pointers to
// contiguous float32 arrays: inp [B,K], hx [B,H], w [K,3H], b/scale/shift [3H],
// partial [splits,B,3H] scratch, out [B,H]. Returns a cudaError_t (0 = launched).
extern "C" int ln_gru_forward(const float* inp, const float* hx, const float* w,
                              const float* b, const float* scale, const float* shift,
                              float* partial, float* out, int B, int K, int H, int splits,
                              int k_per_split, float eps, void* stream) {
  const int N = 3 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB, splits);
  ln_gru_gemm_partial<<<grid, kThreads, 0, s>>>(inp, w, partial, B, K, N, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the gate row lives in dynamic shared memory; past the default 48 KB
  // (static + dynamic: XL's 3H = 12288 floats is exactly 48 KB) the kernel
  // must opt in, once per size it grows to
  static size_t opted_in = 0;
  const size_t smem = (size_t)N * sizeof(float);
  if (smem + 32 * sizeof(float) > 48 * 1024 && smem > opted_in) {
    err = cudaFuncSetAttribute(ln_gru_finish, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  ln_gru_finish<<<B, kFinishThreads, smem, s>>>(partial, splits, hx, b, scale, shift, out, B, H,
                                                eps);
  return static_cast<int>(cudaGetLastError());
}

// The tile constants the Python wrapper needs to size the split-K scratch.
extern "C" int ln_gru_tile_k() { return kTileK; }
extern "C" int ln_gru_tile_n() { return kTileN; }
extern "C" int ln_gru_tile_b() { return kTileB; }
