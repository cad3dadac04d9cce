// Fused LayerNorm-GRU step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel sheeprl_tpu/ops/gru.py::_ln_gru_kernel (launched by
// _pallas_forward, gru.py:77). One step of the Dreamer-V3 recurrent cell:
//
//   g  = concat(x, h)[B,K] @ W[K,3H] + b               (f32 products, f32 sums)
//   n  = LayerNorm over all 3H of g (eps), * scale + shift
//   r  = sigmoid(n[:H]);  c = tanh(r * n[H:2H]);  u = sigmoid(n[2H:] - 1)
//   h' = u * c + (1 - u) * h
//
// Bound on an H100. At the serving shapes (DV3 S: K=1024, 3H=1536, B=1..64) the
// work is one pass over W: 6.29 MB of f32 weights against 2*B*K*3H flops, i.e.
// B/2 flops per weight byte. Below B=40 that is under the card's f32 ridge
// point (67 TFLOP/s / 3.35 TB/s = 20 flops/byte), so the serving step (B =
// slots = 4) is bound by reading W: 6.29 MB / 3.35 TB/s = 1.9 us at the full
// power limit. From B=40 on, the f32 FMAs (no tensor cores, so no TF32
// rounding) bound it.
//
// Design. Two launches, the second chained to the first by programmatic
// dependent launch, both capturable in a CUDA graph:
//
//   1. ln_gru_gemm: the product, reduced on chip. A thread-block cluster owns
//      one column group: columns j0..j0+32 of each third of W (j0, H+j0,
//      2H+j0), i.e. 96 columns, for a tile of 4 or 16 batch rows. Its C
//      blocks (C = 1, 2, 4 or 8, along K) each stream one contiguous chunk of
//      K rows. W moves in 16-byte cp.async.cg copies (L2 only) into a ring of
//      5 shared-memory stages of 32 K rows (12 KB of W each), so a block keeps
//      up to 48 KB of W in flight and each W element, once in shared memory,
//      feeds every batch row of the tile from registers; the x tile rides in
//      the same stages. The 8 threads that share a column quad take 4 K rows
//      of a stage each (with the 16-byte copies, the very W quads each thread
//      copied) and are summed through shared memory in a fixed order.
//      Then the cluster sums its C partial tiles through distributed shared
//      memory: rank r pulls the C partials of tile rows r, r + C, ... and
//      sums them, rank 0 to C-1 in order. No float atomics and no split-K
//      scratch in device memory, so every run gives the same bits. Each warp
//      that finishes a row adds the bias, writes the row's 96 gate values
//      and publishes the row's LayerNorm partials over them (count, mean, sum
//      of squared deviations about that mean) to a small [B, groups, 2]
//      buffer.
//   2. ln_gru_finish: one block per (row, 128 hidden units), B * H/128 blocks.
//      It reads hx, scale and shift before it waits on the first launch
//      (griddepcontrol.wait), then merges the row's group partials (Chan's
//      parallel merge: mean = sum n_g m_g / 3H, then M2 = sum M2_g + n_g
//      (m_g - mean)^2, the two-pass order of the reference taken over the
//      groups; the same result as one two-pass sweep up to float32 rounding,
//      ~1e-7 relative) and applies the gates to its columns j, H+j, 2H+j.
//
// The launch plan (row tile, cluster size, K chunk) is chosen by the Python
// wrapper (ops/gru.py::_launch_plan) and checked here: the cluster along K
// grows while the grid keeps to one block an SM, so each SM streams one long
// contiguous run of K (at DV3 S, B = 4: 16 clusters of 8 blocks, 128 K rows
// each). Where an operand does not allow 16-byte copies (W or inp not
// 16-byte aligned, or 3H or K not a multiple of 4), the same kernel takes
// 4-byte copies of both (the kVec=false instance). Any B >= 1, K >= 1 and
// H >= 1 run; ragged edges are zero-filled by the copies and masked on the
// way out. Only float32 is taken; the wrapper refuses other dtypes.
//
// Measured on an H100 (PERF.md): within 1.2-1.4x of the bound at the
// L and XL cells, where streaming W is the whole cost (~2.5-2.9 TB/s). At S
// (6.29 MB of W) a call costs ~4x its 1.9 us bound: a graph node's launch
// (~1 us), the cluster barriers, reduction and stores after the stream
// (~2 us), and the finish launch (~1 us) do not shrink with W.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kColGroup = 32;               // columns of each third a cluster owns
constexpr int kCols = 3 * kColGroup;        // columns of a block's tile
constexpr int kQuads = kCols / 4;           // float4 column quads of a tile
constexpr int kKLanes = 8;                  // threads sharing a quad, splitting K
constexpr int kThreads = kQuads * kKLanes;  // 192
constexpr int kStageK = 32;                 // K rows per pipeline stage
constexpr int kStages = 5;                  // 4 in flight: a 128-row chunk at once
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kFinishThreads = 128;

// Shared memory of a block with a tile of TB batch rows.
template <int TB>
struct Tile {
  static constexpr int kW = kStageK * kCols;  // floats of W per stage, [k][col]
  static constexpr int kX = kStageK * TB;     // floats of x per stage, [row][k]
  static constexpr int kStage = kW + kX;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kRed = kKLanes * TB * kCols;  // the K lanes' sums, reusing the ring
  static constexpr int kPart = TB * kCols;           // the block's partial tile
  static constexpr int kPartOffset = kRing > kRed ? kRing : kRed;
  static constexpr size_t kBytes = sizeof(float) * (kPartOffset + kPart);
  static_assert(kStage % 4 == 0 && kW % 4 == 0, "stages must keep 16-byte alignment");
  static_assert(kStageK == 4 * kKLanes, "each K lane takes 4 rows of a stage");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device memory to shared memory, asynchronously; when
// `ok` is false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Grid: x = groups * C (a cluster of C blocks per column group, along K),
// y = row tiles of TB rows. gates [B, 3H] gets g (bias added); stats [B,
// groups, 2] gets each row's (mean, M2) over the group's columns.
template <int TB, bool kVec>
__global__ void __launch_bounds__(kThreads)
ln_gru_gemm(const float* __restrict__ inp, const float* __restrict__ w, const float* __restrict__ b,
            float* __restrict__ gates, float* __restrict__ stats, int B, int K, int H, int k_chunk) {
  using S = Tile<TB>;
  // the finish launch may be scheduled from now on; it waits for this grid's
  // writes at its griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / C;
  const int groups = gridDim.x / C;
  const int j0 = group * kColGroup;
  const int row0 = blockIdx.y * TB;
  const int N = 3 * H;
  const int k_begin = rank * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + kStageK - 1) / kStageK : 0;
  const int tid = threadIdx.x;
  const int q = tid % kQuads;
  const int lane_k = tid / kQuads;
  const int lane = tid & 31;
  const int n_valid = min(kColGroup, H - j0);
  const bool col_ok = lane < n_valid;
  // the bias of the columns this lane finishes, fetched long before it is used
  float bias[3] = {0.f, 0.f, 0.f};
  if (col_ok) {
#pragma unroll
    for (int seg = 0; seg < 3; ++seg) bias[seg] = b[seg * H + j0 + lane];
  }

  // Each thread's copies keep their place in the tile from stage to stage,
  // so their offsets are worked out once. 16-byte path: the thread copies
  // quad q of its own 4 K rows (lane_k * 4 + m), the very quads it
  // multiplies, and x moves as [TB][32] quads. 4-byte path: column tid % 96 of
  // rows tid / 96 + 2m, and x element by element.
  constexpr int kKPerLane = kStageK / kKLanes;
  constexpr int kWCopies = kVec ? kKPerLane : kStageK * kCols / kThreads;
  constexpr int kWRowStep = kVec ? 1 : kThreads / kCols;
  constexpr int kXWidth = kVec ? 4 : 1;                 // floats a copy
  constexpr int kXPerStage = TB * kStageK / kXWidth;    // copies of a stage
  constexpr int kXCopies = (kXPerStage + kThreads - 1) / kThreads;
  static_assert(kStageK * kCols % kThreads == 0 && kThreads % kCols == 0, "copies must tile a stage");
  const int w_col = kVec ? q * 4 : tid % kCols;  // column within the tile
  const int w_row = kVec ? lane_k * kKPerLane : tid / kCols;
  const int w_seg = w_col / kColGroup, w_jj = w_col % kColGroup;
  const bool w_col_ok = j0 + w_jj < H;  // with H % 4 == 0, a quad is whole or out
  const float* w_src = w + (size_t)k_begin * N + w_seg * H + j0 + w_jj;
  const int w_dst = w_row * kCols + w_col;
  size_t x_src[kXCopies];
  int x_dst[kXCopies];
  bool x_ok[kXCopies];
#pragma unroll
  for (int m = 0; m < kXCopies; ++m) {
    const int i = tid + m * kThreads;
    const int r = i / (kStageK / kXWidth), kk = (i % (kStageK / kXWidth)) * kXWidth;
    x_ok[m] = i < kXPerStage && row0 + r < B;
    x_src[m] = (size_t)(row0 + r) * K + k_begin + kk;
    x_dst[m] = r * kStageK + kk;
  }

  auto load_stage = [&](int stage, int slot) {
    float* ws = smem + slot * S::kStage;
    float* xs = ws + S::kW;
    const int k0 = stage * kStageK;  // from k_begin
#pragma unroll
    for (int m = 0; m < kWCopies; ++m) {
      const int kk = w_row + m * kWRowStep;
      const bool ok = w_col_ok && k_begin + k0 + kk < k_end;
      const float* src = ok ? w_src + (size_t)(k0 + kk) * N : w;
      if (kVec) {
        cp_async16(ws + w_dst + m * kWRowStep * kCols, src, ok);
      } else {
        cp_async4(ws + w_dst + m * kWRowStep * kCols, src, ok);
      }
    }
#pragma unroll
    for (int m = 0; m < kXCopies; ++m) {
      if (tid + m * kThreads < kXPerStage) {
        // K % 4 == 0 on the 16-byte path: a quad of k is whole or out
        const bool ok = x_ok[m] && k_begin + k0 + (x_dst[m] % kStageK) < k_end;
        const float* src = ok ? inp + x_src[m] + k0 : inp;
        if (kVec) {
          cp_async16(xs + x_dst[m], src, ok);
        } else {
          cp_async4(xs + x_dst[m], src, ok);
        }
      }
    }
  };

  float acc[TB][4];
#pragma unroll
  for (int r = 0; r < TB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();  // empty groups keep the count that wait_group relies on
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed, for this thread
    __syncthreads();               // ... for every thread; slot (s-1) % kStages is free
    const int next = s + kStages - 1;
    if (next < n_stages) load_stage(next, next % kStages);
    cp_async_commit();
    // this thread's 4 K rows: W quads from shared memory once, then x for
    // 4 batch rows at a time, 4 k each
    const float* ws = smem + (s % kStages) * S::kStage + lane_k * kKPerLane * kCols + q * 4;
    const float* xs = smem + (s % kStages) * S::kStage + S::kW + lane_k * kKPerLane;
    float4 wv[kKPerLane];
#pragma unroll
    for (int i = 0; i < kKPerLane; ++i) wv[i] = *reinterpret_cast<const float4*>(ws + i * kCols);
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + r * kStageK);
      const float xk[kKPerLane] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < kKPerLane; ++i) {
        acc[r][0] = fmaf(xk[i], wv[i].x, acc[r][0]);
        acc[r][1] = fmaf(xk[i], wv[i].y, acc[r][1]);
        acc[r][2] = fmaf(xk[i], wv[i].z, acc[r][2]);
        acc[r][3] = fmaf(xk[i], wv[i].w, acc[r][3]);
      }
    }
  }

  // sum the K lanes in a fixed order into the block's partial tile
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem;  // [kKLanes][TB][kCols], over the ring
  float* part = smem + S::kPartOffset;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    *reinterpret_cast<float4*>(red + (lane_k * TB + r) * kCols + q * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int e = tid; e < TB * kCols; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < kKLanes; ++l) v += red[l * TB * kCols + e];
    part[e] = v;
  }
  // every block's partial tile is visible to the cluster (a cluster of one
  // block needs only its own barrier)
  if (C > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  // rank r finishes tile rows r, r + C, ...: one warp a row, a lane a column
  // of each third. The C partials are summed in rank order.
  const int warp = tid >> 5;
  // (TB <= 16 rows over 6 warps: at most 3 rows a warp)
  constexpr int kRowsPerWarp = (TB + kThreads / 32 - 1) / (kThreads / 32);
  float v[kRowsPerWarp][3][kMaxCluster];
  // issue every remote load before the first add: each is a round trip
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = rank + C * (warp + i * (kThreads / 32));
    if (r < TB && row0 + r < B) {
#pragma unroll
      for (int src = 0; src < kMaxCluster; ++src) {
        if (src < C) {
          const float* p = cluster.map_shared_rank(part, src) + r * kCols + lane;
#pragma unroll
          for (int seg = 0; seg < 3; ++seg) v[i][seg][src] = p[seg * kColGroup];
        }
      }
    }
  }
  // this block is done reading the others' shared memory (release: the
  // remote loads are performed before the arrival is seen); it waits for
  // them to be done with its own only before it exits
  if (C > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = rank + C * (warp + i * (kThreads / 32));
    const int row = row0 + r;
    if (r >= TB || row >= B) break;
    float g[3];
    float sum = 0.f;
#pragma unroll
    for (int seg = 0; seg < 3; ++seg) {
      float t = 0.f;
#pragma unroll
      for (int src = 0; src < kMaxCluster; ++src) {
        if (src < C) t += v[i][seg][src];
      }
      g[seg] = 0.f;
      if (col_ok) {
        const int col = seg * H + j0 + lane;
        g[seg] = t + bias[seg];
        gates[(size_t)row * N + col] = g[seg];
        sum += g[seg];
      }
    }
    const float mean = warp_sum(sum) / (3.f * n_valid);
    float m2 = 0.f;
    if (col_ok) {
#pragma unroll
      for (int seg = 0; seg < 3; ++seg) m2 += (g[seg] - mean) * (g[seg] - mean);
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      stats[((size_t)row * groups + group) * 2] = mean;
      stats[((size_t)row * groups + group) * 2 + 1] = m2;
    }
  }
  if (C > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid: x = B rows, y = ceil(H / kFinishThreads). Launched as a programmatic
// dependent of ln_gru_gemm.
__global__ void __launch_bounds__(kFinishThreads)
ln_gru_finish(const float* __restrict__ gates, const float* __restrict__ stats,
              const float* __restrict__ hx, const float* __restrict__ scale,
              const float* __restrict__ shift, float* __restrict__ out, int H, int groups,
              float eps) {
  const int row = blockIdx.x;
  const int j = blockIdx.y * kFinishThreads + threadIdx.x;
  const int N = 3 * H;

  // inputs the first launch does not write are read before waiting for it
  float sc[3] = {0.f, 0.f, 0.f}, sh[3] = {0.f, 0.f, 0.f}, h = 0.f;
  if (j < H) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      sc[s] = scale[s * H + j];
      sh[s] = shift[s * H + j];
    }
    h = hx[(size_t)row * H + j];
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const float* g = gates + (size_t)row * N;
  float gr = 0.f, gc = 0.f, gu = 0.f;
  if (j < H) {  // issued before the statistics' reductions
    gr = g[j];
    gc = g[H + j];
    gu = g[2 * H + j];
  }
  // every warp merges the row's partials itself, in the same order: no
  // block barrier stands between the wait and the gates
  const float* st = stats + (size_t)row * groups * 2;
  const int lane = threadIdx.x & 31;
  float s1 = 0.f;
  for (int gi = lane; gi < groups; gi += 32) {
    s1 += 3.f * min(kColGroup, H - gi * kColGroup) * st[2 * gi];
  }
  const float mean = warp_sum(s1) / (float)N;
  float s2 = 0.f;
  for (int gi = lane; gi < groups; gi += 32) {
    const float d = st[2 * gi] - mean;
    s2 += st[2 * gi + 1] + 3.f * min(kColGroup, H - gi * kColGroup) * d * d;
  }
  const float var = warp_sum(s2) / (float)N;
  const float rstd = rsqrtf(var + eps);
  if (j >= H) return;

  const float nr = (gr - mean) * rstd * sc[0] + sh[0];
  const float nc = (gc - mean) * rstd * sc[1] + sh[1];
  const float nu = (gu - mean) * rstd * sc[2] + sh[2];
  const float reset = sigmoidf(nr);
  const float cand = tanhf(reset * nc);
  const float update = sigmoidf(nu - 1.f);
  out[(size_t)row * H + j] = update * cand + (1.f - update) * h;
}

template <int TB, bool kVec>
cudaError_t launch_gemm(const float* inp, const float* w, const float* b, float* gates,
                        float* stats, int B, int K, int H, int cluster, int k_chunk,
                        cudaStream_t stream) {
  auto kernel = ln_gru_gemm<TB, kVec>;
  constexpr size_t smem = Tile<TB>::kBytes;
  static bool opted_in = false;  // past 48 KB of dynamic shared memory a kernel opts in once
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int groups = (H + kColGroup - 1) / kColGroup;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cluster, (B + TB - 1) / TB, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, inp, w, b, gates, stats, B, K, H, k_chunk);
}

}  // namespace

// Launches both kernels on `stream`. All pointers are device pointers to
// contiguous float32 arrays: inp [B,K], hx [B,H], w [K,3H], b/scale/shift [3H],
// scratch [B*3H + B*groups*2] (gates, then LayerNorm partials; groups =
// ceil(H/32)), out [B,H]. The plan (tile_b rows a block, a cluster of
// `cluster` blocks along K, k_chunk K rows a block) comes from
// ops/gru.py::_launch_plan. Returns a cudaError_t (0 = launched).
extern "C" int ln_gru_forward(const float* inp, const float* hx, const float* w,
                              const float* b, const float* scale, const float* shift,
                              float* scratch, float* out, int B, int K, int H, int tile_b,
                              int cluster, int k_chunk, float eps, void* stream) {
  const bool plan_ok = B >= 1 && K >= 1 && H >= 1 && (tile_b == 4 || tile_b == 16) &&
                       (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
                       k_chunk > 0 && k_chunk % kStageK == 0 && (long long)cluster * k_chunk >= K;
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (H + kColGroup - 1) / kColGroup;
  float* gates = scratch;
  float* stats = scratch + (size_t)B * 3 * H;
  // 16-byte copies need 16-byte aligned rows of W and of inp
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && H % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(inp) % 16 == 0 && K % 4 == 0;

  cudaError_t err;
  if (tile_b == 4) {
    err = vec ? launch_gemm<4, true>(inp, w, b, gates, stats, B, K, H, cluster, k_chunk, s)
                : launch_gemm<4, false>(inp, w, b, gates, stats, B, K, H, cluster, k_chunk, s);
  } else {
    err = vec ? launch_gemm<16, true>(inp, w, b, gates, stats, B, K, H, cluster, k_chunk, s)
                : launch_gemm<16, false>(inp, w, b, gates, stats, B, K, H, cluster, k_chunk, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (H + kFinishThreads - 1) / kFinishThreads, 1);
  cfg.blockDim = dim3(kFinishThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_gru_finish, static_cast<const float*>(gates),
                           static_cast<const float*>(stats), hx, scale, shift, out, H, groups, eps);
  return static_cast<int>(err);
}

// The plan constants the Python wrapper needs: columns of each third a
// cluster owns, K rows of a pipeline stage, and the largest cluster.
extern "C" int ln_gru_col_group() { return kColGroup; }
extern "C" int ln_gru_stage_k() { return kStageK; }
extern "C" int ln_gru_max_cluster() { return kMaxCluster; }
