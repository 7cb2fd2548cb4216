// Fused per-row power/peak reduction for the batched detector.
//
// Replaces the two Pallas TPU kernels of thrifty_tpu/dsp/pallas_kernels.py:
//   _kernel_interleaved (complex64 rows read as interleaved f32 re/im) and
//   _kernel             (separate f32 re/im planes),
// both launched through fused_power_peak.  One pass over each row of a
// [rows, n] complex array returns
//   idx   = argmax over the search mask of |x|^2 (masked-out columns count
//           as -1.0; the earliest column wins ties, NaN counts as largest,
//           like torch.argmax / jnp.argmax),
//   peak  = |x[idx]|^2,
//   total = sum |x|^2 over every column,
// and, when a stats mask is given, the stats-masked sums of |x|^2 and |x|.
//
// Exactness: |x|^2 is re*re + im*im rounded twice with no fused
// multiply-add (__fmul_rn / __fadd_rn), |x| is the IEEE square root
// (__fsqrt_rn), and peak is re-read at the winning column, so idx and peak
// are bit-equal to the plain PyTorch version
// (thrifty_tpu_torch/dsp/power_peak.py:fused_power_peak_reference) for any
// split of the row.  The (value, column) order with NaN largest is a total
// order, so the argmax merge is associative across threads, warps and
// slices.  The sums are taken in another order than torch.sum and agree to
// float32 reassociation only; the order is fixed by the launch plan, so two
// launches give bit-equal sums.  Do not build with --use_fast_math.
//
// What bounds it on an H100: it reads 8 bytes per complex sample once (plus
// one mask byte per column, which stays in L1/L2) and does a few flops per
// sample, so it is bound by HBM: [256, 16384] complex64 is 33.57 MB with
// masks and outputs, 10.0 us at 3.35 TB/s.  The first design (one CTA of
// 256 threads per row, one 8-byte load per thread per step) kept up with
// HBM from 256 rows up, but few rows left SMs idle: [128, 16384] gave
// fewer CTAs than SMs and one row ran on one SM.
//
// Design:
//   - A row is split over a thread-block cluster of S CTAs only while the
//     rows alone give fewer CTAs than half the SMs, and never into slices
//     under 2048 columns: S = clamp(min(ceil(SMs / 2 / rows),
//     ceil(n / 2048)), 1, 8) -- 8 for one row of 16384, 2 for 64 rows, 1
//     from 66 rows up on an H100.  The grid is rows * S blocks with cluster
//     dims (S, 1, 1), set with cudaLaunchKernelEx (no cluster attribute
//     when S = 1); CTA rank r reduces the contiguous slice
//     [r * L, min((r + 1) * L, n)) of its row, L = ceil(n / S) rounded up
//     to a multiple of 4 columns, so every slice starts 16-byte aligned.
//     Splitting a full card's rows as well (S = ceil(n / 2048) always, 256
//     threads a CTA) was measured slower: at [256, 16384] 2048 CTAs with
//     two cluster barriers each took 28.2 us cold against 22.1 us for 256
//     CTAs of 512 threads (chip_smoke.py --baseline).
//   - 16-byte loads, several in flight: each of 512 threads issues
//     kUnroll = 4 independent float4 loads through the read-only path
//     (__ldg) before it consumes any of them: two complex samples per load
//     in the interleaved layout, four re and four im values in the planes
//     layout.  The samples of a vector are consumed in column order.
//   - A split row is merged in the same launch, in distributed shared
//     memory: each CTA leaves its partial in its own shared memory and the
//     cluster synchronises; warp 0 of rank 0 reads the S partials through
//     cluster.map_shared_rank (one lane per rank), merges them in slice
//     order and writes the row's outputs; a second cluster barrier keeps
//     every CTA's shared memory alive until rank 0 has read it.  No second
//     pass (the detect program is bound by host launches) and no atomics
//     (their order would change the sums from run to run).
//   - Edges stay in the kernel: a row whose start is not 16-byte aligned
//     (odd n in the interleaved layout, n % 4 != 0 in planes, an offset
//     view) takes the scalar path of the same kernel (kVec = false, chosen
//     by the host from the addresses and strides); a slice whose length is
//     not a multiple of the vector width ends in a scalar tail.
// Any rows and 1 <= n <= INT_MAX / 2 are accepted.
//
// What still holds it back (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py):
// an empty kernel launched the same way takes 5.0 us between the same
// CUDA events, so at [256, 16384] launch and events are ~5 of the 22.1 us
// cold (L2 scrubbed by writes, whose dirty lines the call writes back) and
// of the 18.3 us with a clean L2.  A ring of shared-memory stages filled
// by 1-D TMA (cp.async.bulk on mbarriers, 4 stages of 1024 or 2048
// columns, one refilling thread) was slower: 24.3 us cold, 15.4 warm
// against 13.0 for these register loads.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kCtaCols = 2048;   // fewest columns per CTA of a split row
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSliceAlign = 4;   // slice starts at a multiple of 4 columns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float power_of(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// Does candidate (v, i) beat the current winner (bv, bi)?  Order of
// torch.argmax: NaN first, then the larger value, then the smaller column.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool v_nan = v != v;
  const bool b_nan = bv != bv;
  if (v_nan || b_nan) return v_nan && (!b_nan || i < bi);
  return v > bv || (v == bv && i < bi);
}

struct Partial {
  float best;
  int col;
  float total;
  float spow;
  float smag;
};

__device__ __forceinline__ Partial identity() {
  return Partial{-INFINITY, INT_MAX, 0.0f, 0.0f, 0.0f};
}

template <bool kStats>
__device__ __forceinline__ void merge(Partial& a, const Partial& b) {
  if (beats(b.best, b.col, a.best, a.col)) {
    a.best = b.best;
    a.col = b.col;
  }
  a.total = __fadd_rn(a.total, b.total);
  if (kStats) {
    a.spow = __fadd_rn(a.spow, b.spow);
    a.smag = __fadd_rn(a.smag, b.smag);
  }
}

template <bool kStats>
__device__ __forceinline__ void consume(Partial& p, float pw, int j,
                                        bool searched, bool stat) {
  p.total = __fadd_rn(p.total, pw);
  const float m = searched ? pw : -1.0f;
  if (beats(m, j, p.best, p.col)) {
    p.best = m;
    p.col = j;
  }
  if (kStats && stat) {
    p.spow = __fadd_rn(p.spow, pw);
    p.smag = __fadd_rn(p.smag, __fsqrt_rn(pw));
  }
}

__device__ __forceinline__ Partial shfl(const Partial& p, int src, int off) {
  Partial o;
  if (off) {
    o.best = __shfl_down_sync(kFull, p.best, off);
    o.col = __shfl_down_sync(kFull, p.col, off);
    o.total = __shfl_down_sync(kFull, p.total, off);
    o.spow = __shfl_down_sync(kFull, p.spow, off);
    o.smag = __shfl_down_sync(kFull, p.smag, off);
  } else {
    o.best = __shfl_sync(kFull, p.best, src);
    o.col = __shfl_sync(kFull, p.col, src);
    o.total = __shfl_sync(kFull, p.total, src);
    o.spow = __shfl_sync(kFull, p.spow, src);
    o.smag = __shfl_sync(kFull, p.smag, src);
  }
  return o;
}

template <bool kStats>
__device__ __forceinline__ Partial warp_reduce(Partial p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge<kStats>(p, shfl(p, 0, off));
  return p;
}

// |x|^2 of sample j of a row (any layout, any alignment of 8 bytes).
template <bool kInterleaved>
__device__ __forceinline__ float load_power(const float* re_row,
                                            const float* im_row, int j,
                                            long long elem_stride) {
  if (kInterleaved) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(re_row) + j);
    return power_of(v.x, v.y);
  }
  const long long off = static_cast<long long>(j) * elem_stride;
  return power_of(__ldg(re_row + off), __ldg(im_row + off));
}

// Scalar path over columns [lo, hi): kUnroll independent loads per thread
// before any is consumed.
template <bool kInterleaved, bool kStats>
__device__ __forceinline__ void reduce_scalar(
    Partial& p, const float* re_row, const float* im_row,
    const uint8_t* mask, const uint8_t* smask, int lo, int hi,
    long long elem_stride) {
  for (int base = lo + static_cast<int>(threadIdx.x); base < hi;
       base += kThreads * kUnroll) {
    float pw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      pw[u] = j < hi
                  ? load_power<kInterleaved>(re_row, im_row, j, elem_stride)
                  : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      if (j < hi) {
        consume<kStats>(p, pw[u], j, __ldg(mask + j) != 0,
                        kStats && __ldg(smask + j) != 0);
      }
    }
  }
}

// Vector path, interleaved: one float4 = samples j, j + 1 (j even).
template <bool kStats>
__device__ __forceinline__ int reduce_vec_interleaved(
    Partial& p, const float* row, const uint8_t* mask, const uint8_t* smask,
    int lo, int hi) {
  const int nv = (hi - lo) / 2;
  const float4* v4 = reinterpret_cast<const float4*>(row + 2LL * lo);
  for (int base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
    float4 v[kUnroll];
    uchar2 m[kUnroll];
    uchar2 s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      const int j = lo + 2 * k;
      v[u] = k < nv ? __ldg(v4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = k < nv ? __ldg(reinterpret_cast<const uchar2*>(mask + j))
                    : make_uchar2(0, 0);
      s[u] = kStats && k < nv
                 ? __ldg(reinterpret_cast<const uchar2*>(smask + j))
                 : make_uchar2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      if (k < nv) {
        const int j = lo + 2 * k;
        consume<kStats>(p, power_of(v[u].x, v[u].y), j, m[u].x, s[u].x);
        consume<kStats>(p, power_of(v[u].z, v[u].w), j + 1, m[u].y, s[u].y);
      }
    }
  }
  return lo + 2 * nv;
}

// Vector path, planes: one float4 of re and one of im = samples j..j+3.
template <bool kStats>
__device__ __forceinline__ int reduce_vec_planes(
    Partial& p, const float* re_row, const float* im_row,
    const uint8_t* mask, const uint8_t* smask, int lo, int hi) {
  const int nv = (hi - lo) / 4;
  const float4* r4 = reinterpret_cast<const float4*>(re_row + lo);
  const float4* i4 = reinterpret_cast<const float4*>(im_row + lo);
  for (int base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
    float4 r[kUnroll];
    float4 q[kUnroll];
    uchar4 m[kUnroll];
    uchar4 s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      const int j = lo + 4 * k;
      const bool in = k < nv;
      r[u] = in ? __ldg(r4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      q[u] = in ? __ldg(i4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = in ? __ldg(reinterpret_cast<const uchar4*>(mask + j))
                : make_uchar4(0, 0, 0, 0);
      s[u] = kStats && in
                 ? __ldg(reinterpret_cast<const uchar4*>(smask + j))
                 : make_uchar4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      if (k < nv) {
        const int j = lo + 4 * k;
        consume<kStats>(p, power_of(r[u].x, q[u].x), j, m[u].x, s[u].x);
        consume<kStats>(p, power_of(r[u].y, q[u].y), j + 1, m[u].y, s[u].y);
        consume<kStats>(p, power_of(r[u].z, q[u].z), j + 2, m[u].z, s[u].z);
        consume<kStats>(p, power_of(r[u].w, q[u].w), j + 3, m[u].w, s[u].w);
      }
    }
  }
  return lo + 4 * nv;
}

template <bool kInterleaved, bool kStats, bool kVec>
__global__ void __launch_bounds__(kThreads)
power_peak_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ smask,
                  int32_t* __restrict__ out_idx, float* __restrict__ out_peak,
                  float* __restrict__ out_total, float* __restrict__ out_spow,
                  float* __restrict__ out_smag, int n, int slice_len,
                  long long row_stride, long long elem_stride) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const long long row = blockIdx.x / ranks;
  const float* re_row = re + row * row_stride;
  const float* im_row = im + row * row_stride;
  const int lo = min(rank * slice_len, n);
  const int hi = min(lo + slice_len, n);

  Partial p = identity();
  int tail = lo;
  if (kVec) {
    tail = kInterleaved
               ? reduce_vec_interleaved<kStats>(p, re_row, mask, smask, lo, hi)
               : reduce_vec_planes<kStats>(p, re_row, im_row, mask, smask, lo,
                                           hi);
  }
  reduce_scalar<kInterleaved, kStats>(p, re_row, im_row, mask, smask, tail,
                                      hi, elem_stride);

  // The CTA's partial: warps, then warp 0 over the warps' partials.
  __shared__ Partial warp_parts[kWarps];
  __shared__ Partial cta_part;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  p = warp_reduce<kStats>(p);
  if (lane == 0) warp_parts[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_reduce<kStats>(lane < kWarps ? warp_parts[lane] : identity());
    if (lane == 0) cta_part = p;
  }
  if (ranks == 1) {  // the row in one CTA: no cluster merge
    if (threadIdx.x == 0) {
      out_idx[row] = p.col;
      out_peak[row] = load_power<kInterleaved>(re_row, im_row, p.col,
                                               elem_stride);
      out_total[row] = p.total;
      if (kStats) {
        out_spow[row] = p.spow;
        out_smag[row] = p.smag;
      }
    }
    return;
  }
  cluster.sync();  // every CTA's partial is in its shared memory

  if (rank == 0 && warp == 0) {
    // Lane r reads rank r's partial; every lane then merges them in slice
    // order (the same merges on every lane), so the sums' order is fixed.
    const Partial mine =
        lane < ranks ? *cluster.map_shared_rank(&cta_part, lane) : identity();
    Partial acc = shfl(mine, 0, 0);
    for (int r = 1; r < ranks; ++r) merge<kStats>(acc, shfl(mine, r, 0));
    if (lane == 0) {
      // n >= 1, so acc.col is a real column.  The peak is re-read at that
      // column, exactly as the plain version gathers power[idx].
      out_idx[row] = acc.col;
      out_peak[row] =
          load_power<kInterleaved>(re_row, im_row, acc.col, elem_stride);
      out_total[row] = acc.total;
      if (kStats) {
        out_spow[row] = acc.spow;
        out_smag[row] = acc.smag;
      }
    }
  }
  cluster.sync();  // keep every CTA's shared memory alive until rank 0 read
}

struct Plan {
  int cluster;    // S, CTAs per row
  int slice_len;  // L, columns per CTA
  int vec;        // 1: 16-byte loads (kVec)
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Streaming multiprocessors of the current device (cached per device).
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = sms > 0 ? sms : 1;
  }
  return counts[dev];
}

// The launch plan; cluster_plan and vector_path in
// thrifty_tpu_torch/dsp/power_peak.py are its mirror (the card tests
// compare the two).  A row is split only while the
// rows alone give fewer CTAs than half the SMs (a split costs two cluster
// barriers and a DSMEM merge per CTA, which outweigh the extra CTAs once
// the card is full), and never into slices under kCtaCols columns.
Plan make_plan(const void* re, const void* im, const void* mask,
               const void* smask, long long rows, long long n,
               long long row_stride, long long elem_stride, int interleaved,
               int sms) {
  Plan plan;
  const long long target = sms / 2 > 1 ? sms / 2 : 1;
  const long long by_rows = rows > 0 ? (target + rows - 1) / rows : 1;
  const long long by_cols = (n + kCtaCols - 1) / kCtaCols;
  long long s = by_rows < by_cols ? by_rows : by_cols;
  plan.cluster = static_cast<int>(s < 1 ? 1 : (s > kMaxCluster ? kMaxCluster
                                                                 : s));
  long long len = (n + plan.cluster - 1) / plan.cluster;
  len = (len + kSliceAlign - 1) / kSliceAlign * kSliceAlign;
  plan.slice_len = static_cast<int>(len);
  bool vec = aligned16(re) && aligned16(mask) &&
             (smask == nullptr || aligned16(smask)) &&
             (row_stride * 4) % 16 == 0;
  if (!interleaved) vec = vec && aligned16(im) && elem_stride == 1;
  plan.vec = vec ? 1 : 0;
  return plan;
}

template <bool kInterleaved, bool kStats, bool kVec>
cudaError_t launch(const Plan& plan, const float* re, const float* im,
                   const uint8_t* mask, const uint8_t* smask, int32_t* idx,
                   float* peak, float* total, float* spow, float* smag,
                   long long rows, int n, long long row_stride,
                   long long elem_stride, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows * plan.cluster), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  // A launch without clusters runs each CTA as a cluster of one.
  config.numAttrs = plan.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config,
                            power_peak_kernel<kInterleaved, kStats, kVec>, re,
                            im, mask, smask, idx, peak, total, spow, smag, n,
                            plan.slice_len, row_stride, elem_stride);
}

template <bool kInterleaved, bool kStats>
cudaError_t launch_vec(const Plan& plan, const float* re, const float* im,
                       const uint8_t* mask, const uint8_t* smask,
                       int32_t* idx, float* peak, float* total, float* spow,
                       float* smag, long long rows, int n,
                       long long row_stride, long long elem_stride,
                       cudaStream_t stream) {
  if (plan.vec) {
    return launch<kInterleaved, kStats, true>(
        plan, re, im, mask, smask, idx, peak, total, spow, smag, rows, n,
        row_stride, elem_stride, stream);
  }
  return launch<kInterleaved, kStats, false>(
      plan, re, im, mask, smask, idx, peak, total, spow, smag, rows, n,
      row_stride, elem_stride, stream);
}

}  // namespace

// The launch plan tt_power_peak would use on the current device, for the
// same arguments: out[0] = CTAs per row (cluster size), out[1] = columns
// per CTA, out[2] = 1 when the 16-byte load path runs, out[3] = the SMs
// the plan counted.
extern "C" void tt_power_peak_plan(const void* re, const void* im,
                                   const void* mask, const void* smask,
                                   long long rows, long long n,
                                   long long row_stride,
                                   long long elem_stride, int interleaved,
                                   int* out) {
  const int sms = sm_count();
  const Plan plan = make_plan(re, im, mask, smask, rows, n, row_stride,
                              elem_stride, interleaved, sms);
  out[0] = plan.cluster;
  out[1] = plan.slice_len;
  out[2] = plan.vec;
  out[3] = sms;
}

// Launches the reduction over `rows` rows of `n` complex samples on
// `stream` and returns the launch's error (0 = launched).  Sample j of row
// r is (re[r*row_stride + j*elem_stride], im[...same offset...]), strides
// in floats.  `interleaved` != 0 selects float2/float4 loads and needs
// im == re + 1, elem_stride == 2, an even row_stride and 8-byte alignment.
// `smask` == NULL skips the stats sums (spow/smag are then not written).
extern "C" int tt_power_peak(const void* re, const void* im, const void* mask,
                             const void* smask, void* out_idx, void* out_peak,
                             void* out_total, void* out_spow, void* out_smag,
                             long long rows, long long n, long long row_stride,
                             long long elem_stride, int interleaved,
                             void* stream) {
  // n <= INT_MAX / 2 keeps every column index and loop bound in an int.
  if (rows < 0 || n < 1 || n > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* r = static_cast<const float*>(re);
  const float* i = static_cast<const float*>(im);
  if (interleaved && (i != r + 1 || elem_stride != 2 || row_stride % 2 != 0 ||
                      reinterpret_cast<uintptr_t>(r) % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = make_plan(re, im, mask, smask, rows, n, row_stride,
                              elem_stride, interleaved, sm_count());
  if (rows * plan.cluster > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* sm = static_cast<const uint8_t*>(smask);
  int32_t* idx = static_cast<int32_t*>(out_idx);
  float* peak = static_cast<float*>(out_peak);
  float* total = static_cast<float*>(out_total);
  float* spow = static_cast<float*>(out_spow);
  float* smag = static_cast<float*>(out_smag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = static_cast<int>(n);
  cudaError_t err;
  if (interleaved) {
    err = sm ? launch_vec<true, true>(plan, r, i, m, sm, idx, peak, total,
                                      spow, smag, rows, cols, row_stride,
                                      elem_stride, s)
             : launch_vec<true, false>(plan, r, i, m, sm, idx, peak, total,
                                       spow, smag, rows, cols, row_stride,
                                       elem_stride, s);
  } else {
    err = sm ? launch_vec<false, true>(plan, r, i, m, sm, idx, peak, total,
                                       spow, smag, rows, cols, row_stride,
                                       elem_stride, s)
             : launch_vec<false, false>(plan, r, i, m, sm, idx, peak, total,
                                        spow, smag, rows, cols, row_stride,
                                        elem_stride, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
