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
// multiply-add (__fmul_rn / __fadd_rn), and |x| is the IEEE square root
// (__fsqrt_rn), so idx and peak are bit-equal to the plain PyTorch version
// (thrifty_tpu_torch/dsp/power_peak.py:fused_power_peak_reference).  The
// sums are taken in another order than torch.sum and agree to fp32
// reassociation only.  Do not build with --use_fast_math.
//
// What bounds it on an H100: it reads 8 bytes per complex sample once, plus
// one mask byte per column that stays in L2, and does a few flops per
// sample, so it is memory-bound: about 32 MB of reads for one
// [256, 16384] call.
//
// Design: the TPU kernel walks a sequential grid over column chunks and
// merges chunk results in scratch; here one thread block owns one row.
// Its threads stride over the row's columns (one float2 load per sample in
// the interleaved layout) keeping a private (value, column) winner and
// private sums, then merge with warp shuffles and one shared-memory step.
// One block per row gives only 256 blocks at the detector's batch of 256
// for 132 SMs; more rows per block, or a split row with a second merge
// pass, is later work.  Any rows and n are accepted: the stride loop masks
// its own ragged edge, so there is no tiling precondition.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
__device__ __forceinline__ Partial warp_reduce(Partial p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Partial o;
    o.best = __shfl_down_sync(kFull, p.best, off);
    o.col = __shfl_down_sync(kFull, p.col, off);
    o.total = __shfl_down_sync(kFull, p.total, off);
    o.spow = __shfl_down_sync(kFull, p.spow, off);
    o.smag = __shfl_down_sync(kFull, p.smag, off);
    merge<kStats>(p, o);
  }
  return p;
}

template <bool kInterleaved>
__device__ __forceinline__ float load_power(const float* re_row,
                                            const float* im_row, int j,
                                            long long elem_stride) {
  if (kInterleaved) {
    const float2 v = reinterpret_cast<const float2*>(re_row)[j];
    return power_of(v.x, v.y);
  }
  const long long off = static_cast<long long>(j) * elem_stride;
  return power_of(re_row[off], im_row[off]);
}

template <bool kInterleaved, bool kStats>
__global__ void __launch_bounds__(kThreads)
power_peak_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ smask,
                  int32_t* __restrict__ out_idx, float* __restrict__ out_peak,
                  float* __restrict__ out_total, float* __restrict__ out_spow,
                  float* __restrict__ out_smag, int n, long long row_stride,
                  long long elem_stride) {
  const long long row = blockIdx.x;
  const float* re_row = re + row * row_stride;
  const float* im_row = im + row * row_stride;

  Partial p{-INFINITY, INT_MAX, 0.0f, 0.0f, 0.0f};
  // Columns rise within a thread, so the strict comparison in beats()
  // already keeps this thread's earliest maximum.
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float pw = load_power<kInterleaved>(re_row, im_row, j, elem_stride);
    p.total = __fadd_rn(p.total, pw);
    const float m = mask[j] ? pw : -1.0f;
    if (beats(m, j, p.best, p.col)) {
      p.best = m;
      p.col = j;
    }
    if (kStats && smask[j]) {
      p.spow = __fadd_rn(p.spow, pw);
      p.smag = __fadd_rn(p.smag, __fsqrt_rn(pw));
    }
  }

  p = warp_reduce<kStats>(p);
  __shared__ Partial parts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) parts[warp] = p;
  __syncthreads();
  if (warp != 0) return;
  p = lane < kWarps ? parts[lane]
                    : Partial{-INFINITY, INT_MAX, 0.0f, 0.0f, 0.0f};
  p = warp_reduce<kStats>(p);
  if (lane != 0) return;

  // n >= 1, so p.col is a real column.  The peak is re-read at that
  // column, exactly as the plain version gathers power[idx].
  out_idx[row] = p.col;
  out_peak[row] = load_power<kInterleaved>(re_row, im_row, p.col, elem_stride);
  out_total[row] = p.total;
  if (kStats) {
    out_spow[row] = p.spow;
    out_smag[row] = p.smag;
  }
}

template <bool kInterleaved, bool kStats>
void launch(const float* re, const float* im, const uint8_t* mask,
            const uint8_t* smask, int32_t* idx, float* peak, float* total,
            float* spow, float* smag, long long rows, int n,
            long long row_stride, long long elem_stride, cudaStream_t stream) {
  power_peak_kernel<kInterleaved, kStats>
      <<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
          re, im, mask, smask, idx, peak, total, spow, smag, n, row_stride,
          elem_stride);
}

}  // namespace

// Launches the reduction over `rows` rows of `n` complex samples on
// `stream` and returns cudaGetLastError() (0 = launched).  Sample j of row
// r is (re[r*row_stride + j*elem_stride], im[...same offset...]), strides
// in floats.  `interleaved` != 0 selects float2 loads and needs
// im == re + 1, elem_stride == 2, an even row_stride and 8-byte alignment.
// `smask` == NULL skips the stats sums (spow/smag are then not written).
extern "C" int tt_power_peak(const void* re, const void* im, const void* mask,
                             const void* smask, void* out_idx, void* out_peak,
                             void* out_total, void* out_spow, void* out_smag,
                             long long rows, long long n, long long row_stride,
                             long long elem_stride, int interleaved,
                             void* stream) {
  if (rows < 0 || rows > INT_MAX || n < 1 || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* r = static_cast<const float*>(re);
  const float* i = static_cast<const float*>(im);
  if (interleaved && (i != r + 1 || elem_stride != 2 || row_stride % 2 != 0 ||
                      reinterpret_cast<uintptr_t>(r) % 8 != 0)) {
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
  if (interleaved) {
    if (sm) {
      launch<true, true>(r, i, m, sm, idx, peak, total, spow, smag, rows,
                         cols, row_stride, elem_stride, s);
    } else {
      launch<true, false>(r, i, m, sm, idx, peak, total, spow, smag, rows,
                          cols, row_stride, elem_stride, s);
    }
  } else if (sm) {
    launch<false, true>(r, i, m, sm, idx, peak, total, spow, smag, rows, cols,
                        row_stride, elem_stride, s);
  } else {
    launch<false, false>(r, i, m, sm, idx, peak, total, spow, smag, rows, cols,
                         row_stride, elem_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
