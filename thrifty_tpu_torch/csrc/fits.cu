// The batched detector's iterative fits, each one launch per stage call.
//
// The JAX detector runs each fit as a loop inside its one compiled XLA
// program; eager PyTorch unrolls the same loop into a few dozen launches per
// step.  These kernels run the whole loop on the card in one launch:
//
//   dirichlet_fit_kernel  the damped Gauss-Newton fit of |A * D(x - delta)|
//                         to the carrier's width+1 magnitudes
//                         (thrifty_tpu/dsp/dirichlet.py:79-150, lax.scan at
//                         :141), one thread per row;
//   autocorr_fit_kernel   the Gauss-Newton fit of the template's
//                         autocorrelation shape tables to the 2w+1
//                         correlation magnitudes (thrifty_tpu/dsp/xcorr.py:
//                         286-395, lax.scan at :388), one thread per row;
//   maximise_kernel       the golden-section search of the band-limited
//                         correlation |sum_k X_k e^{2 pi i k (p + o) / N}|
//                         over o (thrifty_tpu/dsp/xcorr.py:191-283,
//                         fori_loop at :279), one CTA per row.
//
// Their plain PyTorch versions are the eager loops beside the wrappers
// (thrifty_tpu_torch/dsp/dirichlet.py:dirichlet_fit_reference,
// thrifty_tpu_torch/dsp/xcorr.py:autocorr_fit_reference and
// maximise_reference).  Each kernel repeats their arithmetic op for op in
// float32: the same constants, rounded once from float64 on the host, the
// IEEE sinf/cosf (never __sinf: do not build with --use_fast_math), the same
// guards and clamps.  The sums over a row are taken in another order than
// torch.sum and nvcc may fuse a multiply and an add, so the offsets agree
// to float32 rounding amplified by the iterations, not bit for bit: within
// 1e-5 on the detector's rows, more on noise rows where the 12 Gauss-Newton
// steps do not converge (the plain version on the CPU and on the card
// differ there as well).  The golden-section bracket is rounded with
// __fmul_rn/__fsub_rn/__fadd_rn, as the plain version's separate float32
// ops round it.
//
// What bounds them on an H100: the two per-row fits read 24-32 bytes a row
// and do 1-3 thousand flops, nanoseconds of bytes or operations for the
// whole batch; one thread per row runs its 10-12 steps in sequence, so they
// are bound by that chain's latency (0.0368 ms cold for the Dirichlet fit
// at [256, 7], 0.0157 for autocorr at [256, 5], against an empty launch's
// 0.005 and the eager loops' 10.0 and 4.8 ms; chip_smoke.py, H100 at
// 700 W).  maximise reads the [rows, N] complex64 spectrum once (33.5 MB
// at [256, 16384]: 10 us at 3.35 TB/s) and evaluates 36 phases per element
// (a sincosf and a complex multiply-add each: 151 M of them at
// [256, 16384]), so operations bound it (0.0253 ms without sin/cos; it
// takes 0.467 ms).  Design: the CTA rotates its row to the integer peak
// once into shared memory (opt-in dynamic shared memory: 128 KiB at
// N = 16384; a row that does not fit goes to a global scratch row given by
// the caller), then every evaluation re-reads it from there, each thread a
// strided share of the row, and a block reduction gives the value to every
// thread, which all step the same float32 bracket.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFitThreads = 128;     // threads per CTA of the per-row fits
constexpr int kMaxThreads = 512;     // threads per maximise CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// float32 clamp that keeps NaN, as torch.clamp and jnp.clip do.
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.sign / jnp.sign: -1, 0 (of either sign) or 1; NaN stays NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// The Dirichlet kernel's constants (dirichlet.py:dirichlet_kernel), each a
// Python scalar of the plain version rounded once to float32: a = pi/N,
// aw = pi*W/N, w = W, a2 = a*a, w2m1 = W*W - 1.
struct DirichletConsts {
  float a, aw, w, a2, w2m1;
};

// P = width + 1 magnitudes centred on the peak, row-major [rows, P]; the
// model |amp * D(x_p - delta)| on the grid x_p = p - P/2.  A row's few
// magnitudes are re-read from L1 at every step.
__global__ void __launch_bounds__(kFitThreads)
    dirichlet_fit_kernel(const float* __restrict__ y,
                         float* __restrict__ delta_out, long long rows,
                         int points, DirichletConsts k, int iters,
                         float damp) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const float* v = y + r * points;
  const int half = points / 2;
  float amp = __ldg(v + half);
  float delta = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float a11 = 0.0f, a22 = 0.0f, a12 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    for (int p = 0; p < points; ++p) {
      const float u = static_cast<float>(p - half) - delta;
      float d, dd;
      if (fabsf(u) < 1e-2f) {
        // Taylor about 0: D ~= 1 - a^2 u^2 (W^2-1)/6, D' ~= -a^2 u (W^2-1)/3
        d = 1.0f - k.a2 * u * u * k.w2m1 / 6.0f;
        dd = -k.a2 * u * k.w2m1 / 3.0f;
      } else {
        // sinf/cosf rather than two sincosf: with both sincosf slow paths
        // inline ptxas spills 8 bytes around them.
        const float sin_wx = sinf(k.aw * u), cos_wx = cosf(k.aw * u);
        const float sin_x = sinf(k.a * u), cos_x = cosf(k.a * u);
        d = sin_wx / (k.w * sin_x);
        dd = (k.aw * cos_wx * sin_x - k.a * sin_wx * cos_x) /
             (k.w * sin_x * sin_x);
      }
      // dm/dA = |D|, dm/ddelta = -A * sign(D) * D'(x - delta)
      const float j_a = fabsf(d);
      const float j_d = -amp * sign_of(d) * dd;
      const float resid = __ldg(v + p) - amp * j_a;
      a11 += j_a * j_a;
      a22 += j_d * j_d;
      a12 += j_a * j_d;
      b1 += j_a * resid;
      b2 += j_d * resid;
    }
    a11 = a11 * damp;
    a22 = a22 * damp + 1e-20f;
    float det = a11 * a22 - a12 * a12;
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    const float step_a = (a22 * b1 - a12 * b2) / det;
    const float step_d = (a11 * b2 - a12 * b1) / det;
    amp = amp + step_a;
    delta = clamp_keep_nan(delta + step_d, -1.0f, 1.0f);
  }
  delta_out[r] = delta;
}

// 2*half + 1 correlation magnitudes centred on the peak, [rows, 2*half+1];
// row r fits against row r % t_rows of the [t_rows, m] shape tables, with
// linear interpolation between the fine-grid entries around u
// (xcorr.py: lookup).
__global__ void __launch_bounds__(kFitThreads)
    autocorr_fit_kernel(const float* __restrict__ y,
                        const float* __restrict__ table,
                        const float* __restrict__ dtable,
                        float* __restrict__ out, long long rows, int half,
                        int t_rows, int m, float oversample, float pos_hi,
                        int iters, float clip) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (r >= rows) return;
  const long long t = r % t_rows;
  const float* tb = table + t * m;
  const float* dtb = dtable + t * m;
  const float* v = y + r * (2 * half + 1);
  float amp = __ldg(v + half);
  float delta = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float a11 = 0.0f, a22 = 0.0f, a12 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    for (int j = 0; j <= 2 * half; ++j) {
      const float u = static_cast<float>(j - half) - delta;
      // fmaxf/fminf send a NaN position to entry 0, so a NaN row reads no
      // memory outside the table (its offset is NaN all the same).
      const float pos = fminf(
          fmaxf((u + static_cast<float>(half + 2)) * oversample, 0.0f),
          pos_hi);
      const int i0 = static_cast<int>(floorf(pos));
      const float frac = pos - static_cast<float>(i0);
      const float w0 = 1.0f - frac;
      const float rv = __ldg(tb + i0) * w0 + __ldg(tb + i0 + 1) * frac;
      const float dr = __ldg(dtb + i0) * w0 + __ldg(dtb + i0 + 1) * frac;
      const float j_d = -amp * dr;
      const float resid = __ldg(v + j) - amp * rv;
      a11 += rv * rv;
      a22 += j_d * j_d;
      a12 += rv * j_d;
      b1 += rv * resid;
      b2 += j_d * resid;
    }
    a11 = a11 * 1.0001f;
    a22 = a22 * 1.0001f + 1e-12f;
    float det = a11 * a22 - a12 * a12;
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    const float step_d = (a11 * b2 - a12 * b1) / det;
    amp = amp + (a22 * b1 - a12 * b2) / det;
    delta = clamp_keep_nan(delta + step_d, -1.0f, 1.0f);
  }
  out[r] = clamp_keep_nan(delta, -clip, clip);
}

// The fftfreq frequency of bin k of n, float32 k' / n with k' in
// [-n/2, n/2) (xcorr.py: f_signed).
__device__ __forceinline__ float signed_freq(int k, int n) {
  const int ks = k < (n + 1) / 2 ? k : k - n;
  return static_cast<float>(ks) / static_cast<float>(n);
}

// Sum of (re, im) over the CTA, returned to every thread.  `scratch` holds
// kMaxWarps + 1 float2; the two barriers keep one call's reads apart from
// the next call's writes.
__device__ __forceinline__ float2 block_sum(float re, float im,
                                            float2* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(kFull, re, off);
    im += __shfl_down_sync(kFull, im, off);
  }
  if (lane == 0) scratch[warp] = make_float2(re, im);
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    float2 s = lane < warps ? scratch[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_down_sync(kFull, s.x, off);
      s.y += __shfl_down_sync(kFull, s.y, off);
    }
    if (lane == 0) scratch[kMaxWarps] = s;
  }
  __syncthreads();
  return scratch[kMaxWarps];
}

// |sum_k base_k e^{i two_pi o f_k}| over the CTA's row (xcorr.py: value).
__device__ __forceinline__ float correlation_at(const float2* base, int n,
                                                float o, float two_pi,
                                                float2* scratch) {
  float re = 0.0f, im = 0.0f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 b = base[k];
    float s, c;
    sincosf(two_pi * (o * signed_freq(k, n)), &s, &c);
    re += b.x * c - b.y * s;
    im += b.x * s + b.y * c;
  }
  const float2 total = block_sum(re, im, scratch);
  return hypotf(total.x, total.y);
}

// One CTA per row of spec [rows, n] complex64 (float2); peak index per row,
// int32 or int64.  `scratch` (rows * n float2) is read only when the row does
// not fit in shared memory (dynamic shared memory of 0 bytes).
__global__ void __launch_bounds__(kMaxThreads)
    maximise_kernel(const float2* __restrict__ spec, const void* peak_idx,
                    int idx64, float* __restrict__ out, float2* scratch,
                    int n, int use_smem, float clip, float invphi,
                    float two_pi, int iters) {
  extern __shared__ float2 row_smem[];
  __shared__ float2 red[kMaxWarps + 1];
  const long long r = blockIdx.x;
  const float2* x = spec + r * n;
  float2* base = use_smem ? row_smem : scratch + r * n;
  // Rotate to the integer peak with exact integer phase: (k * p) mod n.
  const long long raw = idx64 ? static_cast<const long long*>(peak_idx)[r]
                              : static_cast<const int*>(peak_idx)[r];
  const unsigned long long p =
      static_cast<unsigned long long>(((raw % n) + n) % n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned long long kp = (static_cast<unsigned long long>(k) * p) %
                                  static_cast<unsigned long long>(n);
    float s, c;
    sincosf(two_pi * (static_cast<float>(kp) / static_cast<float>(n)), &s,
            &c);
    const float2 v = x[k];
    base[k] = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
  __syncthreads();
  // Golden-section search over [-clip, clip], the bracket rounded to
  // float32 at every step; one evaluation per step reuses the surviving
  // interior value (xcorr.py: maximise_reference).
  float a = -clip, b = clip;
  float c = __fsub_rn(b, __fmul_rn(invphi, __fsub_rn(b, a)));
  float d = __fadd_rn(a, __fmul_rn(invphi, __fsub_rn(b, a)));
  float fc = correlation_at(base, n, c, two_pi, red);
  float fd = correlation_at(base, n, d, two_pi, red);
  for (int it = 0; it < iters; ++it) {
    const bool left = fc > fd;  // keep [a, d]; else keep [c, b]
    const float a2 = left ? a : c;
    const float b2 = left ? d : b;
    c = __fsub_rn(b2, __fmul_rn(invphi, __fsub_rn(b2, a2)));
    d = __fadd_rn(a2, __fmul_rn(invphi, __fsub_rn(b2, a2)));
    a = a2;
    b = b2;
    const float fnew = correlation_at(base, n, left ? c : d, two_pi, red);
    if (left) {
      fd = fc;
      fc = fnew;
    } else {
      fc = fd;
      fd = fnew;
    }
  }
  if (threadIdx.x == 0) out[r] = __fmul_rn(0.5f, __fadd_rn(a, b));
}

// Dynamic shared memory for a maximise row of n samples on the current
// device, or 0 when it does not fit (the kernel then uses the scratch).
size_t maximise_smem(long long n) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t need = static_cast<size_t>(n) * sizeof(float2);
  const size_t room = static_cast<size_t>(optin) -
                      (kMaxWarps + 1) * sizeof(float2);
  return need <= room ? need : 0;
}

int threads_for(long long n) {
  // Whole warps, at most kMaxThreads, at least one element each.
  const long long warps = (n + 31) / 32;
  return static_cast<int>(warps >= kMaxWarps ? kMaxThreads : warps * 32);
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kFitThreads - 1) / kFitThreads);
}

bool rows_ok(long long rows) {
  return rows >= 0 && (rows + kFitThreads - 1) / kFitThreads <= INT_MAX;
}

}  // namespace

// delta [rows] of the Dirichlet fit on y [rows, points] float32 (points
// odd), constants as DirichletConsts; damp = 1 + damping.  Returns the
// launch's error (0 = launched).
extern "C" int tt_dirichlet_fit(const void* y, void* delta, long long rows,
                                int points, float a, float aw, float w,
                                float a2, float w2m1, int iters, float damp,
                                void* stream) {
  if (!rows_ok(rows) || points < 1 || points % 2 == 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  dirichlet_fit_kernel<<<blocks_for(rows), kFitThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<float*>(delta), rows, points,
      DirichletConsts{a, aw, w, a2, w2m1}, iters, damp);
  return static_cast<int>(cudaGetLastError());
}

// offset [rows] of the autocorr fit on y [rows, 2*half+1] float32 against
// the [t_rows, m] tables, clamped to +-clip; pos_hi = m - 1.001 as float32.
extern "C" int tt_autocorr_fit(const void* y, const void* table,
                               const void* dtable, void* out, long long rows,
                               int half, int t_rows, int m, float oversample,
                               float pos_hi, int iters, float clip,
                               void* stream) {
  if (!rows_ok(rows) || half < 0 || t_rows < 1 || m < 2 || iters < 0 ||
      !(pos_hi >= 0.0f && pos_hi < static_cast<float>(m - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  autocorr_fit_kernel<<<blocks_for(rows), kFitThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(table),
      static_cast<const float*>(dtable), static_cast<float*>(out), rows, half,
      t_rows, m, oversample, pos_hi, iters, clip);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory tt_maximise uses for rows of n samples on
// the current device; 0 means it needs the scratch argument.
extern "C" long long tt_maximise_smem(long long n) {
  if (n < 1 || n > INT_MAX) return 0;
  return static_cast<long long>(maximise_smem(n));
}

// offset [rows] of the golden-section search on spec [rows, n] complex64
// around peak_idx [rows] (int64 when idx64, else int32).  scratch: rows * n
// complex64, or NULL when tt_maximise_smem(n) > 0.
extern "C" int tt_maximise(const void* spec, const void* peak_idx, int idx64,
                           void* out, void* scratch, long long rows,
                           long long n, float clip, float invphi,
                           float two_pi, int iters, void* stream) {
  if (rows < 0 || rows > INT_MAX || n < 1 || n > INT_MAX || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const size_t smem = maximise_smem(n);
  if (smem == 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maximise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maximise_kernel<<<static_cast<unsigned>(rows), threads_for(n), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), peak_idx, idx64,
      static_cast<float*>(out), static_cast<float2*>(scratch),
      static_cast<int>(n), smem > 0, clip, invphi, two_pi, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
