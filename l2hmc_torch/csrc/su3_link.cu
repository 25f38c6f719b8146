// The SU(3) engine's two per-link maps, written by hand for Hopper
// (sm_90a): one launch each for what the component engine's plain bodies
// (ops/su3_comp.py `expm` and `reunit`) compute in about 240 and 330
// small PyTorch kernels.
//
// Replaces: no TPU kernel. The JAX package leaves both functions
// (ops/su3_comp.py `expm` and `reunit` there) to XLA, which fuses their
// elementwise component algebra; PyTorch runs each of those operations as
// a kernel of its own. The kernels serve the calls that no gradient is
// asked of (ops/su3_comp.py chooses): the draws' transitions, the Wilson
// flow of every draw, HMC.
//
// What they compute, for a field (re, im) of 3x3 complex matrices, each
// (3, 3, L), component [a, b] of matrix l at re[a sa + b sb + l sl] with
// any strides (contiguous planes, views of one complex lattice, permuted
// views), into contiguous outputs, component [a, b] at [(3 a + b) L + l]:
//
//   su3_expm_fwd(m, order, s): exp(m) as the plain body takes it, on
//     y = exp(m) - 1 with the 1 added once at the end:
//       m <- m / 2^s;  y <- m / order;
//       y <- (m + m y) / i            for i = order - 1, ..., 1
//       y <- 2 y + y y                s times
//       out = I + y
//     Any m: nothing assumes it traceless or anti-hermitian (the learned
//     v update leaves the algebra once training turns its scale on).
//
//   su3_reunit_fwd(x): x (x^ x)^(-1/2), its determinant's phase removed:
//       t = x^ x;  y = I;  three times y <- y (1.5 I - 0.5 t y^2)
//       w = x y;   p = atan2(Im det w, Re det w) / (-3)
//       out = w (cos p + i sin p)
//     The first Newton-Schulz step is taken as y = 1.5 I - 0.5 t, which
//     is what the plain body's products with y = I give, exactly, for
//     finite input. The same polynomial map whatever the input (rough
//     links too); full-precision atan2 and sincos.
//
// Division by the integers of the Taylor recurrence and by -3 is a
// product with the reciprocal, rounded to the working type: what PyTorch
// computes on the card for a tensor over a Python number, as the plain
// body divides.
//
// Bound on the card: a matrix is read once and written once, 2 x 18
// values (at 8^4 x 8 chains x 4 links float32: 18.9 MB, 5.63 us at
// 3.35 TB/s). expm at (order 8, s 2) makes 9 complex 3x3 products a
// matrix, reunit 8 (the first Newton-Schulz step needs none): ~1,950 and
// ~1,800 operations, 3.8 and 3.5 us at the float32 peak. So both sit
// near the ridge, and the design keeps every value in registers and
// reads and writes each component plane once, coalesced: one thread a
// matrix, consecutive threads on consecutive l.
//
// No reductions: two launches on one input give the same bits.
//
// Interface: plain C, loaded with ctypes. Each entry point launches one
// kernel on the caller's stream and returns cudaGetLastError(); it
// switches the device only if the current one is not the tensors', so it
// can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct M3 {
  T re[9];
  T im[9];
};

// Where component [a, b] of matrix l lies, in elements: a sa + b sb + l sl.
struct Strides {
  long long a, b, l;
};

template <typename T>
__device__ __forceinline__ M3<T> load(const T* __restrict__ re, Strides sr,
                                      const T* __restrict__ im, Strides si,
                                      long long l) {
  M3<T> m;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      m.re[3 * a + b] = __ldg(re + a * sr.a + b * sr.b + l * sr.l);
      m.im[3 * a + b] = __ldg(im + a * si.a + b * si.b + l * si.l);
    }
  }
  return m;
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ re,
                                      T* __restrict__ im, long long L,
                                      long long l, const M3<T>& m) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    re[k * L + l] = m.re[k];
    im[k * L + l] = m.im[k];
  }
}

// op(a) b, op the adjoint where the flag is set; each component summed
// over k = 0, 1, 2 in order, as su3_comp.mm sums it.
template <bool ADJ_A, typename T>
__device__ __forceinline__ M3<T> mul(const M3<T>& a, const M3<T>& b) {
  M3<T> c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T sr = T(0), si = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T ar = ADJ_A ? a.re[3 * k + i] : a.re[3 * i + k];
        const T ai = ADJ_A ? -a.im[3 * k + i] : a.im[3 * i + k];
        sr += ar * b.re[3 * k + j] - ai * b.im[3 * k + j];
        si += ar * b.im[3 * k + j] + ai * b.re[3 * k + j];
      }
      c.re[3 * i + j] = sr;
      c.im[3 * i + j] = si;
    }
  }
  return c;
}

// full precision: no fast-math intrinsics
__device__ __forceinline__ float arg(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double arg(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ void sin_cos(float p, float* s, float* c) {
  sincosf(p, s, c);
}
__device__ __forceinline__ void sin_cos(double p, double* s, double* c) {
  sincos(p, s, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
su3_expm_fwd_kernel(const T* __restrict__ re, Strides sr,
                    const T* __restrict__ im, Strides si,
                    T* __restrict__ o_re, T* __restrict__ o_im, long long L,
                    int order, int s, T scale) {
  const long long l = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (l >= L) return;
  M3<T> m = load(re, sr, im, si, l);
  const T first = T(1) / T(order);
  M3<T> y;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    m.re[k] = scale * m.re[k];
    m.im[k] = scale * m.im[k];
    y.re[k] = m.re[k] * first;
    y.im[k] = m.im[k] * first;
  }
#pragma unroll 1
  for (int i = order - 1; i >= 1; --i) {
    const M3<T> p = mul<false>(m, y);
    const T inv = T(1) / T(i);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      y.re[k] = (m.re[k] + p.re[k]) * inv;
      y.im[k] = (m.im[k] + p.im[k]) * inv;
    }
  }
#pragma unroll 1
  for (int q = 0; q < s; ++q) {
    const M3<T> p = mul<false>(y, y);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      y.re[k] = T(2) * y.re[k] + p.re[k];
      y.im[k] = T(2) * y.im[k] + p.im[k];
    }
  }
  y.re[0] += T(1);
  y.re[4] += T(1);
  y.re[8] += T(1);
  store(o_re, o_im, L, l, y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
su3_reunit_fwd_kernel(const T* __restrict__ re, Strides sr,
                      const T* __restrict__ im, Strides si,
                      T* __restrict__ o_re, T* __restrict__ o_im,
                      long long L) {
  const long long l = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (l >= L) return;
  const M3<T> x = load(re, sr, im, si, l);
  const M3<T> t = mul<true>(x, x);
  // y = I, then y (1.5 I - 0.5 t y^2) = 1.5 I - 0.5 t
  M3<T> y;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    y.re[k] = (k % 4 == 0 ? T(1.5) : T(0)) - T(0.5) * t.re[k];
    y.im[k] = -T(0.5) * t.im[k];
  }
#pragma unroll 1
  for (int it = 1; it < 3; ++it) {
    M3<T> z = mul<false>(t, mul<false>(y, y));
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      z.re[k] = (k % 4 == 0 ? T(1.5) : T(0)) - T(0.5) * z.re[k];
      z.im[k] = -T(0.5) * z.im[k];
    }
    y = mul<false>(y, z);
  }
  M3<T> w = mul<false>(x, y);
  // det w by cofactors of the first row, as su3_comp.det3x3 takes it
  auto minor = [&](int i0, int i1, int j0, int j1, T* mr, T* mi) {
    const int a = 3 * i0 + j0, b = 3 * i1 + j1;
    const int c = 3 * i0 + j1, d = 3 * i1 + j0;
    const T p0r = w.re[a] * w.re[b] - w.im[a] * w.im[b];
    const T p0i = w.re[a] * w.im[b] + w.im[a] * w.re[b];
    const T p1r = w.re[c] * w.re[d] - w.im[c] * w.im[d];
    const T p1i = w.re[c] * w.im[d] + w.im[c] * w.re[d];
    *mr = p0r - p1r;
    *mi = p0i - p1i;
  };
  T m0r, m0i, m1r, m1i, m2r, m2i;
  minor(1, 2, 1, 2, &m0r, &m0i);
  minor(1, 2, 0, 2, &m1r, &m1i);
  minor(1, 2, 0, 1, &m2r, &m2i);
  const T t0r = w.re[0] * m0r - w.im[0] * m0i;
  const T t0i = w.re[0] * m0i + w.im[0] * m0r;
  const T t1r = w.re[1] * m1r - w.im[1] * m1i;
  const T t1i = w.re[1] * m1i + w.im[1] * m1r;
  const T t2r = w.re[2] * m2r - w.im[2] * m2i;
  const T t2i = w.re[2] * m2i + w.im[2] * m2r;
  const T p = arg(t0i - t1i + t2i, t0r - t1r + t2r) * (T(1) / T(-3));
  T sp, cp;
  sin_cos(p, &sp, &cp);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T wr = w.re[k], wi = w.im[k];
    w.re[k] = wr * cp - wi * sp;
    w.im[k] = wr * sp + wi * cp;
  }
  store(o_re, o_im, L, l, w);
}

// Makes `device` current for the scope if it is not already.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t err_;
};

bool valid(long long L, const long long* sr, const long long* si) {
  if (L < 1 || L > 0x7fffffffLL - kThreads) return false;
  for (int k = 0; k < 3; ++k) {
    if (sr[k] < 0 || si[k] < 0) return false;
  }
  return true;
}

unsigned blocks(long long L) {
  return static_cast<unsigned>((L + kThreads - 1) / kThreads);
}

template <typename T>
int launch_expm(const void* re, const long long* sr, const void* im,
                const long long* si, void* o_re, void* o_im, long long L,
                int order, int s, int device, void* stream) {
  if (!valid(L, sr, si) || order < 1 || s < 0 || s > 60) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const T scale = static_cast<T>(1.0 / static_cast<double>(1LL << s));
  su3_expm_fwd_kernel<T><<<blocks(L), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(re), Strides{sr[0], sr[1], sr[2]},
      static_cast<const T*>(im), Strides{si[0], si[1], si[2]},
      static_cast<T*>(o_re), static_cast<T*>(o_im), L, order, s, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reunit(const void* re, const long long* sr, const void* im,
                  const long long* si, void* o_re, void* o_im, long long L,
                  int device, void* stream) {
  if (!valid(L, sr, si)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  su3_reunit_fwd_kernel<T><<<blocks(L), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(re), Strides{sr[0], sr[1], sr[2]},
      static_cast<const T*>(im), Strides{si[0], si[1], si[2]},
      static_cast<T*>(o_re), static_cast<T*>(o_im), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// sr, si: the three element strides (a, b, l) of re and of im; the
// outputs are contiguous (3, 3, L).
int su3_expm_fwd_f32(const void* re, const long long* sr, const void* im,
                     const long long* si, void* o_re, void* o_im,
                     long long L, int order, int s, int device,
                     void* stream) {
  return launch_expm<float>(re, sr, im, si, o_re, o_im, L, order, s, device,
                            stream);
}

int su3_expm_fwd_f64(const void* re, const long long* sr, const void* im,
                     const long long* si, void* o_re, void* o_im,
                     long long L, int order, int s, int device,
                     void* stream) {
  return launch_expm<double>(re, sr, im, si, o_re, o_im, L, order, s, device,
                             stream);
}

int su3_reunit_fwd_f32(const void* re, const long long* sr, const void* im,
                       const long long* si, void* o_re, void* o_im,
                       long long L, int device, void* stream) {
  return launch_reunit<float>(re, sr, im, si, o_re, o_im, L, device, stream);
}

int su3_reunit_fwd_f64(const void* re, const long long* sr, const void* im,
                       const long long* si, void* o_re, void* o_im,
                       long long L, int device, void* stream) {
  return launch_reunit<double>(re, sr, im, si, o_re, o_im, L, device,
                               stream);
}

const char* su3_link_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
