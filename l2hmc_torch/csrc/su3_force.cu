// Fused 4D SU(3) Wilson staple force and plaquette traces, written by hand
// for Hopper (sm_90a): one launch for what the component engine's plain
// version (ops/su3_comp.py `force_and_traces_plain`) computes in about
// 1,100 small PyTorch kernels.
//
// Replaces: no TPU kernel. The JAX package leaves this function
// (ops/su3_comp.py `force_and_traces` there) to XLA, which fuses its
// elementwise component algebra; PyTorch runs each of those operations as
// a kernel of its own. The kernel serves the calls that no gradient is
// asked of (ops/su3_comp.py chooses): the draws' transitions, the Wilson
// flow of every draw, HMC, and a transition's first force.
//
// What it computes, for links U in the engine's layout (re, im each
// (3, 3, L), component [a, b] of link l at [((3 a + b) L + l) p], L = 4 V nb
// in the flat order (d, t, x, y, z, nb); the pitch p is 1 for contiguous
// planes and 2 where re and im are views of one complex lattice, as
// su3_comp.from_complex_lattice gives them where no copy is needed):
//   X_u(n) = sum_{v != u} U_u(n) U_v(n+u) U_u(n+v)^ U_v(n)^           (up)
//          + G_v(n-v) U_u(n) U_v(n+u-v)^ U_u(n-v)^ U_v(n-v)         (down)
//   F_u(n) = projectTAH(X_u(n)) * beta / 3
//   tr[c]  = sum over the 6 V plaquettes of chain c of Re tr P
// with G_v(m) = U_v(m)^ U_v(m) and periodic neighbours. X is U_u(n) times
// the sum of its six staples with G = 1; G is there because the plain
// version (shared-plaquette products) forms each down term as
// [U_v^ P U_v]^, which equals U times the down staple on the group alone.
// So the kernel gives the plain version's force, to rounding, on links
// off the group too (a float32 hot start is off it by up to ~0.08). The
// up terms of v < u are the plaquettes P_uv(n), u > v: each plaquette
// once.
//
// Bound on the card: the lattice is read once and the force written once,
// 2 x 18 values a link (at 8^4 x 8 chains float32: 18.9 MB, 5.6 us at
// 3.35 TB/s); the 13 complex 3x3 products a link that the force needs
// (2,808 operations; with G the kernel makes 22) take about as long at
// the float32 peak. The staples read each link 19 times
// (itself and six neighbours in each of three planes), so the design
// keeps those repeated reads in the caches: one thread a link,
// consecutive threads on consecutive L, so every component plane is read
// and written coalesced, the neighbour reads of a block overlap in L1 and
// the whole lattice (9.4 MB at 8^4 x 8) stays in the 50 MB L2. Every
// product stays in registers.
//
// The trace sums are deterministic: no floating-point atomics. Each
// block sums its links' traces per chain in shared memory in a fixed
// tree, in double, and writes one partial per chain; the last block to
// finish (an integer ticket, the "last block done" pattern) adds the
// partials in block order. The ticket counter is a device variable of
// this library, zero when it loads, that the last block's atomicInc
// wraps back to zero: launches of this kernel on one device must not
// overlap in time (the port launches them in order on one stream).
//
// beta is a device operand: a pointer to one value of the kernel's dtype
// that every thread reads when the kernel runs, so a CUDA graph captured
// at one beta replays at whatever value it holds; where the caller gives a
// number the pointer is null and the number comes as a kernel argument.
//
// The backward (su3_force_bwd: two kernels a call, su3_force_bwd_plaq and
// su3_force_bwd_link) serves the calls that want a gradient of the links,
// as the autograd.Function of ops/kernels/su3_force.py. It replaces no TPU
// kernel either: the JAX package differentiates the plain `jnp` version
// with autodiff, which XLA fuses; PyTorch's autograd runs about 3,800
// small kernels a call for it. It returns the VJP of the plain version
// (ops/su3_comp.py `force_and_traces_plain`) with respect to the links,
// exactly as that version is written, so on links off the group too. For
// the force cotangent G and the trace cotangent t (per chain; either may
// be absent), with Mb = beta/3 projectTAH(G) (projectTAH is an orthogonal
// projection, its own adjoint; Mb is anti-hermitian, Mb^ = -Mb):
//   Pb_uv(n) = Mb_u(n) - Mb_v(n) + t I - U_v(n) Mb_u(n+v) U_v(n)^
//            + U_u(n) Mb_v(n+u) U_u(n)^                     (u > v, pass 1)
// is the cotangent of the plaquette P_uv(n) (its four force terms and the
// trace), and with Pb_vu = Pb_uv^, P_vu = P_uv^, for each link and its
// three other directions nu (pass 2):
//   Ub_mu(n) = sum_nu  Pb_munu(n) U_nu(n) U_mu(n+nu) U_nu(n+mu)^
//            + U_nu(m)^ Pb_munu(m)^ U_mu(m) U_nu(m+mu)        (m = n - nu)
//            + (P_munu(n)^ - P_munu(n)) U_mu(n) Mb_nu(n+mu)
// (the last from the conjugations U_v^ P U_v, U_u^ P^ U_u of the down
// terms). Bound: the links and G read once, the gradient written once and
// t read, 3 x 18 values a link (at 8^4 x 8 float32: 28.3 MB, 8.45 us at
// 3.35 TB/s); its 33 products a link (4 a plaquette in pass 1, 9 per
// direction in pass 2) take 13.9 us at the float32 peak, so both count.
// The design: gather, never scatter, so no floating-point atomics and no
// reduction across blocks (t is only broadcast), and two launches on one
// input give the same bits. Pass 1 writes Pb, 6 x 18 values a site (14
// MB at 8^4 x 8 float32, which stays in the 50 MB L2 for pass 2); pass 2
// is one thread a link, like the forward, each reading its neighbours'
// links and two Pb a direction from L1 and L2 and keeping every product
// in registers. Without G, Pb is t I and the Mb terms are skipped.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// caller's stream and returns cudaGetLastError(); it switches the device
// only if the current one is not the tensors', and launches one kernel, so
// it can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Threads a block of the backward's two kernels.
constexpr int kBwdThreads = 128;

// Blocks of the current launch that have finished their partials.
__device__ unsigned int g_blocks_done = 0;

template <typename T>
struct M3 {
  T re[9];
  T im[9];
};

// link l of (re, im), whose consecutive values lie `pitch` apart
template <typename T>
__device__ __forceinline__ M3<T> load(const T* __restrict__ re,
                                      const T* __restrict__ im, int L,
                                      int pitch, int l) {
  M3<T> m;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const size_t at = (static_cast<size_t>(k) * L + l) * pitch;
    m.re[k] = __ldg(re + at);
    m.im[k] = __ldg(im + at);
  }
  return m;
}

// op(a) op(b), op the adjoint where the flag is set.
template <bool ADJ_A, bool ADJ_B, typename T>
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
        const T br = ADJ_B ? b.re[3 * j + k] : b.re[3 * k + j];
        const T bi = ADJ_B ? -b.im[3 * j + k] : b.im[3 * k + j];
        sr += ar * br - ai * bi;
        si += ar * bi + ai * br;
      }
      c.re[3 * i + j] = sr;
      c.im[3 * i + j] = si;
    }
  }
  return c;
}

template <typename T>
__device__ __forceinline__ void add_to(M3<T>& acc, const M3<T>& m) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc.re[k] += m.re[k];
    acc.im[k] += m.im[k];
  }
}

// Re tr(a b)
template <typename T>
__device__ __forceinline__ T re_trace_mul(const M3<T>& a, const M3<T>& b) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s += a.re[3 * i + k] * b.re[3 * k + i] -
           a.im[3 * i + k] * b.im[3 * k + i];
    }
  }
  return s;
}

// Where one link's neighbours lie: its site's coordinates and the lattice.
struct Site {
  int s;        // site index, row-major (t, x, y, z)
  int n[4];     // extents
  int step[4];  // site strides
  int at[4];    // coordinates

  __device__ __forceinline__ Site(int site, const int (&ext)[4]) : s(site) {
    int st = 1;
#pragma unroll
    for (int mu = 3; mu >= 0; --mu) {
      n[mu] = ext[mu];
      step[mu] = st;
      at[mu] = (site / st) % ext[mu];
      st *= ext[mu];
    }
  }

  // the site one step along mu (dir +1 or -1) from `from`, a site with
  // this site's coordinate along mu
  __device__ __forceinline__ int shift(int from, int mu, int dir) const {
    if (dir > 0) {
      return at[mu] + 1 == n[mu] ? from - (n[mu] - 1) * step[mu]
                                 : from + step[mu];
    }
    return at[mu] == 0 ? from + (n[mu] - 1) * step[mu] : from - step[mu];
  }
};

// In place over vals[0, n): vals[r] += vals[j nb + r] for every row j,
// r < nb, in a fixed tree over the rows. Every thread of the block calls
// it; it ends with a barrier.
__device__ __forceinline__ void column_sums(double* vals, int nb, int n) {
  const int tid = threadIdx.x;
  const int rows = (n + nb - 1) / nb;
  const int j = tid / nb;
  const int r = tid - j * nb;
  for (int half = 1; half < rows; half <<= 1) {
    if (tid < n && j % (2 * half) == 0 && (j + half) * nb + r < n) {
      vals[tid] += vals[tid + half * nb];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
su3_force_fwd_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     int pitch, T* __restrict__ f_re, T* __restrict__ f_im,
                     T* __restrict__ tr, double* __restrict__ partial,
                     const T* __restrict__ beta_ptr, T beta_value,
                     int nt, int nx, int ny, int nz, int nb) {
  __shared__ double vals[kThreads];
  __shared__ bool last;
  const int ext[4] = {nt, nx, ny, nz};
  const int V = nt * nx * ny * nz;
  const int L = 4 * V * nb;  // below 2^31: the launcher checks
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kThreads + tid;
  const T beta = beta_ptr ? __ldg(beta_ptr) : beta_value;

  double plaq = 0.0;
  if (l < L) {
    const int c = l % nb;
    const int rest = l / nb;
    const int u = rest / V;
    const Site n(rest - u * V, ext);
    auto link = [&](int d, int site) { return (d * V + site) * nb + c; };
    const M3<T> U = load(re, im, L, pitch, l);
    M3<T> A;
#pragma unroll
    for (int k = 0; k < 9; ++k) A.re[k] = A.im[k] = T(0);
    // up staples U_v(n+u) U_u(n+v)^ U_v(n)^; when v reaches u, A holds
    // those of v < u, whose product with U are the plaquettes P_uv(n)
#pragma unroll 1
    for (int v = 0; v < 4; ++v) {
      if (v == u) {
        plaq = static_cast<double>(re_trace_mul(U, A));
        continue;
      }
      const M3<T> a = mul<false, true>(
          load(re, im, L, pitch, link(v, n.shift(n.s, u, 1))),
          load(re, im, L, pitch, link(u, n.shift(n.s, v, 1))));
      add_to(A, mul<false, true>(a, load(re, im, L, pitch, link(v, n.s))));
    }
    M3<T> X = mul<false, false>(U, A);
    // down terms G_v(m) U U_v(m+u)^ U_u(m)^ U_v(m), m = n - v
#pragma unroll 1
    for (int v = 0; v < 4; ++v) {
      if (v == u) continue;
      const int m = n.shift(n.s, v, -1);
      const M3<T> w = load(re, im, L, pitch, link(v, m));
      const M3<T> a = mul<true, true>(
          load(re, im, L, pitch, link(v, n.shift(m, u, 1))),
          load(re, im, L, pitch, link(u, m)));
      add_to(X, mul<true, false>(w, mul<false, false>(
                                        w, mul<false, false>(
                                               U, mul<false, false>(a, w)))));
    }
    // projectTAH(X) beta / 3: the anti-hermitian part less its trace
    const T b3 = beta / T(3);
    const T tim = (X.im[0] + X.im[4] + X.im[8]) / T(3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int k = 3 * i + j, kt = 3 * j + i;
        T zr = T(0.5) * (X.re[k] - X.re[kt]);
        T zi = T(0.5) * (X.im[k] + X.im[kt]);
        if (i == j) zi -= tim;
        const size_t at = static_cast<size_t>(k) * L + l;
        f_re[at] = b3 * zr;
        f_im[at] = b3 * zi;
      }
    }
  }

  // this block's traces per chain, in a fixed order
  vals[tid] = plaq;
  __syncthreads();
  column_sums(vals, nb, kThreads);
  const int offset = (blockIdx.x * kThreads) % nb;
  for (int c = tid; c < nb; c += kThreads) {
    const int r = (c - offset + nb) % nb;  // the column of chain c
    partial[static_cast<size_t>(blockIdx.x) * nb + c] =
        r < kThreads ? vals[r] : 0.0;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicInc(&g_blocks_done, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every chain's partials, in block order
  __threadfence();
  const size_t total = static_cast<size_t>(gridDim.x) * nb;
  if (nb <= kThreads) {
    const int used = (kThreads / nb) * nb;  // a multiple of nb
    double s = 0.0;
    if (tid < used) {
      for (size_t e = tid; e < total; e += used) s += __ldcg(partial + e);
    }
    vals[tid] = s;
    __syncthreads();
    column_sums(vals, nb, used);
    if (tid < nb) tr[tid] = static_cast<T>(vals[tid]);
  } else {
    for (int c = tid; c < nb; c += kThreads) {
      double s = 0.0;
      for (size_t b = 0; b < gridDim.x; ++b) {
        s += __ldcg(partial + b * nb + c);
      }
      tr[c] = static_cast<T>(s);
    }
  }
}

// beta / 3 times projectTAH of the force cotangent of link l (contiguous
// planes): anti-hermitian to the bit, as the forward's projection is.
template <typename T>
__device__ __forceinline__ M3<T> tah_cotangent(const T* __restrict__ g_re,
                                               const T* __restrict__ g_im,
                                               int L, int l, T b3) {
  const M3<T> g = load(g_re, g_im, L, 1, l);
  const T tim = (g.im[0] + g.im[4] + g.im[8]) / T(3);
  M3<T> m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * i + j, kt = 3 * j + i;
      T zi = T(0.5) * (g.im[k] + g.im[kt]);
      if (i == j) zi -= tim;
      m.re[k] = b3 * (T(0.5) * (g.re[k] - g.re[kt]));
      m.im[k] = b3 * zi;
    }
  }
  return m;
}

template <typename T>
__device__ __forceinline__ void sub_from(M3<T>& acc, const M3<T>& m) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc.re[k] -= m.re[k];
    acc.im[k] -= m.im[k];
  }
}

// The plaquette cotangents Pb: value k (re 0-8, im 9-17) of plane p (u > v,
// p = u (u - 1) / 2 + v, plaq_traces' order) at site-and-chain r lies at
// [(k 6 + p) sites + r], sites = V nb.
template <typename T>
__device__ __forceinline__ M3<T> load_plane(const T* __restrict__ pbar,
                                            int sites, int plane, int r) {
  M3<T> m;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    m.re[k] = __ldg(pbar + (static_cast<size_t>(k) * 6 + plane) * sites + r);
    m.im[k] =
        __ldg(pbar + (static_cast<size_t>(9 + k) * 6 + plane) * sites + r);
  }
  return m;
}

// Pass 1: one thread a plaquette (plane, site, chain), chain fastest.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
su3_force_bwd_plaq_kernel(const T* __restrict__ re, const T* __restrict__ im,
                          int pitch, const T* __restrict__ g_re,
                          const T* __restrict__ g_im,
                          const T* __restrict__ g_tr, T* __restrict__ pbar,
                          const T* __restrict__ beta_ptr, T beta_value,
                          int nt, int nx, int ny, int nz, int nb) {
  const int ext[4] = {nt, nx, ny, nz};
  const int V = nt * nx * ny * nz;
  const int sites = V * nb;
  const int L = 4 * sites;
  const int i = blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= 6 * sites) return;  // below 2^31: the launcher checks
  const int plane = i / sites;
  const int r = i - plane * sites;
  const int c = r % nb;
  const Site n(r / nb, ext);
  const int u = plane < 1 ? 1 : (plane < 3 ? 2 : 3);
  const int v = plane - u * (u - 1) / 2;
  auto link = [&](int d, int site) { return (d * V + site) * nb + c; };

  const T t = g_tr ? __ldg(g_tr + c) : T(0);
  M3<T> pb;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    pb.re[k] = k % 4 == 0 ? t : T(0);
    pb.im[k] = T(0);
  }
  if (g_re) {
    const T b3 = (beta_ptr ? __ldg(beta_ptr) : beta_value) / T(3);
    add_to(pb, tah_cotangent(g_re, g_im, L, link(u, n.s), b3));
    sub_from(pb, tah_cotangent(g_re, g_im, L, link(v, n.s), b3));
    const M3<T> uv = load(re, im, L, pitch, link(v, n.s));
    sub_from(pb, mul<false, true>(
                     mul<false, false>(
                         uv, tah_cotangent(g_re, g_im, L,
                                           link(u, n.shift(n.s, v, 1)), b3)),
                     uv));
    const M3<T> uu = load(re, im, L, pitch, link(u, n.s));
    add_to(pb, mul<false, true>(
                   mul<false, false>(
                       uu, tah_cotangent(g_re, g_im, L,
                                         link(v, n.shift(n.s, u, 1)), b3)),
                   uu));
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    pbar[(static_cast<size_t>(k) * 6 + plane) * sites + r] = pb.re[k];
    pbar[(static_cast<size_t>(9 + k) * 6 + plane) * sites + r] = pb.im[k];
  }
}

// Pass 2: one thread a link, consecutive threads on consecutive L, as in
// the forward; the gradient is written contiguous.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
su3_force_bwd_link_kernel(const T* __restrict__ re, const T* __restrict__ im,
                          int pitch, const T* __restrict__ g_re,
                          const T* __restrict__ g_im,
                          const T* __restrict__ pbar, T* __restrict__ x_re,
                          T* __restrict__ x_im,
                          const T* __restrict__ beta_ptr, T beta_value,
                          int nt, int nx, int ny, int nz, int nb) {
  const int ext[4] = {nt, nx, ny, nz};
  const int V = nt * nx * ny * nz;
  const int sites = V * nb;
  const int L = 4 * sites;
  const int l = blockIdx.x * kBwdThreads + threadIdx.x;
  if (l >= L) return;
  const int c = l % nb;
  const int rest = l / nb;
  const int mu = rest / V;
  const Site n(rest - mu * V, ext);
  auto link = [&](int d, int site) { return (d * V + site) * nb + c; };
  const T b3 = (beta_ptr ? __ldg(beta_ptr) : beta_value) / T(3);

  const M3<T> U = load(re, im, L, pitch, l);
  M3<T> acc;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc.re[k] = acc.im[k] = T(0);
#pragma unroll 1
  for (int nu = 0; nu < 4; ++nu) {
    if (nu == mu) continue;
    // Pb_munu is the stored plane's where mu > nu, its adjoint where not
    const bool adj = mu < nu;
    const int hi = adj ? nu : mu, lo = adj ? mu : nu;
    const int plane = hi * (hi - 1) / 2 + lo;
    const int n_mu = n.shift(n.s, mu, 1);
    // S = U_nu(n) U_mu(n+nu) U_nu(n+mu)^, so that P_munu(n) = U S^
    const M3<T> S = mul<false, true>(
        mul<false, false>(load(re, im, L, pitch, link(nu, n.s)),
                          load(re, im, L, pitch,
                               link(mu, n.shift(n.s, nu, 1)))),
        load(re, im, L, pitch, link(nu, n_mu)));
    const M3<T> pb = load_plane(pbar, sites, plane, n.s * nb + c);
    add_to(acc, adj ? mul<true, false>(pb, S) : mul<false, false>(pb, S));
    if (g_re) {
      const M3<T> P = mul<false, true>(U, S);
      M3<T> D;  // P^ - P
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int k = 3 * i + j, kt = 3 * j + i;
          D.re[k] = P.re[kt] - P.re[k];
          D.im[k] = -P.im[kt] - P.im[k];
        }
      }
      add_to(acc, mul<false, false>(
                      mul<false, false>(D, U),
                      tah_cotangent(g_re, g_im, L, link(nu, n_mu), b3)));
    }
    // U_nu(m)^ Pb_munu(m)^ U_mu(m) U_nu(m+mu), m = n - nu
    const int m = n.shift(n.s, nu, -1);
    const M3<T> pm = load_plane(pbar, sites, plane, m * nb + c);
    const M3<T> um = load(re, im, L, pitch, link(nu, m));
    const M3<T> w = adj ? mul<true, false>(um, pm) : mul<true, true>(um, pm);
    add_to(acc, mul<false, false>(
                    mul<false, false>(w, load(re, im, L, pitch, link(mu, m))),
                    load(re, im, L, pitch, link(nu, n.shift(m, mu, 1)))));
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const size_t at = static_cast<size_t>(k) * L + l;
    x_re[at] = acc.re[k];
    x_im[at] = acc.im[k];
  }
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

template <typename T>
int launch(const void* re, const void* im, int pitch, void* f_re, void* f_im,
           void* tr, void* partial, long long partial_len,
           const void* beta_ptr, double beta_value, int nt, int nx, int ny,
           int nz, int nb, int device, void* stream) {
  if (nt < 1 || nx < 1 || ny < 1 || nz < 1 || nb < 1 || pitch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long links = 4LL * nt * nx * ny * nz * nb;
  const long long blocks = (links + kThreads - 1) / kThreads;
  if (links > 0x7fffffffLL - kThreads || partial_len < blocks * nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  su3_force_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), pitch,
      static_cast<T*>(f_re), static_cast<T*>(f_im), static_cast<T*>(tr),
      static_cast<double*>(partial), static_cast<const T*>(beta_ptr),
      static_cast<T>(beta_value), nt, nx, ny, nz, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* re, const void* im, int pitch, const void* g_re,
               const void* g_im, const void* g_tr, void* pbar,
               long long pbar_len, void* x_re, void* x_im,
               const void* beta_ptr, double beta_value, int nt, int nx,
               int ny, int nz, int nb, int device, void* stream) {
  if (nt < 1 || nx < 1 || ny < 1 || nz < 1 || nb < 1 || pitch < 1 ||
      (g_re == nullptr) != (g_im == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long sites = 1LL * nt * nx * ny * nz * nb;
  if (6 * sites > 0x7fffffffLL - kBwdThreads || pbar_len < 18 * 6 * sites) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* beta = static_cast<const T*>(beta_ptr);
  su3_force_bwd_plaq_kernel<T>
      <<<static_cast<unsigned>((6 * sites + kBwdThreads - 1) / kBwdThreads),
         kBwdThreads, 0, s>>>(
          static_cast<const T*>(re), static_cast<const T*>(im), pitch,
          static_cast<const T*>(g_re), static_cast<const T*>(g_im),
          static_cast<const T*>(g_tr), static_cast<T*>(pbar), beta,
          static_cast<T>(beta_value), nt, nx, ny, nz, nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  su3_force_bwd_link_kernel<T>
      <<<static_cast<unsigned>((4 * sites + kBwdThreads - 1) / kBwdThreads),
         kBwdThreads, 0, s>>>(
          static_cast<const T*>(re), static_cast<const T*>(im), pitch,
          static_cast<const T*>(g_re), static_cast<const T*>(g_im),
          static_cast<const T*>(pbar), static_cast<T*>(x_re),
          static_cast<T*>(x_im), beta, static_cast<T>(beta_value), nt, nx,
          ny, nz, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads a block: the wrapper sizes `partial` (blocks x nb doubles) by it.
int su3_force_threads() { return kThreads; }

// pitch: values from one link to the next in re and im (1: contiguous);
// beta_ptr may be null: beta_value is then used.
int su3_force_fwd_f32(const void* re, const void* im, int pitch, void* f_re,
                      void* f_im, void* tr, void* partial,
                      long long partial_len, const void* beta_ptr,
                      double beta_value, int nt, int nx, int ny, int nz,
                      int nb, int device, void* stream) {
  return launch<float>(re, im, pitch, f_re, f_im, tr, partial, partial_len,
                       beta_ptr, beta_value, nt, nx, ny, nz, nb, device,
                       stream);
}

int su3_force_fwd_f64(const void* re, const void* im, int pitch, void* f_re,
                      void* f_im, void* tr, void* partial,
                      long long partial_len, const void* beta_ptr,
                      double beta_value, int nt, int nx, int ny, int nz,
                      int nb, int device, void* stream) {
  return launch<double>(re, im, pitch, f_re, f_im, tr, partial, partial_len,
                        beta_ptr, beta_value, nt, nx, ny, nz, nb, device,
                        stream);
}

// The VJP of the force and traces with respect to the links: g_re and g_im
// (the force cotangent, contiguous) both null or neither, g_tr (nb) may be
// null; pbar is scratch of 18 x 6 x V nb values; x_re, x_im are written
// contiguous.
int su3_force_bwd_f32(const void* re, const void* im, int pitch,
                      const void* g_re, const void* g_im, const void* g_tr,
                      void* pbar, long long pbar_len, void* x_re, void* x_im,
                      const void* beta_ptr, double beta_value, int nt, int nx,
                      int ny, int nz, int nb, int device, void* stream) {
  return launch_bwd<float>(re, im, pitch, g_re, g_im, g_tr, pbar, pbar_len,
                           x_re, x_im, beta_ptr, beta_value, nt, nx, ny, nz,
                           nb, device, stream);
}

int su3_force_bwd_f64(const void* re, const void* im, int pitch,
                      const void* g_re, const void* g_im, const void* g_tr,
                      void* pbar, long long pbar_len, void* x_re, void* x_im,
                      const void* beta_ptr, double beta_value, int nt, int nx,
                      int ny, int nz, int nb, int device, void* stream) {
  return launch_bwd<double>(re, im, pitch, g_re, g_im, g_tr, pbar, pbar_len,
                            x_re, x_im, beta_ptr, beta_value, nt, nx, ny, nz,
                            nb, device, stream);
}

const char* su3_force_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
