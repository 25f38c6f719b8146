// Fused 2D U(1) Wilson-loop / action / force kernels and the force's
// backward, written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel in the JAX package, ops/pallas/u1_kernels.py
//   `_kernel` (body :30-52, pallas_call :71, reached through
//   `force_action_t` / `force_action` / `force_action_ad`) with
//   u1_force_fwd, and that kernel's custom VJP `_fa_bwd` (:126-138, plain
//   jnp in the JAX package) with u1_force_bwd.
//
// What they compute, per chain (x = [xu, xv], each nt*nx, row-major t, x):
//   W[t,x]   = xu[t,x] + xv[t+1,x] - xu[t,x+1] - xv[t,x]   (periodic)
//   S        = beta * sum (1 - cos W)                        (action)
//   F        = beta * A^T sin W                               (force)
//     F_u[t,x] = beta (sin W[t,x] - sin W[t,x-1])
//     F_v[t,x] = beta (sin W[t-1,x] - sin W[t,x])
//   backward: x_bar = beta * A^T (cos W * A gF) + gS * F
//
// Bound on the card: both are memory bound. At the main-path shape
// (2048 chains x 2x16x16, float32) the forward must move 8.4 MB (read x,
// write F and S) and the backward 16.8 MB (read x, gF, F, gS, write
// x_bar): 2.5 us and 5.0 us at 3.35 TB/s. The arithmetic (about a dozen
// flops and one sincos per site) is far below the float32 peak. At these
// sizes the launch itself (several us) sets the pace, not the bytes.
//
// Design against that bound: one block per chain. The chain's links
// (and, in the backward, its gF) are read once from device memory into
// dynamic shared memory with unit-stride loads; every wrapped neighbour
// access ([t+1,x], [t,x+1], [t,x-1], [t-1,x]) then hits shared memory, so
// each input byte crosses HBM once and each output byte is written once,
// coalesced. sin W (forward) or cos W * A gF (backward) is staged in
// shared memory between two __syncthreads-separated passes. The per-chain
// action is a warp-shuffle reduction plus one shared-memory pass over the
// warps: deterministic, no atomics. No launch-overhead work (CUDA graphs,
// fusing several leapfrog steps) is attempted here.
//
// Shared memory per block: forward 3*nt*nx*sizeof(T), backward
// 5*nt*nx*sizeof(T); the wrapper (ops/kernels/u1_force.py) checks this
// against the 227 KB a block can use before it launches.
//
// Interface: plain C, loaded with ctypes. Each entry point sets the
// device, launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ void sincos_t(T w, T* s, T* c);

template <>
__device__ __forceinline__ void sincos_t<float>(float w, float* s, float* c) {
  sincosf(w, s, c);
}

template <>
__device__ __forceinline__ void sincos_t<double>(double w, double* s,
                                                 double* c) {
  sincos(w, s, c);
}

__device__ __forceinline__ float cos_t(float w) { return cosf(w); }
__device__ __forceinline__ double cos_t(double w) { return cos(w); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the block; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* partial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  T r = T(0);
  if (warp == 0) {
    r = lane < kWarps ? partial[lane] : T(0);
    r = warp_sum(r);
  }
  return r;
}

// W at site i = t*nx + s of one chain whose [xu, xv] lie at a, a + V.
template <typename T>
__device__ __forceinline__ T plaquette(const T* a, int V, int t, int s,
                                       int nt, int nx) {
  const int tp = (t + 1 == nt) ? 0 : t + 1;
  const int sp = (s + 1 == nx) ? 0 : s + 1;
  const int i = t * nx + s;
  return a[i] + a[V + tp * nx + s] - a[t * nx + sp] - a[V + i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
u1_force_fwd_kernel(const T* __restrict__ x, T* __restrict__ force,
                    T* __restrict__ act, T beta, int nt, int nx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T partial[kWarps];
  const int V = nt * nx;
  T* sx = reinterpret_cast<T*>(smem_raw);  // [xu | xv], 2V
  T* ssin = sx + 2 * V;                     // sin W, V
  const size_t base = static_cast<size_t>(blockIdx.x) * 2 * V;

  const T* xb = x + base;
  for (int i = threadIdx.x; i < 2 * V; i += kThreads) sx[i] = xb[i];
  __syncthreads();

  T local = T(0);
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const int t = i / nx;
    const int s = i - t * nx;
    T sn, cs;
    sincos_t(plaquette(sx, V, t, s, nt, nx), &sn, &cs);
    ssin[i] = sn;
    local += T(1) - cs;
  }
  __syncthreads();

  T* fb = force + base;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const int t = i / nx;
    const int s = i - t * nx;
    const int tm = (t == 0) ? nt - 1 : t - 1;
    const int sm = (s == 0) ? nx - 1 : s - 1;
    const T sw = ssin[i];
    fb[i] = beta * (sw - ssin[t * nx + sm]);
    fb[V + i] = beta * (ssin[tm * nx + s] - sw);
  }

  const T total = block_sum(local, partial);
  if (threadIdx.x == 0) act[blockIdx.x] = beta * total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
u1_force_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g_force,
                    const T* __restrict__ g_act, const T* __restrict__ force,
                    T* __restrict__ x_bar, T beta, int nt, int nx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = nt * nx;
  T* sx = reinterpret_cast<T*>(smem_raw);  // [xu | xv], 2V
  T* sg = sx + 2 * V;                       // [gF_u | gF_v], 2V
  T* sy = sg + 2 * V;                       // cos W * (A gF), V
  const size_t base = static_cast<size_t>(blockIdx.x) * 2 * V;

  const T* xb = x + base;
  const T* gb = g_force + base;
  for (int i = threadIdx.x; i < 2 * V; i += kThreads) {
    sx[i] = xb[i];
    sg[i] = gb[i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < V; i += kThreads) {
    const int t = i / nx;
    const int s = i - t * nx;
    sy[i] = cos_t(plaquette(sx, V, t, s, nt, nx)) *
            plaquette(sg, V, t, s, nt, nx);
  }
  __syncthreads();

  const T gs = g_act[blockIdx.x];
  const T* fb = force + base;
  T* ob = x_bar + base;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const int t = i / nx;
    const int s = i - t * nx;
    const int tm = (t == 0) ? nt - 1 : t - 1;
    const int sm = (s == 0) ? nx - 1 : s - 1;
    const T y = sy[i];
    ob[i] = beta * (y - sy[t * nx + sm]) + gs * fb[i];
    ob[V + i] = beta * (sy[tm * nx + s] - y) + gs * fb[V + i];
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // opt in above the default 48 KB; the 1 KB margin leaves room for the
  // kernels' static shared memory (the reduction's per-warp partials)
  if (smem + 1024 > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return err;
}

template <typename T>
int launch_fwd(const void* x, void* force, void* act, double beta, int nb,
               int nt, int nx, int device, void* stream) {
  const size_t smem = 3 * static_cast<size_t>(nt) * nx * sizeof(T);
  cudaError_t err = prepare(u1_force_fwd_kernel<T>, device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  u1_force_fwd_kernel<T><<<nb, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(force), static_cast<T*>(act),
      static_cast<T>(beta), nt, nx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g_force, const void* g_act,
               const void* force, void* x_bar, double beta, int nb, int nt,
               int nx, int device, void* stream) {
  const size_t smem = 5 * static_cast<size_t>(nt) * nx * sizeof(T);
  cudaError_t err = prepare(u1_force_bwd_kernel<T>, device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  u1_force_bwd_kernel<T><<<nb, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_force),
      static_cast<const T*>(g_act), static_cast<const T*>(force),
      static_cast<T*>(x_bar), static_cast<T>(beta), nt, nx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int u1_force_fwd_f32(const void* x, void* force, void* act, double beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_fwd<float>(x, force, act, beta, nb, nt, nx, device, stream);
}

int u1_force_fwd_f64(const void* x, void* force, void* act, double beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_fwd<double>(x, force, act, beta, nb, nt, nx, device, stream);
}

int u1_force_bwd_f32(const void* x, const void* g_force, const void* g_act,
                     const void* force, void* x_bar, double beta, int nb,
                     int nt, int nx, int device, void* stream) {
  return launch_bwd<float>(x, g_force, g_act, force, x_bar, beta, nb, nt, nx,
                           device, stream);
}

int u1_force_bwd_f64(const void* x, const void* g_force, const void* g_act,
                     const void* force, void* x_bar, double beta, int nb,
                     int nt, int nx, int device, void* stream) {
  return launch_bwd<double>(x, g_force, g_act, force, x_bar, beta, nb, nt,
                            nx, device, stream);
}

}  // extern "C"
