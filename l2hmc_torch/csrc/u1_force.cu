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
//   (gS may be absent, a null pointer: then F is not read at all)
//
// Bound on the card: both are memory bound. At the main-path shape
// (2048 chains x 2x16x16, float32) the forward must move 8.4 MB (read x,
// write F and S), the backward 12.6 MB without gS and 16.8 MB with it
// (read x, gF, F, gS, write x_bar): 2.5, 3.8 and 5.0 us at 3.35 TB/s. The
// arithmetic (about a dozen flops and one sincos per site) is far below
// the float32 peak. At these sizes the time is one round trip to device
// memory plus the launch, so the design keeps as many bytes in flight per
// SM as it can from the first instruction on, and spends few instructions
// and few barriers around them.
//
// Design:
//  - A chain is worked on by a group of threads: one warp where the
//    lattice is small (nt*nx*sizeof(T) <= 4 KB, e.g. 16x16 and 32x32
//    float32), so that eight chains share a block, the group's barrier is
//    __syncwarp and the action is a pure shuffle reduction; the whole block
//    (256 threads) for larger lattices such as 64x64. The action is summed
//    in a fixed order without atomics: the same bits from run to run.
//  - The grid is persistent: at most as many blocks as the card holds at
//    once (SM count x resident blocks, asked of the runtime once per
//    kernel, device and shared-memory size), and each group walks over
//    chains group, group + ngroups, ... A chain's links are one contiguous
//    run of 2*nt*nx*sizeof(T) bytes, which the group's first thread brings
//    into a ring of 1-3 shared-memory stages with one 1-D bulk asynchronous
//    copy per operand, each stage with its mbarrier; copies for the next
//    chains are in flight while this one is computed. Where pointers or the
//    chain's size are not multiples of 16 bytes (odd nt*nx at float32, an
//    offset view) the group copies with ordinary loads instead, inside the
//    same kernel.
//  - Every wrapped neighbour access ([t+1,x], [t,x+1], [t,x-1], [t-1,x])
//    hits shared memory, so each input byte crosses device memory once.
//    sin W (forward) or cos W * A gF (backward) is staged in shared memory
//    between the two passes.
//  - For nx = 16, 32, 64 (template argument) a thread works on 16 bytes of
//    consecutive sites: 16-byte shared-memory reads, 16-byte coalesced
//    stores of the result, and shifts in place of the divisions by nx.
//    Other nx take the site-per-thread path with runtime nx.
//
//  - beta is a device operand, as the TPU kernel's is an SMEM operand: a
//    pointer to one value of the kernel's dtype, which every thread reads
//    once when the kernel starts (the same address for all, so one
//    request per warp) and keeps in a register. The read is not waited on
//    before the first chain's copy is issued, and a CUDA graph captured
//    at one beta computes with whatever value the pointer holds when it
//    is replayed.
//
// Shared memory per block: groups x (stages x S + nt*nx*sizeof(T)), with
// S = 2*nt*nx*sizeof(T) (forward) or twice that (backward); with one stage
// and one group that is 3 resp. 5 words per site, which the wrapper
// (ops/kernels/u1_force.py) checks against the 227 KB a block can use.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// caller's stream and returns cudaGetLastError(); it switches the device
// only if the current one is not the tensors', and does its per-kernel
// set-up once, so a launch is capturable in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

#include "hopper_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;
// a warp takes a chain whose sites fill at most this many bytes
constexpr size_t kWarpChainBytes = 4096;
// more stages are taken only while a block stays below this, so that
// three or more blocks still fit an SM
constexpr size_t kRingBudget = 75 * 1024;

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

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// VEC consecutive values, moved with one load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// The threads that share a chain: a warp (GW == 1) or the block.
template <int GW>
struct Group {
  static_assert(GW == 1 || GW == kWarps, "a group is a warp or the block");
  static constexpr int kSize = GW * 32;
  static constexpr int kPerBlock = kWarps / GW;
  __device__ static __forceinline__ int tid() {
    return GW == 1 ? (threadIdx.x & 31) : threadIdx.x;
  }
  __device__ static __forceinline__ int in_block() {
    return GW == 1 ? (threadIdx.x >> 5) : 0;
  }
  __device__ static __forceinline__ void sync() {
    if constexpr (GW == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the group; the result is valid in the group's thread 0.
// `partial` (kWarps values) is used by the block-wide group only.
template <typename T, int GW>
__device__ __forceinline__ T group_sum(T v, T* partial) {
  v = warp_sum(v);
  if constexpr (GW == 1) {
    return v;
  } else {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) partial[warp] = v;
    __syncthreads();
    T r = T(0);
    if (warp == 0) {
      r = lane < kWarps ? partial[lane] : T(0);
      r = warp_sum(r);
    }
    return r;
  }
}

// Where a tile of VEC consecutive sites of one row, starting at site i0,
// finds its neighbours. NX is the row width if known at compile time (a
// power of two: the division becomes a shift), else 0 and nx is used.
template <int NX, int VEC>
struct Tile {
  int row, up, down;    // offsets of rows t, t+1 and t-1
  int s0, right, left;  // first column; the column after the tile, before it
  __device__ __forceinline__ Tile(int i0, int nt, int nx) {
    const int w = NX ? NX : nx;
    const int t = static_cast<int>(static_cast<unsigned>(i0) /
                                   static_cast<unsigned>(w));
    row = t * w;
    s0 = i0 - row;
    up = (t + 1 == nt ? 0 : t + 1) * w;
    down = (t == 0 ? nt - 1 : t - 1) * w;
    right = (s0 + VEC == w) ? 0 : s0 + VEC;
    left = (s0 == 0) ? w - 1 : s0 - 1;
  }
};

// W at the tile's sites, for a chain whose [u | v] links lie at a, a + V.
template <typename T, int NX, int VEC>
__device__ __forceinline__ void plaquettes(const T* a, int V, int i0,
                                           const Tile<NX, VEC>& g,
                                           T (&w)[VEC]) {
  const Pack<T, VEC> u = load_pack<T, VEC>(a + i0);
  const Pack<T, VEC> v = load_pack<T, VEC>(a + V + i0);
  const Pack<T, VEC> v_up = load_pack<T, VEC>(a + V + g.up + g.s0);
  const T u_right = a[g.row + g.right];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const T r = (j + 1 < VEC) ? u.v[j + 1 < VEC ? j + 1 : j] : u_right;
    w[j] = u.v[j] + v_up.v[j] - r - v.v[j];
  }
}

// beta * A^T y at the tile's sites: out_u = beta (y - y[x-1]),
// out_v = beta (y[t-1] - y).
template <typename T, int NX, int VEC>
__device__ __forceinline__ void adjoint(const T* y, int i0,
                                        const Tile<NX, VEC>& g, T beta,
                                        Pack<T, VEC>* out_u,
                                        Pack<T, VEC>* out_v) {
  const Pack<T, VEC> here = load_pack<T, VEC>(y + i0);
  const Pack<T, VEC> below = load_pack<T, VEC>(y + g.down + g.s0);
  const T y_left = y[g.row + g.left];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const T l = j ? here.v[j ? j - 1 : 0] : y_left;
    out_u->v[j] = beta * (here.v[j] - l);
    out_v->v[j] = beta * (below.v[j] - here.v[j]);
  }
}

// One chain's operands (a, and b unless it is null) into a stage: the bulk
// copies of the group's first thread ...
template <typename T>
__device__ __forceinline__ void fetch_chain(T* stage, uint64_t* bar,
                                            const T* a, const T* b,
                                            size_t offset, int elems) {
  const uint32_t bytes = static_cast<uint32_t>(elems * sizeof(T));
  hopper::mbar_arrive_expect_tx(bar, b ? 2 * bytes : bytes);
  hopper::bulk_load(stage, a + offset, bytes, bar);
  if (b) hopper::bulk_load(stage + elems, b + offset, bytes, bar);
}

// ... or the ordinary loads of the whole group.
template <typename T, int GW>
__device__ __forceinline__ void copy_chain(T* stage, const T* a, const T* b,
                                           size_t offset, int elems) {
  for (int i = Group<GW>::tid(); i < elems; i += Group<GW>::kSize) {
    stage[i] = a[offset + i];
    if (b) stage[elems + i] = b[offset + i];
  }
}

// The persistent loop of one group over its chains. `chain.first(stage,
// scratch)` reads the staged operands ([a | b], elems values each) and may
// write `scratch` (elems / 2 values); `chain.second(scratch, c)` reads
// scratch only, so the stage is refilled between the two.
template <typename T, int GW, typename Chain>
__device__ __forceinline__ void stream_chains(const T* a, const T* b, int nb,
                                              int elems, int stages,
                                              bool bulk, Chain& chain) {
  using G = Group<GW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[G::kPerBlock * kMaxStages];
  const size_t stage_elems = static_cast<size_t>(b ? 2 : 1) * elems;
  const size_t group_bytes =
      align16((stages * stage_elems + elems / 2) * sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw + G::in_block() * group_bytes);
  T* scratch = ring + stages * stage_elems;
  uint64_t* bar = bars + G::in_block() * kMaxStages;
  const size_t group = static_cast<size_t>(blockIdx.x) * G::kPerBlock +
                       G::in_block();
  const size_t ngroups = static_cast<size_t>(gridDim.x) * G::kPerBlock;
  const size_t nchains = static_cast<size_t>(nb);
  const bool leader = G::tid() == 0;

  if (bulk) {
    if (leader) {
      for (int s = 0; s < stages; ++s) hopper::mbar_init(bar + s, 1);
      hopper::mbar_init_fence();
      for (int s = 0; s < stages; ++s) {
        const size_t c = group + s * ngroups;
        if (c < nchains) {
          fetch_chain(ring + s * stage_elems, bar + s, a, b, c * elems,
                      elems);
        }
      }
    }
    G::sync();
  }

  int k = 0;
  for (size_t c = group; c < nchains; c += ngroups, ++k) {
    const int s = bulk ? k % stages : 0;
    T* stage = ring + s * stage_elems;
    if (bulk) {
      hopper::mbar_wait(bar + s, static_cast<uint32_t>(k / stages) & 1u);
    } else {
      copy_chain<T, GW>(stage, a, b, c * elems, elems);
      G::sync();
    }
    chain.first(stage, scratch);
    G::sync();  // every read of the stage is done: refill it
    if (bulk && leader) {
      const size_t next = c + stages * ngroups;
      if (next < nchains) {
        fetch_chain(stage, bar + s, a, b, next * elems, elems);
      }
    }
    chain.second(scratch, c);
    G::sync();  // scratch is rewritten by the next chain's first pass
  }
}

template <typename T, int NX, int GW>
struct ForwardChain {
  static constexpr int kVec = NX ? 16 / sizeof(T) : 1;
  using G = Group<GW>;
  T* force;
  T* act;
  T* partial;
  T beta;
  int nt, nx, V;
  T local;

  // sin W into scratch, the thread's share of sum (1 - cos W) into local
  __device__ __forceinline__ void first(const T* sx, T* ssin) {
    local = T(0);
    for (int i0 = G::tid() * kVec; i0 < V; i0 += G::kSize * kVec) {
      const Tile<NX, kVec> g(i0, nt, nx);
      T w[kVec];
      plaquettes<T, NX, kVec>(sx, V, i0, g, w);
      Pack<T, kVec> sn;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        T cs;
        sincos_t(w[j], &sn.v[j], &cs);
        local += T(1) - cs;
      }
      store_pack<T, kVec>(ssin + i0, sn);
    }
  }

  __device__ __forceinline__ void second(const T* ssin, size_t c) {
    T* fb = force + c * 2 * V;
    for (int i0 = G::tid() * kVec; i0 < V; i0 += G::kSize * kVec) {
      const Tile<NX, kVec> g(i0, nt, nx);
      Pack<T, kVec> fu, fv;
      adjoint<T, NX, kVec>(ssin, i0, g, beta, &fu, &fv);
      store_pack<T, kVec>(fb + i0, fu);
      store_pack<T, kVec>(fb + V + i0, fv);
    }
    const T total = group_sum<T, GW>(local, partial);
    if (G::tid() == 0) act[c] = beta * total;
  }
};

template <typename T, int NX, int GW>
struct BackwardChain {
  static constexpr int kVec = NX ? 16 / sizeof(T) : 1;
  using G = Group<GW>;
  const T* g_act;  // null: no gS term, F is not read
  const T* force;
  T* x_bar;
  T beta;
  int nt, nx, V;

  // cos W * (A gF) into scratch; the stage holds [x | gF]
  __device__ __forceinline__ void first(const T* sxg, T* sy) {
    for (int i0 = G::tid() * kVec; i0 < V; i0 += G::kSize * kVec) {
      const Tile<NX, kVec> g(i0, nt, nx);
      T w[kVec], h[kVec];
      plaquettes<T, NX, kVec>(sxg, V, i0, g, w);
      plaquettes<T, NX, kVec>(sxg + 2 * V, V, i0, g, h);
      Pack<T, kVec> y;
#pragma unroll
      for (int j = 0; j < kVec; ++j) y.v[j] = cos_t(w[j]) * h[j];
      store_pack<T, kVec>(sy + i0, y);
    }
  }

  __device__ __forceinline__ void second(const T* sy, size_t c) {
    T* ob = x_bar + c * 2 * V;
    const T* fb = force + c * 2 * V;
    const T gs = g_act ? g_act[c] : T(0);
    for (int i0 = G::tid() * kVec; i0 < V; i0 += G::kSize * kVec) {
      const Tile<NX, kVec> g(i0, nt, nx);
      Pack<T, kVec> ou, ov;
      adjoint<T, NX, kVec>(sy, i0, g, beta, &ou, &ov);
      if (g_act) {
        const Pack<T, kVec> fu = load_pack<T, kVec>(fb + i0);
        const Pack<T, kVec> fv = load_pack<T, kVec>(fb + V + i0);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          ou.v[j] += gs * fu.v[j];
          ov.v[j] += gs * fv.v[j];
        }
      }
      store_pack<T, kVec>(ob + i0, ou);
      store_pack<T, kVec>(ob + V + i0, ov);
    }
  }
};

template <typename T, int NX, int GW>
__global__ void __launch_bounds__(kThreads)
u1_force_fwd_kernel(const T* __restrict__ x, T* __restrict__ force,
                    T* __restrict__ act, const T* __restrict__ beta, int nb,
                    int nt, int nx, int stages, int bulk) {
  __shared__ T partial[kWarps];
  const int V = nt * (NX ? NX : nx);
  ForwardChain<T, NX, GW> chain{force, act, partial, __ldg(beta),
                                nt,    nx,  V,       T(0)};
  stream_chains<T, GW>(x, static_cast<const T*>(nullptr), nb, 2 * V, stages,
                       bulk != 0, chain);
}

template <typename T, int NX, int GW>
__global__ void __launch_bounds__(kThreads)
u1_force_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g_force,
                    const T* __restrict__ g_act,
                    const T* __restrict__ force, T* __restrict__ x_bar,
                    const T* __restrict__ beta, int nb, int nt, int nx,
                    int stages, int bulk) {
  const int V = nt * (NX ? NX : nx);
  BackwardChain<T, NX, GW> chain{g_act, force, x_bar, __ldg(beta),
                                 nt,    nx,    V};
  stream_chains<T, GW>(x, g_force, nb, 2 * V, stages, bulk != 0, chain);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

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

// How many blocks of `fn` the device holds at once with `smem` bytes of
// dynamic shared memory each. The first call for a (kernel, device, size)
// opts the kernel in to the device's full shared memory and asks the
// runtime; later calls read the answer back.
struct Residency {
  const void* fn;
  int device;
  size_t smem;
  int blocks;
};
std::mutex g_residency_mutex;
std::vector<Residency> g_residency;

cudaError_t resident_blocks(const void* fn, int device, size_t smem,
                            int* blocks) {
  std::lock_guard<std::mutex> lock(g_residency_mutex);
  for (const Residency& r : g_residency) {
    if (r.fn == fn && r.device == device && r.smem == smem) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
  }
  cudaFuncAttributes attr;
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attr.sharedSizeBytes));
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  g_residency.push_back({fn, device, smem, *blocks});
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Group width, ring depth and shared memory for chains of V sites whose
// stage holds `operands` tensors of 2 V values.
struct Layout {
  int group_warps;
  int stages;
  size_t smem;
};

Layout choose_layout(size_t V, size_t elem, int operands, bool bulk) {
  Layout l;
  l.group_warps = (V * elem <= kWarpChainBytes) ? 1 : kWarps;
  const size_t groups = kWarps / l.group_warps;
  const size_t stage = operands * 2 * V * elem, scratch = V * elem;
  l.stages = 1;
  for (int s = kMaxStages; bulk && s > 1; --s) {
    if (groups * align16(s * stage + scratch) <= kRingBudget) {
      l.stages = s;
      break;
    }
  }
  l.smem = groups * align16(l.stages * stage + scratch);
  return l;
}

// The kernels as untyped entry points, for cudaLaunchKernel and the
// occupancy query.
template <typename T, int NX, int GW>
struct Fwd {
  static const void* entry() {
    return reinterpret_cast<const void*>(&u1_force_fwd_kernel<T, NX, GW>);
  }
};
template <typename T, int NX, int GW>
struct Bwd {
  static const void* entry() {
    return reinterpret_cast<const void*>(&u1_force_bwd_kernel<T, NX, GW>);
  }
};

template <template <typename, int, int> class Kernel, typename T, int NX>
const void* pick_group(int group_warps) {
  return group_warps == 1 ? Kernel<T, NX, 1>::entry()
                          : Kernel<T, NX, kWarps>::entry();
}

// nx as the kernels' template argument: itself for 16, 32, 64 when every
// pointer allows 16-byte accesses, else 0 (runtime nx, one site a thread).
template <template <typename, int, int> class Kernel, typename T>
const void* pick_kernel(int nx, bool vector, int group_warps) {
  if (vector) {
    switch (nx) {
      case 16: return pick_group<Kernel, T, 16>(group_warps);
      case 32: return pick_group<Kernel, T, 32>(group_warps);
      case 64: return pick_group<Kernel, T, 64>(group_warps);
      default: break;
    }
  }
  return pick_group<Kernel, T, 0>(group_warps);
}

// Everything a launch needs besides the tensors.
struct Plan {
  const void* fn = nullptr;
  int grid = 0;
  size_t smem = 0;
  int stages = 1;  // kernel argument
  int bulk = 0;    // kernel argument
};

// `aligned`: every pointer the kernel touches is a multiple of 16 bytes.
// `operands`: tensors of 2 V values a stage holds. `device` is current.
template <template <typename, int, int> class Kernel, typename T>
cudaError_t make_plan(bool aligned, int nb, int nt, int nx, int operands,
                      int device, Plan* plan) {
  const size_t V = static_cast<size_t>(nt) * nx;
  const bool bulk = aligned && (2 * V * sizeof(T)) % 16 == 0;
  const Layout l = choose_layout(V, sizeof(T), operands, bulk);
  plan->fn = pick_kernel<Kernel, T>(nx, aligned, l.group_warps);
  plan->smem = l.smem;
  plan->stages = l.stages;
  plan->bulk = bulk ? 1 : 0;
  int resident = 0;
  const cudaError_t err = resident_blocks(plan->fn, device, l.smem, &resident);
  if (err != cudaSuccess) return err;
  const int per_block = kWarps / l.group_warps;
  const int wanted = (nb + per_block - 1) / per_block;
  plan->grid = wanted < resident ? wanted : resident;
  return cudaSuccess;
}

int run(const Plan& plan, void** args, void* stream) {
  const cudaError_t err =
      cudaLaunchKernel(plan.fn, dim3(plan.grid), dim3(kThreads), args,
                       plan.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, void* force, void* act, const void* beta,
               int nb, int nt, int nx, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  Plan plan;
  const cudaError_t err = make_plan<Fwd, T>(
      aligned16(x) && aligned16(force), nb, nt, nx, 1, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&x,  &force, &act,         &beta,     &nb,
                  &nt, &nx,    &plan.stages, &plan.bulk};
  return run(plan, args, stream);
}

template <typename T>
int launch_bwd(const void* x, const void* g_force, const void* g_act,
               const void* force, void* x_bar, const void* beta, int nb,
               int nt, int nx, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const bool aligned = aligned16(x) && aligned16(g_force) &&
                       aligned16(x_bar) && (!g_act || aligned16(force));
  Plan plan;
  const cudaError_t err =
      make_plan<Bwd, T>(aligned, nb, nt, nx, 2, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&x,  &g_force, &g_act, &force,       &x_bar,    &beta,
                  &nb, &nt,      &nx,    &plan.stages, &plan.bulk};
  return run(plan, args, stream);
}

}  // namespace

extern "C" {

int u1_force_fwd_f32(const void* x, void* force, void* act, const void* beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_fwd<float>(x, force, act, beta, nb, nt, nx, device, stream);
}

int u1_force_fwd_f64(const void* x, void* force, void* act, const void* beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_fwd<double>(x, force, act, beta, nb, nt, nx, device, stream);
}

// g_act may be null: the gS * F term is then left out and force is not read.
int u1_force_bwd_f32(const void* x, const void* g_force, const void* g_act,
                     const void* force, void* x_bar, const void* beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_bwd<float>(x, g_force, g_act, force, x_bar, beta, nb, nt, nx,
                           device, stream);
}

int u1_force_bwd_f64(const void* x, const void* g_force, const void* g_act,
                     const void* force, void* x_bar, const void* beta,
                     int nb, int nt, int nx, int device, void* stream) {
  return launch_bwd<double>(x, g_force, g_act, force, x_bar, beta, nb, nt,
                            nx, device, stream);
}

const char* u1_force_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
