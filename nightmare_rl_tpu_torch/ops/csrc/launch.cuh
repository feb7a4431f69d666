// What the kernels share at launch: the raise of a kernel's dynamic shared
// memory above 48 KB, a warp as smooth_env.cuh's team (with timer stamps,
// for a kernel built with a timeline), and a block as rollout_env.cuh's.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace common {

constexpr int kLanes = 32;

// A warp as smooth_env's team: lane i is member i.
struct WarpTeam {
  __host__ __device__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x & (kLanes - 1);
#else
    return 0;
#endif
  }
  __host__ __device__ int size() const { return kLanes; }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  __host__ __device__ bool any(bool p) const {
#ifdef __CUDA_ARCH__
    return __any_sync(0xffffffffu, p) != 0;
#else
    return p;
#endif
  }
  __host__ __device__ void stamp(int) const {}
};

// The team of a kernel built with a timeline: lane 0 of the warp of each of
// the first Envs envs writes the card's global timer (ns) at stamp k into
// row `env` of a device array of Stamps columns, and the SM's cycle
// counter into the same place of the array's second half (Envs rows more).
template <int Stamps, int Envs>
struct StampedWarpTeam : WarpTeam {
  long long* timeline;
  int env;
  __host__ __device__ void stamp(int k) const {
#ifdef __CUDA_ARCH__
    if ((threadIdx.x & (kLanes - 1)) == 0 && env < Envs) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      const long long at = static_cast<long long>(env) * Stamps + k;
      timeline[at] = t;
      timeline[static_cast<long long>(Envs) * Stamps + at] = clock64();
    }
#else
    (void)k;
#endif
  }
};

// A block as rollout_env's team (and learn_env's): thread i is member i,
// with copies from global to shared memory by cp.async.
struct BlockTeam {
  __host__ __device__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  __host__ __device__ int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  // an element from global to shared memory, asynchronously (cp.async)
  template <typename T>
  __host__ __device__ void copy(T* dst, const T* src) const {
#ifdef __CUDA_ARCH__
    __pipeline_memcpy_async(dst, src, sizeof(T));
#else
    *dst = *src;
#endif
  }
  // N consecutive elements (4, 8 or 16 bytes, aligned to their size)
  template <int N, typename T>
  __host__ __device__ void copy_n(T* dst, const T* src) const {
#ifdef __CUDA_ARCH__
    __pipeline_memcpy_async(dst, src, N * sizeof(T));
#else
    for (int u = 0; u < N; ++u) dst[u] = src[u];
#endif
  }
  __host__ __device__ void copy_wait() const {
#ifdef __CUDA_ARCH__
    __pipeline_commit();
    __pipeline_wait_prior(0);
#endif
  }
  __host__ __device__ void stamp(int) const {}
};

// The block team of a kernel built with a timeline: thread 0 of each of the
// first Blocks blocks writes the card's global timer (ns) at stamp k into
// row `blk` of a device array of Stamps columns, and the SM's cycle counter
// into the same place of the array's second half (Blocks rows more).
template <int Stamps, int Blocks>
struct StampedBlockTeam : BlockTeam {
  long long* timeline;
  int blk;
  __host__ __device__ void stamp(int k) const {
#ifdef __CUDA_ARCH__
    if (threadIdx.x == 0 && blk < Blocks) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      const long long at = static_cast<long long>(blk) * Stamps + k;
      timeline[at] = t;
      timeline[static_cast<long long>(Blocks) * Stamps + at] = clock64();
    }
#else
    (void)k;
#endif
  }
};

// The dynamic shared memory a kernel may take above 48 KB is raised with
// cudaFuncSetAttribute at the first launch that needs more, once per kernel
// and device, and not again.  So a launch that a CUDA graph captures (after
// an eager warm-up) is the kernel launch alone, and every replay finds the
// attribute set on the function.
inline cudaError_t allow_smem(const void* kernel, int smem) {
  struct Allowed {
    const void* kernel;
    int device;
    int smem;
  };
  static std::mutex mu;
  static std::vector<Allowed> allowed;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Allowed* hit = nullptr;
  for (Allowed& al : allowed)
    if (al.kernel == kernel && al.device == device) hit = &al;
  if (hit != nullptr && smem <= hit->smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  if (hit != nullptr)
    hit->smem = smem;
  else
    allowed.push_back({kernel, device, smem});
  return cudaSuccess;
}

}  // namespace common
