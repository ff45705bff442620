// Host-side launch helpers that every kernel source of this directory
// includes.  ops/_cuda.py hashes the headers here with each source, so an
// edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssad {

constexpr int kMaxDevices = 64;

// runs fn on `device`, restoring the caller's current device afterwards
template <typename Fn>
int on_device(int device, Fn fn) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  const int status = fn();
  if (cur != device) cudaSetDevice(cur);
  return status;
}

inline int sm_count(int device, int* sms) {
  static int cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *sms = cached[device];
    return 0;
  }
  const cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device >= 0 && device < kMaxDevices) cached[device] = *sms;
  return (int)e;
}

// resident blocks of `kernel` (`threads` a block, no dynamic shared memory)
// on the whole card; `cached` holds its blocks per SM by device (one array
// per kernel: the callers' statics)
template <typename K>
int resident_blocks(K kernel, int threads, int device, long long* blocks,
                    int (&cached)[kMaxDevices]) {
  int per_sm = device >= 0 && device < kMaxDevices ? cached[device] : 0;
  if (per_sm == 0) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    if (device >= 0 && device < kMaxDevices) cached[device] = per_sm;
  }
  int sms = 0;
  const int e = sm_count(device, &sms);
  *blocks = (long long)per_sm * sms;
  return e;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace ssad
