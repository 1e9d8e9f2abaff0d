// Host-side launch settings kept once a device: a kernel's dynamic
// shared-memory limit (cudaFuncSetAttribute applies to the current device
// only) and the blocks or clusters a card holds at once. Each table is
// keyed by the current device and a caller's key, and guarded by a mutex,
// so the kernels run on any card of the host and from any host thread.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace devcache {

// The value make(device, &value) computes for the current device and
// `key`, computed on the first call and kept; TAG (a kernel) gives each
// caller its own table. Returns a cudaError_t, 0 on success; a failed
// make() is not kept.
template <auto TAG, typename Make>
int once(long long key, int* value, Make make) {
  static std::mutex mu;
  static std::map<std::pair<int, long long>, int> table;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto k = std::make_pair(dev, key);
  auto it = table.find(k);
  if (it == table.end()) {
    int v = 0;
    err = make(dev, &v);
    if (err != cudaSuccess) return (int)err;
    it = table.emplace(k, v).first;
  }
  *value = it->second;
  return 0;
}

// Allow KERN at least `smem` bytes of dynamic shared memory on the current
// device. The limit is one value a kernel and device, so it only grows: a
// launch with less shared memory than an earlier one keeps the larger
// limit.
template <auto KERN>
int set_smem(size_t smem) {
  static std::mutex mu;
  static std::map<int, size_t> limit;      // device -> the limit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = limit.find(dev);
  if (it != limit.end() && it->second >= smem) return 0;
  err = cudaFuncSetAttribute(
      KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  limit[dev] = smem;
  return 0;
}

// Blocks of KERN (`threads` each, `smem` bytes of dynamic shared memory)
// the current device holds at once, at least 1; set_smem first.
template <auto KERN>
int resident_blocks(int threads, size_t smem, int* blocks) {
  return once<KERN>(((long long)smem << 16) | threads, blocks,
                    [threads, smem](int dev, int* v) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERN,
                                                          threads, smem);
    *v = sms * (per_sm > 0 ? per_sm : 1);
    return err;
  });
}

}  // namespace devcache
