// The host side of the CUDA stub (cuda_runtime.h): a block's threads run
// together as host threads; a warp's __shfl_sync is a store to the
// warp's slots between two barriers over its 32 threads.
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx, blockDim;

namespace {
struct Warp {
  std::barrier<> bar{32};
  float slot[32];
};
thread_local Warp* my_warp;
}  // namespace

float __shfl_sync(unsigned, float v, int src, int width) {
  const int lane = threadIdx.x % 32;
  my_warp->slot[lane] = v;
  my_warp->bar.arrive_and_wait();
  const float r = my_warp->slot[(lane & ~(width - 1)) + (src & (width - 1))];
  my_warp->bar.arrive_and_wait();
  return r;
}

void emu_launch(unsigned blocks, unsigned threads,
                std::function<void()> fn) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<Warp>> warps;
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warps.emplace_back(new Warp);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        my_warp = warps[t / 32].get();
        fn();
      });
    for (auto& t : ts) t.join();
  }
}
