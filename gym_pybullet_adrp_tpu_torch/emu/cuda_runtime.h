// A stub of the CUDA runtime for compiling the hover kernels' sources
// with g++ (hover_emulate.py): the subset they use, with each CUDA
// thread a host thread (emu_rt.cpp). Not a CUDA implementation: it gives
// no guarantee beyond what these sources need.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <functional>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
extern thread_local dim3 threadIdx, blockIdx, blockDim;

struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

// v of lane (lane & ~(width - 1)) + (src & (width - 1)) of this warp;
// every lane of the warp calls it, as on the card
float __shfl_sync(unsigned mask, float v, int src, int width = 32);

// runs fn on `blocks` x `threads` host threads, one block after another;
// the launch syntax `k<<<blocks, threads, ...>>>(args)` is rewritten to
// emu_launch(blocks, threads, [&] { k(args); })
void emu_launch(unsigned blocks, unsigned threads, std::function<void()> fn);
