// Host stand-in for <cuda_runtime.h> that runs the port's CUDA kernels
// (abismal_tpu_torch/csrc/*.cu, compiled as C++ by
// tests/test_torch_emulated_kernels.py) on the CPU, one warp at a time.
//
// The 32 lanes of a warp are ucontext fibres run round-robin; every
// warp-synchronous primitive (__shfl_*_sync, __ballot_sync, __any_sync,
// __reduce_*_sync, __syncwarp) is a rendezvous: a lane publishes its value
// and yields, and resumes once every live lane has reached the same point.
// Values are exchanged through two buffers in turn, as no lane can be more
// than one rendezvous ahead of another.  The run aborts if the lanes of a
// warp do not agree on the sequence of rendezvous, which on the card would
// be a hang or undefined.  Blocks and the warps of a block run one after
// the other, so kernels must not use __syncthreads (it is not defined
// here).  Dynamic shared memory is one static buffer, poisoned before each
// warp so that a read of a byte the warp did not write shows.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__

using std::max;
using std::min;

struct dim3s {
  unsigned x;
};
static dim3s threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class T>
cudaError_t cudaFuncSetAttribute(T*, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}

namespace emu {

constexpr size_t SHARED_BYTES = 232448;  // 227 KB, a block's most on sm_90
alignas(16) static unsigned char shared[SHARED_BYTES];
constexpr size_t STACK = 1 << 18;

static ucontext_t mainctx, ctx[32];
static bool done[32];
static int cur;       // the lane that runs
static int gen[32];   // rendezvous each lane has passed
static int xbuf[2][32];
static std::function<void()> body;

inline int lane() { return cur; }
// publishes v, and returns when every live lane has published its own
inline void rendezvous(int v) {
  xbuf[gen[cur] & 1][cur] = v;
  swapcontext(&ctx[cur], &mainctx);
}
inline int peek(int src) { return xbuf[gen[cur] & 1][src]; }
inline void passed() { ++gen[cur]; }

static void entry() {
  body();
  done[cur] = true;
  swapcontext(&ctx[cur], &mainctx);
}

inline void run_warp(unsigned block, unsigned warp, unsigned bdim) {
  static char* stacks = static_cast<char*>(malloc(32 * STACK));
  std::memset(shared, 0xA5, SHARED_BYTES);
  for (int l = 0; l < 32; ++l) {
    done[l] = false;
    gen[l] = 0;
    getcontext(&ctx[l]);
    ctx[l].uc_stack.ss_sp = stacks + l * STACK;
    ctx[l].uc_stack.ss_size = STACK;
    ctx[l].uc_link = &mainctx;
    makecontext(&ctx[l], entry, 0);
  }
  for (;;) {
    int alive = 0, g0 = -1;
    for (int l = 0; l < 32; ++l) {
      if (done[l]) continue;
      ++alive;
      cur = l;
      blockIdx.x = block;
      blockDim.x = bdim;
      threadIdx.x = warp * 32 + l;
      swapcontext(&mainctx, &ctx[l]);
    }
    if (!alive) break;
    for (int l = 0; l < 32; ++l) {
      if (done[l]) continue;
      if (g0 < 0) g0 = gen[l];
      if (gen[l] != g0) abort();  // lanes disagree on their rendezvous
    }
  }
}

// kernel<<<grid, block, ...>>>(args) becomes launch(grid, block, [&] {
// kernel(args); })
template <class F>
void launch(unsigned grid, unsigned block, F f) {
  body = f;
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned w = 0; w < (block + 31) / 32; ++w) run_warp(b, w, block);
}

}  // namespace emu

inline int __shfl_sync(unsigned, int v, int src, int w = 32) {
  emu::rendezvous(v);
  const int r = emu::peek(emu::lane() / w * w + src % w);
  emu::passed();
  return r;
}
inline int __shfl_down_sync(unsigned, int v, int d, int w = 32) {
  emu::rendezvous(v);
  const int l = emu::lane();
  const int r = l % w + d < w ? emu::peek(l + d) : v;
  emu::passed();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d, int w = 32) {
  emu::rendezvous(v);
  const int l = emu::lane();
  const int r = l % w - d >= 0 ? emu::peek(l - d) : v;
  emu::passed();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int m, int = 32) {
  emu::rendezvous(v);
  const int r = emu::peek(emu::lane() ^ m);
  emu::passed();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  emu::rendezvous(p);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (!emu::done[i] && emu::peek(i)) r |= 1u << i;
  emu::passed();
  return r;
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline int __reduce_max_sync(unsigned, int v) {
  emu::rendezvous(v);
  int r = v;
  for (int i = 0; i < 32; ++i)
    if (!emu::done[i]) r = max(r, emu::peek(i));
  emu::passed();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  emu::rendezvous(v);
  int r = v;
  for (int i = 0; i < 32; ++i)
    if (!emu::done[i]) r = min(r, emu::peek(i));
  emu::passed();
  return r;
}
inline void __syncwarp() {
  emu::rendezvous(0);
  emu::passed();
}

inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  return static_cast<uint32_t>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> (s & 31));
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
