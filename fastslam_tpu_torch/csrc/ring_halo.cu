// Ring halo exchange of the distributed resampler, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/parallel/ring_resample.py:60-110 (ring_halo_exchange,
// body _exchange_kernel): every shard s of a ring of S shards sends its packed
// particle block (P_local x D float32, D = 3 + 1 + 2L + 4L + 1) to both ring
// neighbours, so that shard s receives left_s = block_{s-1} and
// right_s = block_{s+1}, indices mod S.  The TPU kernel is one remote-DMA
// kernel per chip: a neighbour barrier on a semaphore, then both DMAs (clockwise
// into the right neighbour's left buffer, counter-clockwise into the left
// neighbour's right buffer) started before either is waited on.  Two forms:
//
// ring_halo_exchange_launch: a ring whose shards all lie in one process, on
// one card.  One launch moves the whole ring.  The grid is (element tiles, S
// shards); each thread loads 16 bytes of its shard's block once and stores
// them twice, into left_{s+1} and right_{s-1}, so both directions are in
// flight together and each source byte is read once.  A block is a flat
// array of n = P_local * D floats; the float4 body covers the first
// 4 * (n / 4) of them and the first grid column copies the scalar tail.  The
// 3S block pointers travel by value in the parameter struct (at most
// RING_MAX_SHARDS shards).  S = 1 copies the block into both of its own
// buffers; S = 2 writes the other shard's block into two distinct buffers.
// Wrapped neighbours (shard 0's left is shard S - 1) are moved like any
// other: the resampler's window test rejects their indices.  Stream order
// stands in for the TPU kernel's neighbour barrier: the blocks are written
// before the launch on the same stream, and the buffers are read after it.
//
// ring_halo_exchange_peers_launch: a ring over the processes of a group, each
// holding S_local consecutive shards (global shard g = rank * S_local + k).
// One launch per process per call.  Every process owns one cudaMalloc
// allocation (ring_peers_alloc): a 256-byte flag region of 64-bit words
// (PeerFlag), then the left and right receive buffer of each local shard.  Its
// CUDA IPC handle is all-gathered once, and each process maps its neighbour
// processes' allocations (ring_peers_open, cudaIpcMemLazyEnablePeerAccess: on
// another card of the host the same handle gives a peer pointer).  A call at
// epoch e (1, 2, ...: the flags start at 0):
//   1. the barrier, in place of the TPU kernel's barrier semaphore: every
//      block stores ready = e into both neighbour processes' flags (the same
//      value from every block, so the stores are idempotent and no block
//      waits for another block of its own grid), with system-scope release
//      stores; then it waits until its own ready words from both neighbours
//      reach e, with system-scope acquire loads.  A neighbour that has
//      entered call e has finished reading its halos of call e - 1 (stream
//      order), so no write below overruns a buffer still being read;
//   2. the copy: each 16-byte value of each local block is loaded once and
//      stored twice, into the left buffer of shard g + 1 and the right buffer
//      of shard g - 1, through a local pointer or a mapped one; the grid is a
//      few blocks per SM over a grid-stride loop;
//   3. completion, in place of the DMA receive semaphores: each block fences
//      its stores at system scope and counts itself done; the last block
//      stores delivered = e into both neighbour processes' flags and waits
//      until its own delivered words reach e.  So the kernel ends when this
//      process's halos are in place, and stream order after it reads them.
// Every wait is bounded by %globaltimer (timeout_ns) and sleeps between
// polls; a wait that times out writes the error word (PEER_ERROR) and its
// block returns, so the kernel ends and the wrapper raises.  Without MPS the
// card time-slices the processes' contexts, so a block spinning on a
// neighbour's flag waits for that neighbour's next time slice: a call across
// processes is paced by context switches, not by bytes.
//
// What bounds both on an H100: the bytes.  The ring reads S * n * 4 bytes and
// writes twice that; at P = 100,000, L = 64 (S * n = 38.9M floats) that is 467
// MB, 0.139 ms at 3.35 TB/s.  They do no arithmetic.  The 16-byte loads and
// stores, coalesced across the warp, are what the design does about it.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int RING_MAX_SHARDS = 64;
constexpr int RING_THREADS = 256;
constexpr long long RING_MAX_TILES = 1 << 20;   // grid-stride beyond this

struct RingBlocks {
  const float* src[RING_MAX_SHARDS];
  float* left[RING_MAX_SHARDS];
  float* right[RING_MAX_SHARDS];
};

__global__ void __launch_bounds__(RING_THREADS)
ring_halo_kernel(const RingBlocks blocks, const int S, const long long n) {
  const int s = blockIdx.y;
  // my block is the left halo of shard s + 1 and the right halo of shard s - 1
  const int to_left = s + 1 == S ? 0 : s + 1;
  const int to_right = s == 0 ? S - 1 : s - 1;
  const float* src = blocks.src[s];
  float* left = blocks.left[to_left];
  float* right = blocks.right[to_right];

  const long long n4 = n / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* left4 = reinterpret_cast<float4*>(left);
  float4* right4 = reinterpret_cast<float4*>(right);
  const long long stride = static_cast<long long>(gridDim.x) * RING_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * RING_THREADS + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = __ldg(src4 + i);
    left4[i] = v;
    right4[i] = v;
  }
  if (blockIdx.x == 0) {
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += RING_THREADS) {
      const float v = src[i];
      left[i] = v;
      right[i] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// the cross-process form
// ---------------------------------------------------------------------------

constexpr int PEER_THREADS = 256;
constexpr int PEER_BLOCKS_PER_SM = 4;

// the 64-bit words of a process's flag region (core/cuda_kernels.py PEER_FLAGS)
enum PeerFlag : int {
  PEER_READY_FROM_LEFT = 0,       // the left neighbour process entered call e
  PEER_READY_FROM_RIGHT = 1,      // the right one did
  PEER_DELIVERED_FROM_LEFT = 2,   // the left one's block is in my first shard's left buffer
  PEER_DELIVERED_FROM_RIGHT = 3,  // the right one's is in my last shard's right buffer
  PEER_BLOCKS_DONE = 4,           // blocks of the running call that finished their copy
  PEER_ERROR = 5,                 // (epoch << 2) | wait that timed out (1 ready, 2 delivered)
};

struct PeerRingArgs {
  const float* src[RING_MAX_SHARDS];
  float* to_left[RING_MAX_SHARDS];   // the left buffer of shard g + 1 (mapped if remote)
  float* to_right[RING_MAX_SHARDS];  // the right buffer of shard g - 1
  // my words in the neighbours' flag regions: ready into the right process
  // (its PEER_READY_FROM_LEFT), ready into the left one, delivered likewise
  unsigned long long* ready_right;
  unsigned long long* ready_left;
  unsigned long long* delivered_right;
  unsigned long long* delivered_left;
  unsigned long long* flags;          // my own flag region
};

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Spins until flags[a] and flags[b] reach epoch (a neighbour may already be
// one call ahead); false once timeout_ns have passed.
__device__ bool wait_for_epoch(const unsigned long long* flags, int a, int b,
                               unsigned long long epoch, unsigned long long timeout_ns) {
  const unsigned long long start = global_timer_ns();
  unsigned sleep_ns = 32;
  while (load_acquire_sys(flags + a) < epoch || load_acquire_sys(flags + b) < epoch) {
    if (global_timer_ns() - start > timeout_ns) return false;
    __nanosleep(sleep_ns);
    if (sleep_ns < 2048) sleep_ns *= 2;
  }
  return true;
}

__device__ void peer_fail(unsigned long long* flags, unsigned long long epoch, int which) {
  atomicCAS(flags + PEER_ERROR, 0ull, (epoch << 2) | static_cast<unsigned long long>(which));
}

__global__ void __launch_bounds__(PEER_THREADS)
ring_halo_peers_kernel(const PeerRingArgs ring, const int S, const long long n,
                       const unsigned long long epoch, const unsigned long long timeout_ns) {
  __shared__ int ready;
  if (threadIdx.x == 0) {
    store_release_sys(ring.ready_right, epoch);
    store_release_sys(ring.ready_left, epoch);
    ready = wait_for_epoch(ring.flags, PEER_READY_FROM_LEFT, PEER_READY_FROM_RIGHT, epoch,
                           timeout_ns);
    if (!ready) peer_fail(ring.flags, epoch, 1);
  }
  __syncthreads();
  if (!ready) return;

  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * PEER_THREADS;
  for (int k = 0; k < S; ++k) {
    const float4* src4 = reinterpret_cast<const float4*>(ring.src[k]);
    float4* left4 = reinterpret_cast<float4*>(ring.to_left[k]);
    float4* right4 = reinterpret_cast<float4*>(ring.to_right[k]);
    long long i = static_cast<long long>(blockIdx.x) * PEER_THREADS + threadIdx.x;
    for (; i + stride < n4; i += 2 * stride) {   // two loads in flight per thread
      const float4 a = __ldg(src4 + i);
      const float4 b = __ldg(src4 + i + stride);
      left4[i] = a;
      right4[i] = a;
      left4[i + stride] = b;
      right4[i + stride] = b;
    }
    if (i < n4) {
      const float4 a = __ldg(src4 + i);
      left4[i] = a;
      right4[i] = a;
    }
    if (blockIdx.x == gridDim.x - 1) {
      for (long long j = 4 * n4 + threadIdx.x; j < n; j += PEER_THREADS) {
        const float v = ring.src[k][j];
        ring.to_left[k][j] = v;
        ring.to_right[k][j] = v;
      }
    }
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();   // this block's stores reach the receivers first
    unsigned long long* done = ring.flags + PEER_BLOCKS_DONE;
    if (atomicAdd(done, 1ull) == gridDim.x - 1) {   // the last block
      *done = 0;                                     // for the next call (stream order)
      __threadfence_system();
      store_release_sys(ring.delivered_right, epoch);
      store_release_sys(ring.delivered_left, epoch);
      if (!wait_for_epoch(ring.flags, PEER_DELIVERED_FROM_LEFT, PEER_DELIVERED_FROM_RIGHT, epoch,
                          timeout_ns))
        peer_fail(ring.flags, epoch, 2);
    }
  }
}

}  // namespace

extern "C" {

// src, left, right: host arrays of S device pointers, each to a block of n
// floats aligned to 16 bytes; left[s] and right[s] receive the blocks of
// shards s - 1 and s + 1 (mod S).  Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for S outside [1, RING_MAX_SHARDS].
int ring_halo_exchange_launch(int device, const float* const* src, float* const* left,
                              float* const* right, int S, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 1 || S > RING_MAX_SHARDS || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  RingBlocks blocks;
  for (int s = 0; s < S; ++s) {
    blocks.src[s] = src[s];
    blocks.left[s] = left[s];
    blocks.right[s] = right[s];
  }
  const long long n4 = n / 4;
  long long tiles = (n4 + RING_THREADS - 1) / RING_THREADS;
  if (tiles < 1) tiles = 1;                       // the tail alone
  if (tiles > RING_MAX_TILES) tiles = RING_MAX_TILES;
  const dim3 grid(static_cast<unsigned>(tiles), S);
  ring_halo_kernel<<<grid, RING_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, S, static_cast<long long>(n));
  return static_cast<int>(cudaGetLastError());
}

// The cross-process exchange: src, to_left and to_right are host arrays of S
// device pointers (this process's blocks of n floats, and the left buffer of
// shard g + 1 and the right buffer of shard g - 1 each block goes to, all
// aligned to 16 bytes); signal holds this process's four words in its
// neighbours' flag regions (ready right, ready left, delivered right,
// delivered left); flags is its own region.  epoch counts the calls from 1.
// Returns a cudaError_t; a timed-out wait shows in the error word only
// (ring_peers_error).
int ring_halo_exchange_peers_launch(int device, const float* const* src, float* const* to_left,
                                    float* const* to_right, unsigned long long* const* signal,
                                    unsigned long long* flags, int S, int n, long long epoch,
                                    long long timeout_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 1 || S > RING_MAX_SHARDS || n < 1 || epoch < 1 || timeout_ns < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PeerRingArgs ring;
  for (int s = 0; s < S; ++s) {
    ring.src[s] = src[s];
    ring.to_left[s] = to_left[s];
    ring.to_right[s] = to_right[s];
  }
  ring.ready_right = signal[0];
  ring.ready_left = signal[1];
  ring.delivered_right = signal[2];
  ring.delivered_left = signal[3];
  ring.flags = flags;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n / 4 + PEER_THREADS - 1) / PEER_THREADS;
  long long blocks = static_cast<long long>(sms) * PEER_BLOCKS_PER_SM;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;                     // the tail alone
  ring_halo_peers_kernel<<<static_cast<unsigned>(blocks), PEER_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ring, S, static_cast<long long>(n), static_cast<unsigned long long>(epoch),
      static_cast<unsigned long long>(timeout_ns));
  return static_cast<int>(cudaGetLastError());
}

// Set-up and teardown of a process's allocation for the cross-process ring.
// ring_peers_alloc: bytes of zeroed device memory at *ptr and its 64-byte
// IPC handle; ring_peers_open: a neighbour's allocation mapped at *ptr;
// ring_peers_close / ring_peers_free undo them.  Each returns a cudaError_t.
int ring_peers_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ptr = nullptr;
  err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (err != cudaSuccess && *ptr != nullptr) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(err);
}

int ring_peers_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ring_peers_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

int ring_peers_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFree(ptr));
}

// The error word of a flag region into *word, after the work queued on
// stream (the exchange) has finished.
int ring_peers_error(int device, const unsigned long long* flags, long long* word, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(word, flags + PEER_ERROR, sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}

}  // extern "C"
