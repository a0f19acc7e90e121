// Ceiling probes of the card, for Hopper (sm_90a): what it sustains for the
// memory stream, the on-chip stream and the FP32 FMA rate, measured with
// kernels shaped like the filter kernels' data (L x P float32 planes).
//
// hbm_copy_kernel replaces scripts/bench_hbm_floor.py:main's copy_kernel
// (pallas_call :47): out_i = in_i + 1 over the fused update's buffer set, six
// [L, P] planes and one [1, P] row.  What bounds it on an H100: the bytes.
// At L = 64, P = 100,000 it reads and writes 2 * (6 * 64 * 100,000 +
// 100,000) * 4 B = 308.0 MB, 0.0919 ms at 3.35 TB/s; the 50 MB L2 holds none
// of it between calls.  Design: one launch over all seven buffers, whose
// pointers travel by value in the parameter struct (as ring_halo.cu); the
// grid is (element tiles, buffer); 16-byte loads and stores, coalesced across
// the warp, and a scalar tail past the last float4.
//
// mul_add_kernel replaces scripts/bench_vpu_roofline.py:main's mul_add_kernel
// (pallas_call :112): c <- a * b + 0.9999 * c, `passes` times, over [L, tile]
// blocks of a, b and c.  The TPU probe measured a pass over blocks resident
// in VMEM, its on-chip memory; here the tiles are staged in shared memory,
// where particle tiles of the filter kernels would be staged, and every pass
// reads a, b and c there and writes c back (volatile accesses, so nvcc keeps
// none of them in registers and hoists no a * b).  What bounds it on an
// H100: the shared-memory stream, 4 accesses of 4 B per element and pass
// against 128 B per clock per SM; at L = 64, P = 100,000, 256 passes that is
// 26.2 GB, about 0.8 ms at 1.98 GHz on 132 SMs.  (The bare function moves
// 102.4 MB of device memory and does 2 flops per pass with a * b hoisted.)
// Design: one block of 1024 threads per [L, tile] tile (3 * L * tile * 4 B of
// dynamic shared memory, 192 KB at tile 256, so one block per SM); each
// thread owns the elements e = tid + 1024 k of the tile, so no barrier is
// needed between passes; columns past P are staged as zeros and not written.
// Built with -fmad=false, so a pass rounds like its plain version: two
// multiplies and an add.
//
// fma_chain_kernel replaces scripts/bench_vpu_roofline.py:main's
// fma_chain_kernel (pallas_call :115): x <- x * 1.0000001 + 1e-7, eight per
// pass, `passes` times, on values held in registers.  What bounds it on an
// H100: the FMA rate, 2 * 8 * passes * L * P flops (26.2 GFLOP at L = 64,
// P = 100,000, 256 passes), 0.391 ms at 67 TFLOP/s.  Design: the FMA is
// written as __fmaf_rn (the build's -fmad=false would otherwise split
// x * a + b into a multiply and an add, at half the rate); each thread
// carries FMA_CHAINS independent chains and the block is small enough for
// full occupancy, so the 4-cycle FMA latency is hidden.

#include <cuda_runtime.h>

namespace {

constexpr int COPY_BUFFERS = 7;
constexpr int COPY_THREADS = 256;
constexpr long long COPY_MAX_TILES = 1 << 20;   // grid-stride beyond this
constexpr int MUL_ADD_THREADS = 1024;
constexpr int SMEM_OPT_IN_LIMIT = 232448;       // 227 KB a block may opt into
constexpr int FMA_THREADS = 256;
constexpr int FMA_CHAINS = 4;                   // independent chains per thread

struct CopyBuffers {
  const float* in[COPY_BUFFERS];
  float* out[COPY_BUFFERS];
  long long n[COPY_BUFFERS];
};

__global__ void __launch_bounds__(COPY_THREADS)
hbm_copy_kernel(const CopyBuffers bufs) {
  const int k = blockIdx.y;
  const float* in = bufs.in[k];
  float* out = bufs.out[k];
  const long long n = bufs.n[k];
  const long long n4 = n / 4;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * COPY_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * COPY_THREADS + threadIdx.x;
       i < n4; i += stride) {
    float4 v = __ldg(in4 + i);
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    out4[i] = v;
  }
  if (blockIdx.x == 0) {
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += COPY_THREADS) {
      out[i] = in[i] + 1.0f;
    }
  }
}

__global__ void __launch_bounds__(MUL_ADD_THREADS)
mul_add_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, float* __restrict__ out, const int L,
               const int P, const int tile, const int passes) {
  extern __shared__ float smem[];
  const int n = L * tile;
  float* sa = smem;
  float* sb = smem + n;
  float* sc = smem + 2 * n;
  const int col0 = blockIdx.x * tile;
  const int width = min(tile, P - col0);
  for (int e = threadIdx.x; e < n; e += MUL_ADD_THREADS) {
    const int r = e / tile;
    const int j = e - r * tile;
    const long long g = static_cast<long long>(r) * P + col0 + j;
    const bool inside = j < width;
    sa[e] = inside ? a[g] : 0.0f;
    sb[e] = inside ? b[g] : 0.0f;
    sc[e] = inside ? c[g] : 0.0f;
  }
  // every thread reads and writes only its own elements: no barrier
  volatile float* va = sa;
  volatile float* vb = sb;
  volatile float* vc = sc;
  for (int p = 0; p < passes; ++p) {
    for (int e = threadIdx.x; e < n; e += MUL_ADD_THREADS) {
      const float ab = va[e] * vb[e];
      const float cd = vc[e] * 0.9999f;
      vc[e] = ab + cd;
    }
  }
  for (int e = threadIdx.x; e < n; e += MUL_ADD_THREADS) {
    const int r = e / tile;
    const int j = e - r * tile;
    if (j < width) out[static_cast<long long>(r) * P + col0 + j] = vc[e];
  }
}

__global__ void __launch_bounds__(FMA_THREADS)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out, const int n,
                 const int passes) {
  const long long base =
      static_cast<long long>(blockIdx.x) * FMA_THREADS * FMA_CHAINS + threadIdx.x;
  float v[FMA_CHAINS];
#pragma unroll
  for (int k = 0; k < FMA_CHAINS; ++k) {
    const long long i = base + static_cast<long long>(k) * FMA_THREADS;
    v[k] = i < n ? x[i] : 0.0f;
  }
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int k = 0; k < FMA_CHAINS; ++k) v[k] = __fmaf_rn(v[k], 1.0000001f, 1e-7f);
    }
  }
#pragma unroll
  for (int k = 0; k < FMA_CHAINS; ++k) {
    const long long i = base + static_cast<long long>(k) * FMA_THREADS;
    if (i < n) out[i] = v[k];
  }
}

}  // namespace

extern "C" {

// in, out: host arrays of 7 device pointers aligned to 16 bytes; the first
// six buffers hold n_plane floats, the last n_row.  Returns a cudaError_t.
int hbm_copy_launch(int device, const float* const* in, float* const* out, int n_plane,
                    int n_row, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_plane < 0 || n_row < 0) return static_cast<int>(cudaErrorInvalidValue);
  CopyBuffers bufs;
  for (int k = 0; k < COPY_BUFFERS; ++k) {
    bufs.in[k] = in[k];
    bufs.out[k] = out[k];
    bufs.n[k] = k + 1 < COPY_BUFFERS ? n_plane : n_row;
  }
  const long long n_max = n_plane > n_row ? n_plane : n_row;
  if (n_max == 0) return 0;
  long long tiles = (n_max / 4 + COPY_THREADS - 1) / COPY_THREADS;
  if (tiles < 1) tiles = 1;                       // the tail alone
  if (tiles > COPY_MAX_TILES) tiles = COPY_MAX_TILES;
  const dim3 grid(static_cast<unsigned>(tiles), COPY_BUFFERS);
  hbm_copy_kernel<<<grid, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(bufs);
  return static_cast<int>(cudaGetLastError());
}

// a, b, c, out: [L, P] float32; tile columns per block, 3 * L * tile * 4
// bytes of shared memory at most 227 KB.  Returns a cudaError_t.
int mul_add_launch(int device, const float* a, const float* b, const float* c, float* out,
                   int L, int P, int tile, int passes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = 3LL * L * tile * static_cast<long long>(sizeof(float));
  if (L < 1 || P < 0 || tile < 1 || passes < 0 || smem > SMEM_OPT_IN_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return 0;
  err = cudaFuncSetAttribute(mul_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((P + tile - 1) / tile);
  mul_add_kernel<<<blocks, MUL_ADD_THREADS, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(a, b, c, out, L, P, tile, passes);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n float32.  Returns a cudaError_t.
int fma_chain_launch(int device, const float* x, float* out, int n, int passes,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || passes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long per_block = static_cast<long long>(FMA_THREADS) * FMA_CHAINS;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  fma_chain_kernel<<<blocks, FMA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
