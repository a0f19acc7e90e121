// The checkpoint's DEFLATE encoder, for Hopper (sm_90a): the raw DEFLATE
// stream (RFC 1951) and the CRC-32 of one member of the checkpoint's .npz.
//
// Port-only kernels: they replace no TPU kernel.  They were added for the
// online loop's production hooks, whose checkpoint (io/checkpoint.py:
// save_checkpoint) copied the whole blocks-layout state to the host and
// deflated it there with single-threaded zlib (np.savez_compressed): about
// 1.3 s for 155.6 MB at P = 100,000, L = 64 on an H100 machine's host, while
// the card sat idle.  Here the card encodes each large member and the host
// writes only the zip container around the streams.
//
// The stream: one block with the fixed Huffman codes of RFC 1951 §3.2.6
// (BTYPE 01, BFINAL 1), so no code table has to be built or sent.  The
// member's bytes are cut into segments; each segment is tokenized greedily,
// one 4-byte word at a time, by one thread, into three kinds of token, a word
// taking the first kind that fits:
//   * a match at the row distance (the previous particle's row: after the
//     staircase resample the copies of one ancestor sit side by side and share
//     their unobserved slots), where the word equals the word one row back;
//   * a run at distance 1, where the word's four bytes repeat the byte before
//     it (the empty slots' zeros);
//   * four literals, everywhere else.
// Consecutive words of one match kind make one match, cut into pieces of at
// most 258 bytes and at least 3.  Matches reach back into earlier segments
// (the decoder has their bytes), never before the member's first byte.
//
// Three launches (deflate_fixed_launch):
// 1. deflate_count: one thread per segment counts the segment's bits and the
//    bytes its row matches cover, and computes the segment's CRC-32
//    (slicing-by-4 tables in shared memory) shifted over the bytes after it
//    (multiplied by x^(8n) modulo the CRC polynomial, zlib's crc32_combine),
//    XORed into one word: the fold of every segment's CRC.
// 2. deflate_scan: one block turns the counts into each segment's first bit
//    (an exclusive int64 scan, after the block's 3 header bits), writes the
//    block header, the stream's length in bits (with the 7-bit end-of-block
//    code, all zeros) and the member's CRC, seeded with the .npy header's.
// 3. deflate_write: one thread per segment tokenizes again and writes its
//    bits into the zeroed stream.  Only a segment's first and last 32-bit
//    words can be shared with a neighbour: those it ORs atomically, the words
//    between it stores.
//
// What bounds it on an H100: the bytes.  It must read the member once and
// write its stream: at P = 100,000, L = 64 the blocks-layout state is 155.6 MB
// and its stream about 12 MB, 0.05 ms at 3.35 TB/s.  The design reads the
// member from device memory about once a pass (a thread walks its segment's
// words; its row-distance loads are the neighbouring thread's words, in
// cache) and keeps 2 x BATCH loads in flight per thread; the count pass reads
// it once more, from cache, for the CRC.  The host copies back the stream
// (into pinned memory), not the state.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SEG_THREADS = 128;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;                   // counts per thread per scan tile
constexpr int BATCH = 8;                        // words a thread loads ahead
constexpr int MAX_DISTANCE = 32768;             // DEFLATE's window
constexpr unsigned CRC_POLY = 0xedb88320u;      // CRC-32, reflected
constexpr unsigned FULL = 0xffffffffu;
constexpr int LIT = 0;
constexpr int ROW = 1;
constexpr int RUN = 2;

// info: the stream's length in bits, the member's CRC-32, the bytes covered by
// row matches, and the fold of the segments' CRCs (scratch, low 32 bits).
constexpr int INFO_BITS = 0;
constexpr int INFO_CRC = 1;
constexpr int INFO_ROW_BYTES = 2;
constexpr int INFO_FOLD = 3;

// The lowest `len` bits of `code`, reversed: Huffman codes are sent from
// their most significant bit, into a stream filled from bit 0.
__device__ __forceinline__ unsigned reversed(unsigned code, int len) {
  return __brev(code) >> (32 - len);
}

__device__ __forceinline__ int floor_log2(unsigned x) { return 31 - __clz(static_cast<int>(x)); }

// a * b modulo the CRC polynomial, in zlib's reflected representation (bit
// 31 is x^0); all 32 steps, no early exit.
__device__ __forceinline__ unsigned multmodp(unsigned a, unsigned b) {
  unsigned m = 1u << 31;
  unsigned p = 0;
  for (int i = 0; i < 32; ++i) {
    if (a & m) p ^= b;
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ CRC_POLY : b >> 1;
  }
  return p;
}

// x2n[k] = x^(2^k) modulo the polynomial.
__device__ void x2n_table(unsigned* x2n) {
  unsigned p = 1u << 30;   // x^1
  x2n[0] = p;
  for (int k = 1; k < 32; ++k) {
    p = multmodp(p, p);
    x2n[k] = p;
  }
}

// x^(n * 2^k) modulo the polynomial: with k = 3, the shift over n bytes.
__device__ unsigned x2nmodp(unsigned long long n, int k, const unsigned* x2n) {
  unsigned p = 1u << 31;   // x^0
  while (n) {
    if (n & 1) p = multmodp(x2n[k & 31], p);
    n >>= 1;
    ++k;
  }
  return p;
}

// The slicing-by-4 tables of the reflected CRC-32, by every thread of the
// block; the caller synchronizes before reading them.
__device__ void crc_tables(unsigned (*table)[256]) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = static_cast<unsigned>(i);
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ CRC_POLY : c >> 1;
    table[0][i] = c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = table[0][i];
    for (int k = 1; k < 4; ++k) {
      c = (c >> 8) ^ table[0][c & 0xff];
      table[k][i] = c;
    }
  }
}

// zlib's crc32 of words [begin, end) (little-endian bytes), from a fresh start.
__device__ unsigned crc_words(const unsigned* __restrict__ words, long long begin, long long end,
                              const unsigned (*table)[256]) {
  unsigned c = FULL;
  for (long long j = begin; j < end; ++j) {
    c ^= __ldg(words + j);
    c = table[3][c & 0xff] ^ table[2][(c >> 8) & 0xff] ^ table[1][(c >> 16) & 0xff] ^
        table[0][c >> 24];
  }
  return ~c;
}

// The count pass's output: bits, and the bytes row matches cover.
struct BitCount {
  long long bits = 0;
  unsigned long long row_bytes = 0;
  __device__ __forceinline__ void put(unsigned long long, int len) { bits += len; }
  __device__ __forceinline__ void row(int len) { row_bytes += static_cast<unsigned>(len); }
};

// The write pass's output: bits from `offset` on into the zeroed stream.
struct BitWriter {
  unsigned* out;
  long long word;
  unsigned long long acc;
  int n;
  bool first;
  __device__ BitWriter(unsigned* o, long long offset)
      : out(o), word(offset >> 5), acc(0), n(static_cast<int>(offset & 31)), first(true) {}
  // len <= 32, so acc never holds more than 63 bits
  __device__ __forceinline__ void put(unsigned long long v, int len) {
    acc |= v << n;
    n += len;
    while (n >= 32) {
      const unsigned w = static_cast<unsigned>(acc);
      if (first) {
        atomicOr(out + word, w);   // the previous segment's last bits share it
        first = false;
      } else {
        out[word] = w;
      }
      acc >>= 32;
      n -= 32;
      ++word;
    }
  }
  __device__ __forceinline__ void row(int) {}
  // the last, partial word: the next segment's first bits share it
  __device__ __forceinline__ void finish() {
    if (n > 0) atomicOr(out + word, static_cast<unsigned>(acc));
  }
};

// A literal byte: 0-143 in 8 bits from 0x30, 144-255 in 9 bits from 0x190.
template <class Out>
__device__ __forceinline__ void put_literal(Out& o, unsigned b) {
  if (b < 144) {
    o.put(reversed(0x30u + b, 8), 8);
  } else {
    o.put(reversed(0x190u + b - 144u, 9), 9);
  }
}

// A match of `len` bytes (>= 3) at `distance` (1 .. 32768), in pieces of at
// most 258 bytes, none under 3: each piece its length code and extra bits,
// then the distance's 5-bit code and extra bits.
template <class Out>
__device__ void put_match(Out& o, int len, int distance, bool row) {
  if (row) o.row(len);
  const unsigned dx = static_cast<unsigned>(distance - 1);
  int dsym = static_cast<int>(dx);
  int dext = 0;
  if (dx >= 4) {
    const int lg = floor_log2(dx);
    dext = lg - 1;
    dsym = 2 * lg + static_cast<int>((dx >> dext) & 1);
  }
  const unsigned dbits =
      reversed(static_cast<unsigned>(dsym), 5) | ((dx & ((1u << dext) - 1)) << 5);
  const int dlen = 5 + dext;
  while (len > 0) {
    const int piece = len > 258 ? min(258, len - 3) : len;
    len -= piece;
    int sym;
    int ext = 0;
    unsigned extra = 0;
    if (piece == 258) {
      sym = 285;
    } else if (piece <= 10) {
      sym = 254 + piece;
    } else {
      const unsigned x = static_cast<unsigned>(piece - 3);
      ext = floor_log2(x) - 2;
      sym = 257 + 4 * (ext + 1) + static_cast<int>((x >> ext) - 4);
      extra = x & ((1u << ext) - 1);
    }
    const unsigned code = sym < 280 ? static_cast<unsigned>(sym - 256) : 0xc0u + (sym - 280);
    const int clen = sym < 280 ? 7 : 8;
    const unsigned lbits = reversed(code, clen) | (extra << clen);
    const int llen = clen + ext;
    o.put(static_cast<unsigned long long>(lbits) | (static_cast<unsigned long long>(dbits) << llen),
          llen + dlen);
  }
}

// The tokens of words [begin, end); `dist` the row distance in words (0: none).
template <class Out>
__device__ void tokenize(const unsigned* __restrict__ words, long long begin, long long end,
                         int dist, Out& o) {
  unsigned prev = begin > 0 ? __ldg(words + begin - 1) : 0u;
  int kind = LIT;
  int len = 0;   // bytes of the pending match
  for (long long j0 = begin; j0 < end; j0 += BATCH) {
    unsigned cur[BATCH];
    unsigned up[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const long long j = j0 + k;
      cur[k] = j < end ? __ldg(words + j) : 0u;
      up[k] = (j < end && dist > 0 && j >= dist) ? __ldg(words + j - dist) : 0u;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const long long j = j0 + k;
      if (j < end) {
        const unsigned v = cur[k];
        const int now = (dist > 0 && j >= dist && v == up[k])        ? ROW
                        : (j > 0 && v == (prev >> 24) * 0x01010101u) ? RUN
                                                                     : LIT;
        if (now == LIT) {
          if (kind != LIT) put_match(o, len, kind == ROW ? 4 * dist : 1, kind == ROW);
          kind = LIT;
          put_literal(o, v & 0xff);
          put_literal(o, (v >> 8) & 0xff);
          put_literal(o, (v >> 16) & 0xff);
          put_literal(o, v >> 24);
        } else if (now == kind) {
          len += 4;
        } else {
          if (kind != LIT) put_match(o, len, kind == ROW ? 4 * dist : 1, kind == ROW);
          kind = now;
          len = 4;
        }
        prev = v;
      }
    }
  }
  if (kind != LIT) put_match(o, len, kind == ROW ? 4 * dist : 1, kind == ROW);
}

__global__ void __launch_bounds__(SEG_THREADS)
deflate_count(const unsigned* __restrict__ words, const long long nwords, const int seg_words,
              const int dist, const long long nseg, long long* __restrict__ bits,
              unsigned long long* __restrict__ info) {
  __shared__ unsigned table[4][256];
  __shared__ unsigned x2n[32];
  crc_tables(table);
  if (threadIdx.x == 0) x2n_table(x2n);
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned folded = 0;
  unsigned long long matched = 0;
  if (i < nseg) {
    const long long begin = i * seg_words;
    const long long end = begin + seg_words < nwords ? begin + seg_words : nwords;
    BitCount c;
    tokenize(words, begin, end, dist, c);
    bits[i] = c.bits;
    matched = c.row_bytes;
    folded = multmodp(x2nmodp(4ull * static_cast<unsigned long long>(nwords - end), 3, x2n),
                      crc_words(words, begin, end, table));
  }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    folded ^= __shfl_xor_sync(FULL, folded, h);
    matched += __shfl_xor_sync(FULL, matched, h);
  }
  if ((threadIdx.x & 31) == 0) {
    if (folded) atomicXor(reinterpret_cast<unsigned*>(info + INFO_FOLD), folded);
    if (matched) atomicAdd(info + INFO_ROW_BYTES, matched);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
deflate_scan(long long* __restrict__ bits, const long long nseg, const long long nbytes,
             const unsigned seed_crc, unsigned* __restrict__ out,
             unsigned long long* __restrict__ info) {
  __shared__ long long warp_sums[SCAN_THREADS / 32];
  __shared__ long long carry;
  __shared__ unsigned x2n[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  if (threadIdx.x == 0) {
    carry = 3;   // the block header: BFINAL 1, BTYPE 01
    x2n_table(x2n);
  }
  __syncthreads();
  const long long tile = static_cast<long long>(blockDim.x) * SCAN_ITEMS;
  for (long long base = 0; base < nseg; base += tile) {
    const long long j0 = base + static_cast<long long>(threadIdx.x) * SCAN_ITEMS;
    long long v[SCAN_ITEMS];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = j0 + k < nseg ? bits[j0 + k] : 0;
      sum += v[k];
    }
    long long incl = sum;
#pragma unroll
    for (int h = 1; h < 32; h <<= 1) {
      const long long up = __shfl_up_sync(FULL, incl, h);
      if (lane >= h) incl += up;
    }
    if (lane == 31 || static_cast<int>(threadIdx.x) == static_cast<int>(blockDim.x) - 1) {
      warp_sums[warp] = incl;
    }
    __syncthreads();
    long long before = carry + incl - sum;
    long long total = 0;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) before += warp_sums[w];
      total += warp_sums[w];
    }
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (j0 + k < nseg) bits[j0 + k] = before;
      before += v[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    info[INFO_BITS] = static_cast<unsigned long long>(carry + 7);   // and the end-of-block code
    const unsigned fold = static_cast<unsigned>(info[INFO_FOLD]);
    info[INFO_CRC] =
        multmodp(x2nmodp(static_cast<unsigned long long>(nbytes), 3, x2n), seed_crc) ^ fold;
    out[0] |= 3u;
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
deflate_write(const unsigned* __restrict__ words, const long long nwords, const int seg_words,
              const int dist, const long long nseg, const long long* __restrict__ offsets,
              unsigned* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nseg) return;
  const long long begin = i * seg_words;
  const long long end = begin + seg_words < nwords ? begin + seg_words : nwords;
  BitWriter w(out, offsets[i]);
  tokenize(words, begin, end, dist, w);
  w.finish();
}

}  // namespace

extern "C" {

// data: nbytes bytes (a multiple of 4, 4-byte aligned) on the device; segments
// of seg_bytes (a multiple of 4); dist_bytes the row distance (a multiple of 4,
// at most 32768; 0 for none); seed_crc the CRC-32 of what precedes the member
// (its .npy header), its 32 bits passed as an int; seg_scratch: one int64 per segment; out: out_words 32-bit
// words, at least (9 * nbytes + 41) / 32 + 1 (9 bits a byte at worst), zeroed
// here; info: four uint64, zeroed here, of which the first three are the
// stream's length in bits, the CRC-32 and the bytes row matches cover.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for arguments outside those.
int deflate_fixed_launch(int device, const void* data, long long nbytes, int seg_bytes,
                         int dist_bytes, int seed_crc, long long* seg_scratch, void* out,
                         long long out_words, unsigned long long* info, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbytes < 0 || nbytes % 4 != 0 || seg_bytes <= 0 || seg_bytes % 4 != 0 || dist_bytes < 0 ||
      dist_bytes % 4 != 0 || dist_bytes > MAX_DISTANCE ||
      reinterpret_cast<std::uintptr_t>(data) % 4 != 0 || out_words < (9 * nbytes + 41) / 32 + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nwords = nbytes / 4;
  const int seg_words = seg_bytes / 4;
  const long long nseg = (nwords + seg_words - 1) / seg_words;
  const long long blocks = (nseg + SEG_THREADS - 1) / SEG_THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(out_words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(info, 0, 4 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* words = static_cast<const unsigned*>(data);
  auto* stream_words = static_cast<unsigned*>(out);
  const int dist = dist_bytes / 4;
  if (nseg > 0) {
    deflate_count<<<static_cast<unsigned>(blocks), SEG_THREADS, 0, s>>>(
        words, nwords, seg_words, dist, nseg, seg_scratch, info);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  deflate_scan<<<1, SCAN_THREADS, 0, s>>>(seg_scratch, nseg, nbytes,
                                          static_cast<unsigned>(seed_crc), stream_words, info);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return static_cast<int>(err);
  deflate_write<<<static_cast<unsigned>(blocks), SEG_THREADS, 0, s>>>(
      words, nwords, seg_words, dist, nseg, seg_scratch, stream_words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
