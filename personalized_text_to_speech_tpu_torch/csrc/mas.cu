// Monotonic Alignment Search (MAS) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// personalized_text_to_speech_tpu/ops/mas_pallas.py::maximum_path_pallas
// (kernel body _mas_kernel).  It computes the same Viterbi DP per utterance,
// with the same fp32 arithmetic in the same order, so the path is
// bit-identical to the Pallas kernel and to the numpy oracle:
//
//   V[0, x] = neg[0, x] + (x == 0 ? 0 : -1e9)
//   V[y, x] = neg[y, x] + max(x < y ? V[y-1, x] : -1e9,
//                             x == 0 ? -1e9 : V[y-1, x-1])
//
// Backtrack from (spec_len-1, text_len-1): the cursor c moves left at row y
// iff c > 0 and (c == y or V[y-1, c] < V[y-1, c-1]); ties stay.  Rows at or
// past spec_len and columns at or past text_len are written 0.
//
// Bound on the card: the path written once, 4 * B * T_y * T_x bytes, and
// the band of neg the path depends on read once (chip_smoke.py counts that
// band for its inputs): ~2 us at B=16, T_y=400, T_x=192.  What limits the
// kernel is not bytes but the chain of T_y dependent rows in each block,
// then T_y dependent steps of the backtrack, with B blocks on 132 SMs.  The
// design keeps that chain short and keeps everything else off it:
//
//   * one block of 128 threads per utterance;
//   * forward DP in warp 0 alone: lane l owns the columns 32k + l; the two
//     value rows live in shared memory and each row begins with
//     __syncwarp(), never a block barrier.  Only the 32-column word groups
//     below text_len are computed: no value right of text_len reaches the
//     path.  A row of at most 8 groups (T_x <= 256) is one straight pass;
//     wider rows take passes of 8, 4, 2 and 1 groups;
//   * score rows prefetched: warp 0 keeps a ring of d whole score rows in
//     shared memory, in 2 halves of d/2 rows, one cp.async group each;
//     while it computes one half the other is in flight (16-byte copies
//     when T_x % 4 == 0 and neg is 16-byte aligned, 4-byte ones otherwise).
//     d is 64, 32, 16, 8 or 4, the largest whose ring fits 48 KB (64 at
//     T_x = 192, 8 at T_x = 1500).  Halves, not one row at a time: each
//     refill costs warp 0 far more than a row, so the fewer the better;
//   * packed decision bits: __ballot_sync of V[y-1,x] < V[y-1,x-1] (x > 0)
//     gives one 32-bit word per (row, group k), which lane 0 stores to an
//     int32 [B, T_y, ceil(T_x/32)] scratch the wrapper allocates, 32x
//     smaller than a byte per cell;
//   * warps 1-3 zero-fill the utterance's whole [T_y, T_x] path meanwhile
//     (float4 stores where aligned); then one __syncthreads();
//   * backtrack from shared memory: warp 0 loads the decision words of
//     kChunk rows at a time with cp.async, the next chunk in flight while
//     lane 0 walks this one (double buffer).  Lane 0 follows the cursor and
//     stores 1.0f at (y, c) for each row below spec_len; each row's 64-bit
//     window of words is loaded two rows ahead, so no load waits on the
//     decision before it.
//
// Shared memory is bounded by T_x alone (mas_shared_bytes): the ring, two
// value rows and two word chunks.  T_x up to 5,728 fits a Hopper block's
// 227 KB; the wrapper refuses wider inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 128;
constexpr int kBlocks = 2;                // ring blocks: one read, one in flight
constexpr int kMaxRing = 64;              // score rows in the ring, at most
constexpr size_t kRingBudget = 48 * 1024; // bytes the ring may take
constexpr int kChunk = 64;                // backtrack rows per word chunk

// a row in shared memory: T_x floats rounded up to whole word groups of 32
// columns, so a group reads and writes without bounds checks
__host__ __device__ inline int row_stride(int t_x) { return (t_x + 31) & ~31; }
__host__ __device__ inline int words_per_row(int t_x) { return (t_x + 31) / 32; }

// score rows in the ring: 64, or fewer (at least 4) where 64 pass 48 KB
int ring_rows(int t_x) {
  const size_t row_bytes = static_cast<size_t>(t_x) * sizeof(float);
  int d = kMaxRing;
  while (d > 2 * kBlocks && d * row_bytes > kRingBudget) d /= 2;
  return d;
}

// d score rows at T_x floats each and 32 floats of slack after them, two
// value rows each behind 4 floats whose last is V[-1], two chunks of
// decision words each behind 2 rows of slack
size_t shared_bytes(int d, int t_x) {
  return (static_cast<size_t>(d) * t_x + 32 + 2 * (row_stride(t_x) + 4) +
          2 * static_cast<size_t>(kChunk + 2) * words_per_row(t_x)) * 4;
}

__device__ inline void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ inline void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A shared-memory load issued where it stands: neither nvcc nor ptxas may
// turn a pair of them into one load and a reload predicated on a later
// result.
__device__ inline uint32_t ld_shared(const uint32_t* p) {
  uint32_t v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(s));
  return v;
}

// n contiguous floats, copied by the 32 lanes of warp 0; with vec, n is a
// multiple of 4 and both ends are 16-byte aligned.
__device__ inline void copy_floats(float* dst, const float* src, int n,
                                   bool vec, int lane) {
  if (vec) {
    dst += 4 * lane;
    src += 4 * lane;
    for (int i = 4 * lane; i < n; i += 128, dst += 128, src += 128) {
      cp_async_16(dst, src);
    }
  } else {
    dst += lane;
    src += lane;
    for (int i = lane; i < n; i += 32, dst += 32, src += 32) {
      cp_async_4(dst, src);
    }
  }
}

// Zero n floats at p with the threads ranked t of nt: scalar stores up to
// the first 16-byte boundary and after the last, float4 stores between.
__device__ inline void zero_fill(float* p, size_t n, int t, int nt) {
  size_t head = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) / 4 & 3;
  if (head > n) head = n;
  for (size_t i = t; i < head; i += nt) p[i] = 0.0f;
  float4* q = reinterpret_cast<float4*>(p + head);
  const size_t n4 = (n - head) / 4;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = t; i < n4; i += nt) q[i] = z;
  for (size_t i = head + 4 * n4 + t; i < n; i += nt) p[i] = 0.0f;
}

// One pass of the forward over the N word groups k0 .. k0 + N - 1 of row y:
// V[y] into cur from V[y-1] in prev and the scores in srow, and the N
// decision words into drow[k0 ..], stored by lane 0.  The value and score
// pointers are this lane's column 0 of each row, and before = y - lane.
// All loads come before the stores (the compiler cannot tell cur from
// prev, and would otherwise run the groups one after another) and the
// ballots come last (a ballot orders the shared-memory accesses around it).
template <int N>
__device__ __forceinline__ void forward_pass(const float* prev, float* cur,
                                             const float* srow,
                                             uint32_t* drow, int k0,
                                             int before, int lane) {
  prev += 32 * k0;
  cur += 32 * k0;
  srow += 32 * k0;
  drow += k0;
  before -= 32 * k0;               // column 32 (k0 + j) + lane may stay
  const bool col0 = k0 == 0 && lane == 0;  // column 0 never moves left
  float p[N], pl[N], sc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    p[j] = prev[32 * j];
    pl[j] = prev[32 * j - 1];
    sc[j] = srow[32 * j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float stay = 32 * j < before ? p[j] : kNeg;
    cur[32 * j] = sc[j] + fmaxf(stay, pl[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t word =
        __ballot_sync(0xffffffffu, p[j] < pl[j] && !(j == 0 && col0));
    if (lane == 0) drow[j] = word;
  }
}

// Rows [y, y_end) of one ring block over the ng word groups from k0: each
// row from V[y-1] at vp into vc, which swap roles with each row (both are
// this lane's column 0), with its scores at sp and its words at drow.
// NG = ng when it is at most 8, which gives a row without branches; NG = 0
// takes any ng, in passes of 8, 4, 2 and 1.
template <int NG>
__device__ __forceinline__ void block_rows(float*& vp, float*& vc,
                                           const float* sp, uint32_t* drow,
                                           int y, int y_end, int t_x, int kw,
                                           int k0, int ng, int lane) {
  auto row = [&](int y, const float* p, float* c, const float* s,
                 uint32_t* w) {
    __syncwarp();  // V[y-1] is complete
    if constexpr (NG > 0) {
      forward_pass<NG>(p, c, s, w, k0, y - lane, lane);
    } else {
      int k = k0;
      for (; k + 8 <= k0 + ng; k += 8) {
        forward_pass<8>(p, c, s, w, k, y - lane, lane);
      }
      if (ng & 4) {
        forward_pass<4>(p, c, s, w, k, y - lane, lane);
        k += 4;
      }
      if (ng & 2) {
        forward_pass<2>(p, c, s, w, k, y - lane, lane);
        k += 2;
      }
      if (ng & 1) forward_pass<1>(p, c, s, w, k, y - lane, lane);
    }
  };
  for (; y + 2 <= y_end; y += 2) {
    row(y, vp, vc, sp, drow);
    row(y + 1, vc, vp, sp + t_x, drow + kw);
    sp += 2 * t_x;
    drow += 2 * kw;
  }
  if (y < y_end) {
    row(y, vp, vc, sp, drow);
    float* t = vp;
    vp = vc;
    vc = t;
  }
}

// The forward of one utterance in warp 0: rows below sl, columns below tl,
// over a ring of d score rows in kBlocks blocks.
//
// When tl <= sl the path depends only on the band y - (sl - tl) <= x <= y
// (chip_smoke.py's mas_needed_cells): the backtrack's cursor stays in it,
// and a value in it depends on no value outside it.  So each ring block
// computes only the word groups that meet the band in one of its rows.
// Other columns, and those past text_len, hold whatever the buffers held
// (their words too); no value or decision of theirs reaches the path.
__device__ __forceinline__ void forward_rows(float* ring, float* prev,
                                             float* cur, const float* nb,
                                             uint32_t* db, int t_x, int kw,
                                             int tl, int sl, int d, bool vec,
                                             int lane) {
  // Ring block g holds rows [g * step, g * step + step) whole, at the ring's
  // row g % kBlocks * step; one cp.async group per block.  A row is read up
  // to its last word group, past T_x into the slack after the ring.
  const int step = d / kBlocks;
  auto fetch = [&](int g) {
    const int r0 = g * step;
    if (r0 < sl) {
      copy_floats(ring + (g % kBlocks) * step * t_x,
                  nb + static_cast<size_t>(r0) * t_x,
                  min(step, sl - r0) * t_x, vec, lane);
    }
    cp_async_commit();
  };
  if (lane == 0) prev[-1] = cur[-1] = kNeg;  // the left of column 0
  for (int g = 0; g < kBlocks - 1; ++g) fetch(g);
  cp_async_wait<kBlocks - 2>();  // this lane's copies of block 0 have landed
  __syncwarp();                  // and every lane's
  fetch(kBlocks - 1);
  for (int x = lane; x < tl; x += 32) {
    prev[x] = ring[x] + (x == 0 ? 0.0f : kNeg);
  }
  const int gap = sl - tl;
  float* vp = prev + lane;  // this lane's column 0 of V[y-1] and of V[y]
  float* vc = cur + lane;
  // ring block g: rows [y0, y0 + step)
  for (int y0 = 0, g = 0; y0 < sl; y0 += step, ++g) {
    if (y0 > 0) {
      cp_async_wait<kBlocks - 2>();  // this lane's copies of block g landed
      __syncwarp();                  // and every lane's
      fetch(g + kBlocks - 1);  // into the slots of block g - 1
    }
    const float* sp = ring + (g % kBlocks) * step * t_x + lane;
    uint32_t* drow = db + static_cast<size_t>(y0) * kw;
    const int y_end = min(y0 + step, sl);
    int lo = 0, hi = tl - 1;  // the columns these rows need
    if (gap >= 0) {
      lo = max(y0 - gap, 0);
      hi = min(y_end - 1, hi);
    }
    const int k0 = lo / 32;
    const int ng = hi / 32 + 1 - k0;
    int y = y0;
    if (y == 0) {  // row 0 is done
      ++y;
      sp += t_x;
      drow += kw;
    }
#define MAS_ROWS(NG) \
  block_rows<NG>(vp, vc, sp, drow, y, y_end, t_x, kw, k0, ng, lane)
    switch (ng) {
      case 1: MAS_ROWS(1); break;
      case 2: MAS_ROWS(2); break;
      case 3: MAS_ROWS(3); break;
      case 4: MAS_ROWS(4); break;
      case 5: MAS_ROWS(5); break;
      case 6: MAS_ROWS(6); break;
      case 7: MAS_ROWS(7); break;
      case 8: MAS_ROWS(8); break;
      default: MAS_ROWS(0);
    }
#undef MAS_ROWS
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ neg, const int* __restrict__ text_lengths,
           const int* __restrict__ spec_lengths, float* __restrict__ path,
           uint32_t* __restrict__ dec, int t_y, int t_x, int d, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int s = row_stride(t_x);
  const int kw = words_per_row(t_x);
  float* ring = smem;                     // d score rows
  float* prev = ring + d * t_x + 32 + 4;  // V[y-1]
  float* cur = prev + s + 4;              // V[y]
  // 2 x (2 + kChunk) x kw
  uint32_t* chunks = reinterpret_cast<uint32_t*>(cur + s);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t b = blockIdx.x;
  const float* nb = neg + b * t_y * t_x;
  float* pb = path + b * t_y * t_x;
  uint32_t* db = dec + b * t_y * kw;
  // lengths past the canvas are clamped so no access leaves the tensor
  const int tl = min(max(text_lengths[b], 0), t_x);
  const int sl = min(max(spec_lengths[b], 0), t_y);
  const bool work = tl > 0 && sl > 0;

  if (warp != 0) {
    zero_fill(pb, static_cast<size_t>(t_y) * t_x, threadIdx.x - 32,
              kThreads - 32);
  } else if (work) {
    forward_rows(ring, prev, cur, nb, db, t_x, kw, tl, sl, d, vec, lane);
  }
  __syncthreads();  // zeros and decision words visible to the whole block
  if (warp != 0 || !work) return;

  // ---- backtrack: chunks of decision words, the next one in flight -----
  // chunk q: the words of rows [q * kChunk, q * kChunk + kChunk), in buffer
  // q % 2, which 2 rows of slack precede
  auto chunk_row = [&](int q, int y) {
    return chunks + ((q & 1) * (kChunk + 2) + 2 + y - q * kChunk) * kw;
  };
  auto load_chunk = [&](int q) {
    const int y0 = max(q * kChunk, 1);  // row 0 has no decisions
    const int y1 = min(q * kChunk + kChunk, sl);
    uint32_t* dst = chunk_row(q, y0);
    const uint32_t* src = db + static_cast<size_t>(y0) * kw;
    for (int i = lane; i < (y1 - y0) * kw; i += 32) cp_async_4(dst + i, src + i);
    cp_async_commit();
  };
  // The cursor moves at most one column a row, so the words m - 1 and m of
  // a row, m = c / 32 for the cursor c two rows above, hold the row's
  // decision at whatever column the cursor has by then.  Each row's 64-bit
  // window is loaded two rows ahead, and no shared-memory load waits on a
  // decision.  Rows above the chunk read its slack, and word m - 1 at
  // m = 0 the word before the row: neither is ever used.
  auto window = [](const uint32_t* w, int m) {
    return static_cast<uint64_t>(ld_shared(w + m)) << 32 | ld_shared(w + m - 1);
  };
  int c = tl - 1;
  const int top = (sl - 1) / kChunk;
  load_chunk(top);
  for (int q = top; q >= 0; --q) {
    if (q > 0) {
      load_chunk(q - 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();  // chunk q has landed
    __syncwarp();
    if (lane == 0) {
      int y = min(q * kChunk + kChunk, sl) - 1;
      const int y_stop = max(q * kChunk, 1);  // rows that may move left
      const uint32_t* wrow = chunk_row(q, y);
      float* prow = pb + static_cast<size_t>(y) * t_x;
      // windows of rows y (a) and y - 1 (b) from the cursor now; column c's
      // bit is bit c + s of a window
      const int m = c >> 5;
      uint64_t va = window(wrow, m), vb = window(wrow - kw, m);
      int sa = 32 - 32 * m, sb = sa;
      // row yy from its window v, which then takes row yy - 2's, loaded in
      // place (no register moves wait on it) from the cursor now
      auto step = [&](int yy, uint64_t& v, int& sv) {
        prow[c] = 1.0f;
        prow -= t_x;
        const uint32_t bit = static_cast<uint32_t>(v >> (c + sv)) & 1u;
        c -= static_cast<int>((c > 0) & ((c == yy) | bit));
        wrow -= kw;
        v = window(wrow - kw, c >> 5);
        sv = 32 - 32 * (c >> 5);
      };
      for (; y > y_stop; y -= 2) {
        step(y, va, sa);
        step(y - 1, vb, sb);
      }
      if (y == y_stop) step(y--, va, sa);
      if (y == 0) prow[c] = 1.0f;  // row 0 takes no decision
    }
    __syncwarp();  // lane 0 is done with this buffer before it is refilled
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at this T_x: the ring of score rows, two
// value rows and two chunks of decision words.  The wrapper calls this too,
// to refuse shapes past the card's limit.
size_t mas_shared_bytes(int t_x) { return shared_bytes(ring_rows(t_x), t_x); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `dec` is
// int32 scratch of B * T_y * ceil(T_x / 32) words.
int mas_launch(const float* neg, const int* text_lengths,
               const int* spec_lengths, float* path, uint32_t* dec,
               int batch, int t_y, int t_x, cudaStream_t stream) {
  const int d = ring_rows(t_x);
  const size_t smem = shared_bytes(d, t_x);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = t_x % 4 == 0 && reinterpret_cast<uintptr_t>(neg) % 16 == 0;
  mas_kernel<<<batch, kThreads, smem, stream>>>(
      neg, text_lengths, spec_lengths, path, dec, t_y, t_x, d, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* mas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
