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
// Design (simple and right first):
//   * one block per utterance, threads striding over T_x;
//   * the previous and current value rows in shared memory (2 * T_x floats),
//     one __syncthreads() per frame;
//   * the forward pass stores one decision byte per cell,
//     dec[y, x] = V[y-1, x] < V[y-1, x-1], in a scratch tensor the wrapper
//     allocates, so the backtrack never needs the value rows again;
//   * one thread walks the decisions back and records the cursor of every
//     row in shared memory; then all threads write the 0/1 rows, coalesced.
//
// Bound on the card: the path written once, 4 * B * T_y * T_x bytes, and at
// most as many bytes of neg read (8 * B * T_y * T_x in all: 9.8 MB at B=16,
// T_y=400, T_x=192, ~2.9 us at 3.35 TB/s); the path depends only on a band
// of neg set by the lengths, which chip_smoke.py counts for its inputs.
// The real limiter is the T_y-deep chain of dependent rows inside each block
// (and the T_y-deep single-thread backtrack), with only B of the 132 SMs busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;

__global__ void mas_kernel(const float* __restrict__ neg,
                           const int* __restrict__ text_lengths,
                           const int* __restrict__ spec_lengths,
                           float* __restrict__ path,
                           uint8_t* dec,
                           int t_y, int t_x) {
  extern __shared__ float smem[];
  float* prev = smem;                                       // T_x floats
  float* cur = smem + t_x;                                  // T_x floats
  int* cursor = reinterpret_cast<int*>(smem + 2 * t_x);     // T_y ints

  const size_t base = static_cast<size_t>(blockIdx.x) * t_y * t_x;
  const float* nb = neg + base;
  float* pb = path + base;
  uint8_t* db = dec + base;
  // lengths past the canvas are clamped so no access leaves the tensor
  const int tl = min(max(text_lengths[blockIdx.x], 0), t_x);
  const int sl = min(max(spec_lengths[blockIdx.x], 0), t_y);

  // ---- forward: only rows below spec_len are ever read back -------------
  for (int x = threadIdx.x; x < t_x; x += blockDim.x) {
    prev[x] = nb[x] + (x == 0 ? 0.0f : kNeg);
  }
  __syncthreads();
  for (int y = 1; y < sl; ++y) {
    const float* nrow = nb + static_cast<size_t>(y) * t_x;
    uint8_t* drow = db + static_cast<size_t>(y) * t_x;
    for (int x = threadIdx.x; x < t_x; x += blockDim.x) {
      const float p = prev[x];
      const float pl = x > 0 ? prev[x - 1] : kNeg;
      const float stay = x < y ? p : kNeg;
      cur[x] = nrow[x] + fmaxf(stay, pl);
      drow[x] = (x > 0 && p < pl) ? 1 : 0;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  // ---- backtrack: one thread, decisions from the forward pass -----------
  if (threadIdx.x == 0) {
    int c = max(tl - 1, 0);
    for (int y = t_y - 1; y >= 0; --y) {
      const bool active = y < sl;
      cursor[y] = (active && c < tl) ? c : -1;
      if (active && y > 0 && c > 0 &&
          (c == y || db[static_cast<size_t>(y) * t_x + c])) {
        --c;
      }
    }
  }
  __syncthreads();

  // ---- write the hard path: one-hot rows, zero elsewhere ---------------
  for (int y = 0; y < t_y; ++y) {
    const int cy = cursor[y];
    float* prow = pb + static_cast<size_t>(y) * t_x;
    for (int x = threadIdx.x; x < t_x; x += blockDim.x) {
      prow[x] = x == cy ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs: two value rows and the cursor per row.
// The wrapper calls this too, to refuse shapes past the card's limit.
size_t mas_shared_bytes(int t_y, int t_x) {
  return (2 * static_cast<size_t>(t_x) + t_y) * sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int mas_launch(const float* neg, const int* text_lengths,
               const int* spec_lengths, float* path, uint8_t* dec,
               int batch, int t_y, int t_x, cudaStream_t stream) {
  const int threads = min(1024, ((t_x + 31) / 32) * 32);
  const size_t smem = mas_shared_bytes(t_y, t_x);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mas_kernel<<<batch, threads, smem, stream>>>(
      neg, text_lengths, spec_lengths, path, dec, t_y, t_x);
  return static_cast<int>(cudaGetLastError());
}

const char* mas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
