// Adaptive threshold + connected-component labelling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vicalib_tpu/detect/pallas_kernels.py::threshold_and_label (body
// _detect_kernel), which keeps one whole frame resident in the TPU's VMEM
// for every phase.  A padded 800x600 frame is 600x896: 2.1 MB of int32
// labels, far above the 227 KB of shared memory one SM can hold, so here
// every phase streams through device memory:
//
//   threshold_init  box mean over the clamped (2r+1)^2 window, summed in
//                   int32 (exact), mask and initial labels.  One block per
//                   row: column sums in shared memory, then row sums.
//   sweep           one Jacobi 3x3 min sweep over the mask (old buffer in,
//                   new buffer out), a few thousand blocks striding over
//                   the batch.  All n_iters sweeps are launched back to back
//                   with no host sync; a per-frame flag records whether a
//                   sweep changed anything, and a sweep returns at once for
//                   a frame whose previous sweep changed nothing (then both
//                   buffers already hold the fixpoint).
//   rep_count       representatives (masked pixels that kept their own flat
//                   index) per row.
//   rank_init       row offset + block scan of the row: the representative's
//                   rank in flat order is its compact id (0 above
//                   max_labels); the other pixels start at INT_MAX.
//   sweep           the same bounded sweeps spread the compact ids.
//   finalize        out = mask ? compact : 0.
//
// Bound on this card: each sweep moves about 9 bytes per pixel (4 read, 1
// mask byte, 4 written; the 3x3 neighbours of the old buffer come from L1/L2),
// 4.8 MB per 600x896 frame, ~1.4 us per frame per sweep at 3.35 TB/s.  The
// sweeps a frame needs (about a dot diameter, not the 64 of the bound) set
// the time; the per-frame early return keeps converged frames to the cost of
// a launch.  The Jacobi update reproduces the reference's sweep bound
// exactly: an in-place or shared-memory multi-step sweep would converge in
// fewer sweeps and differ from it on components that need more than n_iters.
//
// The C entry takes raw pointers, shapes, parameters and the stream, and
// returns cudaGetLastError().  Built without --use_fast_math: the threshold
// compare depends on IEEE float division.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = INT_MAX;
constexpr int kRowThreads = 256;

__global__ void threshold_init_kernel(const float* __restrict__ img,
                                      uint8_t* __restrict__ mask,
                                      int* __restrict__ lab, int H, int W,
                                      int r, float factor,
                                      int black_on_white) {
  extern __shared__ int colsum[];
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const float* im = img + (size_t)b * H * W;
  const int y0 = max(y - r, 0);
  const int y1 = min(y + r, H - 1);
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    int s = 0;
    for (int yy = y0; yy <= y1; ++yy) s += (int)im[(size_t)yy * W + x];
    colsum[x] = s;
  }
  __syncthreads();
  const int cnt_y = y1 - y0 + 1;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int x0 = max(x - r, 0);
    const int x1 = min(x + r, W - 1);
    int s = 0;
    for (int xx = x0; xx <= x1; ++xx) s += colsum[xx];
    const float mean = (float)s / (float)(cnt_y * (x1 - x0 + 1));
    const float v = im[(size_t)y * W + x];
    const float thr = mean * factor;
    const bool m = black_on_white ? (v < thr) : (v > thr);
    const size_t o = ((size_t)b * H + y) * W + x;
    mask[o] = m ? 1 : 0;
    lab[o] = m ? y * W + x + 1 : kBig;
  }
}

// One sweep of frame blockIdx.y; a grid-stride loop over its pixels, so a
// frame that already converged costs one block-uniform early return in a
// few blocks rather than a full-frame grid.
__global__ void sweep_kernel(const int* __restrict__ src,
                             int* __restrict__ dst,
                             const uint8_t* __restrict__ mask,
                             const int* __restrict__ prev_changed,
                             int* __restrict__ changed, int H, int W) {
  const int b = blockIdx.y;
  if (prev_changed != nullptr && prev_changed[b] == 0) return;
  const size_t base = (size_t)b * H * W;
  const int n = H * W;
  bool any = false;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int y = i / W;
    const int x = i - y * W;
    const int old = src[base + i];
    int nv = kBig;
    if (mask[base + i]) {
      nv = old;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          nv = min(nv, src[base + (size_t)yy * W + xx]);
        }
      }
    }
    dst[base + i] = nv;
    any |= nv != old;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) changed[b] = 1;
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32, <= 1024).
// *total receives the block's sum.  All threads must call it.
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += n;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v += warp_sums[wid - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();
  return v;
}

__global__ void rep_count_kernel(const int* __restrict__ lab,
                                 const uint8_t* __restrict__ mask,
                                 int* __restrict__ row_cnt, int H, int W) {
  __shared__ int warp_sums[32];
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = ((size_t)b * H + y) * W;
  int c = 0;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    c += (mask[row + x] && lab[row + x] == y * W + x + 1) ? 1 : 0;
  }
  int total;
  block_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) row_cnt[(size_t)b * H + y] = total;
}

__global__ void rank_init_kernel(const int* __restrict__ lab,
                                 const uint8_t* __restrict__ mask,
                                 const int* __restrict__ row_cnt,
                                 int* __restrict__ cid, int H, int W,
                                 int max_labels) {
  __shared__ int warp_sums[32];
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  // representatives in the rows above this one
  int part = 0;
  for (int i = threadIdx.x; i < y; i += blockDim.x)
    part += row_cnt[(size_t)b * H + i];
  int carry;
  block_scan(part, warp_sums, &carry);
  const size_t row = ((size_t)b * H + y) * W;
  for (int x0 = 0; x0 < W; x0 += blockDim.x) {
    const int x = x0 + threadIdx.x;
    const bool rep = x < W && mask[row + x] && lab[row + x] == y * W + x + 1;
    int total;
    const int rank = carry + block_scan(rep ? 1 : 0, warp_sums, &total);
    if (x < W) cid[row + x] = rep ? (rank <= max_labels ? rank : 0) : kBig;
    carry += total;
  }
}

__global__ void finalize_kernel(const int* __restrict__ compact,
                                const uint8_t* __restrict__ mask,
                                int* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mask[i] ? compact[i] : 0;
}

// Runs n_iters bounded sweeps ping-ponging between a and b, starting from a.
// Returns the buffer holding the result.
int* run_sweeps(int* a, int* b, const uint8_t* mask, int* flags, int B,
                int H, int W, int n_iters, cudaStream_t stream) {
  const int threads = 256;
  const int need = (H * W + threads - 1) / threads;
  const dim3 grid(min(need, max(4, 4096 / B)), B);
  int* bufs[2] = {a, b};
  for (int k = 0; k < n_iters; ++k) {
    sweep_kernel<<<grid, threads, 0, stream>>>(
        bufs[k & 1], bufs[(k + 1) & 1], mask,
        k == 0 ? nullptr : flags + (size_t)(k - 1) * B,
        flags + (size_t)k * B, H, W);
  }
  return bufs[n_iters & 1];
}

}  // namespace

extern "C" int vt_threshold_and_label(const float* img, int* out, int* buf0,
                                      int* buf1, uint8_t* mask, int* row_cnt,
                                      int* flags, int B, int H, int W,
                                      int radius, int n_iters, float factor,
                                      int black_on_white, int max_labels,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t n = (size_t)B * H * W;
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * 2 * (size_t)(n_iters > 0 ? n_iters : 1) * B,
      stream);
  if (err != cudaSuccess) return (int)err;
  // one row of column sums; the wrapper caps W so that it fits the 48 KB a
  // block gets without opting in to more
  const size_t smem = sizeof(int) * (size_t)W;
  const dim3 rows(H, B);
  threshold_init_kernel<<<rows, kRowThreads, smem, stream>>>(
      img, mask, buf0, H, W, radius, factor, black_on_white);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int* labels = run_sweeps(buf0, buf1, mask, flags, B, H, W, n_iters,
                           stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int* other = labels == buf0 ? buf1 : buf0;

  rep_count_kernel<<<rows, kRowThreads, 0, stream>>>(labels, mask, row_cnt,
                                                     H, W);
  rank_init_kernel<<<rows, kRowThreads, 0, stream>>>(labels, mask, row_cnt,
                                                     other, H, W, max_labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int* compact = run_sweeps(other, labels, mask,
                            flags + (size_t)(n_iters > 0 ? n_iters : 1) * B,
                            B, H, W, n_iters, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int threads = 256;
  finalize_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    stream>>>(compact, mask, out, n);
  return (int)cudaGetLastError();
}
