// Adaptive threshold + connected-component labelling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vicalib_tpu/detect/pallas_kernels.py::threshold_and_label (body
// _detect_kernel), which keeps one whole frame resident in the TPU's VMEM
// for every phase.  A padded 800x600 frame is 600x896: 2.1 MB of int32
// labels, far above the 227 KB of shared memory one SM can hold, so here the
// frame is cut into kTY x kTX tiles and every phase works tile by tile:
//
//   threshold_tile  box mean over the clamped (2r+1)^2 window, summed in
//                   int32 (exact): running column sums down the tile plus an
//                   r-pixel apron, then running sums along each row, so a
//                   few adds per pixel.  Writes the mask, the initial labels
//                   where a group of 4 pixels holds mask, and appends a tile
//                   that holds mask to the batch's list of active tiles.
//   sweep_chunk     kSteps Jacobi 3x3 min steps per launch (temporal
//                   blocking): a block loads its tile plus a kSteps-pixel
//                   halo of labels (unmasked and out-of-frame pixels read as
//                   INT_MAX), runs the steps on chip, and writes back the
//                   interior, which then equals exactly kSteps global
//                   sweeps: after t steps a pixel depends only on pixels
//                   within t of it.  ceil(n_iters / kSteps) launches per
//                   phase, the last one running the remainder, keep the
//                   reference's n_iters bound bit for bit.  The grid is
//                   persistent (as many blocks as fit on the card at once)
//                   and strides over the list of active tiles, so a tile
//                   with no mask costs nothing (the buffers hold valid
//                   values at masked pixels only); a frame whose previous
//                   chunk changed no interior pixel in its last step is at
//                   its fixpoint, and later chunks skip its tiles.
//   rep_count       representatives (masked pixels that kept their own flat
//                   index) per row, a warp per row.
//   rank_init       rows above summed by the block, then ballots along the
//                   row: the representative's rank in flat row-major order
//                   is its compact id (0 above max_labels), written in place
//                   at masked pixels.
//   sweep_chunk     the same bounded chunks spread the compact ids.
//   finalize        out = mask ? compact : 0, and the mask byte becomes
//                   out > 0 (the wrapper's bool mask).
//
// Bound on this card: the function must read 4 bytes and write 4 bytes per
// pixel; the mask covers about 1 % of a calibration frame, and the sweeps
// need 9 min/compare operations per masked pixel, so it is bound by bytes.
// What the design does about it: launches per call fall from 2 * n_iters + 5
// to 2 * ceil(n_iters / kSteps) + 5, a sweep touches device memory once per
// chunk instead of once per step, and only the tiles that hold mask do so.
// Within a chunk the extended tile costs (kTY + 2 kSteps)(kTX + 2 kSteps) /
// (kTY kTX) = 2.1x the interior's steps, on chip.  kSteps = 12 covers the
// 7-9 sweeps a calibration frame needs in one working chunk per phase.
//
// Resources (nvcc -Xptxas -v, sm_90a): sweep_chunk 48 registers and 43,776
// bytes of static shared memory, 2 blocks of 608 threads per SM;
// threshold_tile 63 registers and 4 * 32 * ((128 + 2r) | 1) bytes of
// dynamic shared memory (19,840 at r = 13; under 48 KB up to r = 127).
//
// Ping-pong: chunk c of a phase reads buffer (start + c) & 1 of the frame
// and writes the other; every block that runs records the buffer it wrote in
// res[b], which the next kernels read (a frame that stops early leaves its
// result where its last chunk wrote it).
//
// The C entry takes raw pointers, shapes, parameters and the stream, and
// returns cudaGetLastError().  Built without --use_fast_math: the threshold
// compare depends on IEEE float division.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = INT_MAX;
constexpr int kTY = 32;                    // tile rows (both passes)
constexpr int kTX = 128;                   // tile columns; W % 128 == 0
constexpr int kSteps = 12;                 // Jacobi steps per launch = halo
constexpr int kEY = kTY + 2 * kSteps;      // extended tile: 56 x 152
constexpr int kEX = kTX + 2 * kSteps;
constexpr int kSeg = 4;                    // vertical segments per column
constexpr int kRows = kEY / kSeg;          // rows a sweep thread owns
constexpr int kSweepThreads = kEX * kSeg;  // 608
constexpr int kRowThreads = 256;
constexpr int kRankRows = 8;               // rows per rank block, a warp each
constexpr int kStrip = 16;                 // threshold columns per thread
static_assert(kTY == 32 && (kRowThreads / 32) * kStrip == kTX,
              "threshold threads: a lane per row, a warp per strip");
static_assert(kEY % kSeg == 0, "segments must tile the extended rows");
static_assert(kRows <= 32, "mask bits of a thread's rows fit in 32 bits");

// One block per tile: grid (tiles per frame, B), dynamic shared memory
// kTY * ((kTX + 2r) | 1) ints (an odd row stride: no bank conflicts when
// the lanes of a warp read one column of 32 rows).  Active tiles go to
// list[] as b * tiles per frame + tile, in no particular order; *n_active
// counts them.
__global__ void __launch_bounds__(kRowThreads) threshold_tile_kernel(
    const float* __restrict__ img, uint8_t* __restrict__ mask,
    int* __restrict__ lab, int* __restrict__ list, int* __restrict__ n_active,
    int H, int W, int tiles_x, int r, float factor, int black_on_white) {
  extern __shared__ int cs[];
  const int n = kTX + 2 * r;
  const int stride = n | 1;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  // offsets within a frame fit int32 (H * W < INT_MAX)
  const size_t base = (size_t)b * H * W;
  const float* im = img + base;
  // column sums over rows [y - r, y + r] (out-of-frame pixels count 0),
  // one thread per column of the tile and its apron, sliding down the tile
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int x = tx0 - r + c;
    if (x < 0 || x >= W) {
      for (int ly = 0; ly < kTY; ++ly) cs[ly * stride + c] = 0;
      continue;
    }
    const float* col = im + x;
    int s = 0;
    const int y1 = min(ty0 + r, H - 1);
#pragma unroll 8
    for (int yy = max(ty0 - r, 0); yy <= y1; ++yy) s += (int)col[yy * W];
#pragma unroll 8
    for (int ly = 0; ly < kTY; ++ly) {
      cs[ly * stride + c] = s;
      const int ya = ty0 + ly + 1 + r;
      const int yd = ty0 + ly - r;
      const int add = ya < H ? (int)col[ya * W] : 0;
      const int sub = yd >= 0 && yd < H ? (int)col[yd * W] : 0;
      s += add - sub;
    }
  }
  __syncthreads();
  // lane = tile row, warp = kStrip columns: window sums slide along the row
  // in registers (window columns [x - r, x + r] are local [lx, lx + 2r])
  const int ly = threadIdx.x & 31;
  const int lx0 = (threadIdx.x >> 5) * kStrip;
  const int* row = cs + ly * stride + lx0;
  int sums[kStrip];
  int s = 0;
  for (int c = 0; c <= 2 * r; ++c) s += row[c];
  sums[0] = s;
#pragma unroll
  for (int j = 1; j < kStrip; ++j) {
    s += row[j + 2 * r] - row[j - 1];
    sums[j] = s;
  }
  const int y = ty0 + ly;
  bool any = false;
  if (y < H) {
    const int o0 = y * W + tx0 + lx0;       // kStrip pixels, 64-byte aligned
    float v[kStrip];
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(im + o0)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
    const int cnt_y = min(y + r, H - 1) - max(y - r, 0) + 1;
    uint8_t mb[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      const int x = tx0 + lx0 + j;
      const int cnt = cnt_y * (min(x + r, W - 1) - max(x - r, 0) + 1);
      const float thr = ((float)sums[j] / (float)cnt) * factor;
      const bool m = black_on_white ? (v[j] < thr) : (v[j] > thr);
      mb[j] = m ? 1 : 0;
      any |= m;
    }
    // initial labels by groups of 4 that hold mask (the label buffers need
    // valid values at masked pixels only)
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const int o = o0 + 4 * q;
      if (mb[4 * q] | mb[4 * q + 1] | mb[4 * q + 2] | mb[4 * q + 3])
        *reinterpret_cast<int4*>(lab + base + o) =
            make_int4(o + 1, o + 2, o + 3, o + 4);
    }
    uint4 packed;
    packed.x = mb[0] | mb[1] << 8 | mb[2] << 16 | (unsigned)mb[3] << 24;
    packed.y = mb[4] | mb[5] << 8 | mb[6] << 16 | (unsigned)mb[7] << 24;
    packed.z = mb[8] | mb[9] << 8 | mb[10] << 16 | (unsigned)mb[11] << 24;
    packed.w = mb[12] | mb[13] << 8 | mb[14] << 16 | (unsigned)mb[15] << 24;
    *reinterpret_cast<uint4*>(mask + base + o0) = packed;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0)
    list[atomicAdd(n_active, 1)] = b * gridDim.x + blockIdx.x;
}

// `steps` (<= kSteps) Jacobi steps on one tile of one frame: reads src,
// writes the masked interior of dst, and returns whether the last step
// changed an interior pixel.  Thread (seg, lx) owns the kRows cells of
// extended column lx in segment seg and keeps them in registers; a step takes
// the column min of its cells (the rows just above and below the segment
// come from the neighbouring segments' edge rows), publishes it in shared
// memory, and takes the row min of the column mins.
__device__ bool sweep_tile(const int* __restrict__ src, int* __restrict__ dst,
                           const uint8_t* __restrict__ mk, int tile,
                           int tiles_x, int steps, int H, int W,
                           int (&col)[kEY][kEX],
                           int (&edge)[2][kSeg][2][kEX]) {
  const int lx = threadIdx.x % kEX;
  const int seg = threadIdx.x / kEX;
  const int ly0 = seg * kRows;
  const int gx = (tile % tiles_x) * kTX - kSteps + lx;
  const int gy0 = (tile / tiles_x) * kTY - kSteps + ly0;
  const bool col_in = gx >= 0 && gx < W;

  int v[kRows];
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gy = gy0 + i;
    v[i] = kBig;
    if (col_in && gy >= 0 && gy < H) {
      const size_t o = (size_t)gy * W + gx;
      if (mk[o]) {
        v[i] = src[o];
        m |= 1u << i;
      }
    }
  }
  edge[0][seg][0][lx] = v[0];
  edge[0][seg][1][lx] = v[kRows - 1];
  __syncthreads();

  // only interior pixels decide the early stop: halo pixels are truncated
  const bool col_interior = lx >= kSteps && lx < kSteps + kTX;
  bool any = false;
  for (int t = 0; t < steps; ++t) {
    const int p = t & 1;
    const int up = seg > 0 ? edge[p][seg - 1][1][lx] : kBig;
    const int dn = seg < kSeg - 1 ? edge[p][seg + 1][0][lx] : kBig;
    int c[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      c[i] = min(min(i > 0 ? v[i - 1] : up, v[i]),
                 i < kRows - 1 ? v[i + 1] : dn);
      col[ly0 + i][lx] = c[i];
    }
    __syncthreads();
    const bool last = t == steps - 1;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      int nv = kBig;
      if ((m >> i) & 1u) {
        const int l = lx > 0 ? col[ly0 + i][lx - 1] : kBig;
        const int r = lx < kEX - 1 ? col[ly0 + i][lx + 1] : kBig;
        nv = min(min(l, c[i]), r);
        const int ly = ly0 + i;
        if (last && col_interior && ly >= kSteps && ly < kSteps + kTY)
          any |= nv != v[i];
      }
      v[i] = nv;
    }
    edge[p ^ 1][seg][0][lx] = v[0];
    edge[p ^ 1][seg][1][lx] = v[kRows - 1];
    __syncthreads();
  }

  if (col_interior) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int ly = ly0 + i;
      if (((m >> i) & 1u) && ly >= kSteps && ly < kSteps + kTY)
        dst[(size_t)(gy0 + i) * W + gx] = v[i];
    }
  }
  return __syncthreads_or(any) != 0;
}

// One chunk of a phase: a persistent grid strides over the n_active listed
// tiles, skipping the frames whose previous chunk converged.
__global__ void __launch_bounds__(kSweepThreads, 2) sweep_chunk_kernel(
    int* __restrict__ buf0, int* __restrict__ buf1,
    const uint8_t* __restrict__ mask, const int* __restrict__ list,
    const int* __restrict__ n_active, const int* __restrict__ start,
    int* __restrict__ res, const int* __restrict__ prev_changed,
    int* __restrict__ changed, int chunk, int steps, int H, int W,
    int tiles_x, int tiles_per_frame) {
  __shared__ int col[kEY][kEX];
  __shared__ int edge[2][kSeg][2][kEX];
  const int n = *n_active;
  for (int k = blockIdx.x; k < n; k += gridDim.x) {
    const int b = list[k] / tiles_per_frame;
    if (prev_changed != nullptr && prev_changed[b] == 0) continue;
    const int par = ((start != nullptr ? start[b] : 0) + chunk) & 1;
    const size_t base = (size_t)b * H * W;
    const bool any = sweep_tile(
        (par ? buf1 : buf0) + base, (par ? buf0 : buf1) + base, mask + base,
        list[k] - b * tiles_per_frame, tiles_x, steps, H, W, col, edge);
    if (threadIdx.x == 0) {
      if (any) changed[b] = 1;
      res[b] = par ^ 1;
    }
  }
}

__device__ __forceinline__ int* frame_buf(int* buf0, int* buf1,
                                          const int* sel, int b, int H,
                                          int W) {
  return (sel[b] ? buf1 : buf0) + (size_t)b * H * W;
}

// One warp per row, kRankRows rows per block, grid (ceil(H / kRankRows), B).
__global__ void __launch_bounds__(32 * kRankRows) rep_count_kernel(
    int* buf0, int* buf1, const int* sel, const uint8_t* __restrict__ mask,
    int* __restrict__ row_cnt, int H, int W) {
  const int y = blockIdx.x * kRankRows + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (y >= H) return;
  const int* lab = frame_buf(buf0, buf1, sel, b, H, W) + (size_t)y * W;
  const uint8_t* mrow = mask + ((size_t)b * H + y) * W;
  int c = 0;
  for (int x = threadIdx.x & 31; x < W; x += 32)
    c += (mrow[x] && lab[x] == y * W + x + 1) ? 1 : 0;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) row_cnt[(size_t)b * H + y] = c;
}

// Overwrites the labels in place with the compact seeds (rank or INT_MAX)
// at masked pixels: each lane reads and writes only its own pixel.  A
// representative's rank is the representatives in the rows above (the
// block's sum of row_cnt) plus those before it in its row (ballots along
// the row, 32 pixels at a time; W % 32 == 0).
__global__ void __launch_bounds__(32 * kRankRows) rank_init_kernel(
    int* buf0, int* buf1, const int* sel, const uint8_t* __restrict__ mask,
    const int* __restrict__ row_cnt, int H, int W, int max_labels) {
  __shared__ int warp_part[kRankRows];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int y0 = blockIdx.x * kRankRows;
  const int y = y0 + w;
  const int b = blockIdx.y;
  const int* cnt = row_cnt + (size_t)b * H;
  int part = 0;
  for (int i = threadIdx.x; i < y0; i += blockDim.x) part += cnt[i];
  part = __reduce_add_sync(0xffffffffu, part);
  if (lane == 0) warp_part[w] = part;
  __syncthreads();
  if (y >= H) return;
  int carry = 0;
  for (int k = 0; k < kRankRows; ++k) carry += warp_part[k];
  for (int k = y0; k < y; ++k) carry += cnt[k];
  int* lab = frame_buf(buf0, buf1, sel, b, H, W) + (size_t)y * W;
  const uint8_t* mrow = mask + ((size_t)b * H + y) * W;
  const unsigned below = (1u << lane) - 1u;
  for (int x = lane; x < W; x += 32) {
    const bool m = mrow[x];
    const bool rep = m && lab[x] == y * W + x + 1;
    const unsigned bits = __ballot_sync(0xffffffffu, rep);
    const int rank = carry + __popc(bits & below) + 1;
    if (m) lab[x] = rep ? (rank <= max_labels ? rank : 0) : kBig;
    carry += __popc(bits);
  }
}

// out = mask ? compact : 0, and mask becomes out > 0 (the wrapper returns
// it as a bool tensor); 4 pixels per thread, grid (ceil(H W / 4 / 256), B).
__global__ void finalize_kernel(int* buf0, int* buf1, const int* sel,
                                uint8_t* __restrict__ mask,
                                int* __restrict__ out, int H, int W) {
  const int b = blockIdx.y;
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= H * W) return;
  const size_t o = (size_t)b * H * W + i;
  uchar4 m = *reinterpret_cast<const uchar4*>(mask + o);
  int4 v = make_int4(0, 0, 0, 0);
  if (m.x | m.y | m.z | m.w) {
    const int4 c =
        *reinterpret_cast<const int4*>(frame_buf(buf0, buf1, sel, b, H, W) + i);
    v = make_int4(m.x ? c.x : 0, m.y ? c.y : 0, m.z ? c.z : 0, m.w ? c.w : 0);
    m = make_uchar4(v.x > 0, v.y > 0, v.z > 0, v.w > 0);
    *reinterpret_cast<uchar4*>(mask + o) = m;
  }
  *reinterpret_cast<int4*>(out + o) = v;
}

int n_chunks(int n_iters) { return (n_iters + kSteps - 1) / kSteps; }

// Launches the bounded chunks of one phase on `blocks` persistent blocks.
// flags holds n_chunks(n_iters) per-frame "changed in the last step" rows;
// res receives each frame's result buffer.
void run_chunks(int* buf0, int* buf1, const uint8_t* mask, const int* list,
                const int* n_active, const int* start, int* res, int* flags,
                int blocks, int B, int H, int W, int n_iters,
                cudaStream_t stream) {
  const int tiles_x = W / kTX;
  const int tiles_per_frame = tiles_x * ((H + kTY - 1) / kTY);
  for (int c = 0; c < n_chunks(n_iters); ++c) {
    const int steps = min(kSteps, n_iters - c * kSteps);
    sweep_chunk_kernel<<<blocks, kSweepThreads, 0, stream>>>(
        buf0, buf1, mask, list, n_active, start, res,
        c == 0 ? nullptr : flags + (size_t)(c - 1) * B,
        flags + (size_t)c * B, c, steps, H, W, tiles_x, tiles_per_frame);
  }
}

}  // namespace

// Tile rows, tile columns and Jacobi steps per launch, for the wrapper's
// scratch sizes.
extern "C" void vt_tile_config(int* out) {
  out[0] = kTY;
  out[1] = kTX;
  out[2] = kSteps;
}

// Scratch: buf0, buf1 (B*H*W int32 each), mask (B*H*W bytes), list
// (B * ceil(H/kTY) * W/kTX int32), row_cnt (B*H int32), flags
// ((2 * n_chunks + 2) * B + 1 int32).
extern "C" int vt_threshold_and_label(const float* img, int* out, int* buf0,
                                      int* buf1, uint8_t* mask, int* list,
                                      int* row_cnt, int* flags, int B, int H,
                                      int W,
                                      int radius, int n_iters, float factor,
                                      int black_on_white, int max_labels,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nc = n_chunks(n_iters);
  int* flags_a = flags;
  int* flags_b = flags + (size_t)nc * B;
  int* res_a = flags + (size_t)2 * nc * B;
  int* res_b = res_a + B;
  int* n_active = res_b + B;
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * ((size_t)(2 * nc + 2) * B + 1), stream);
  if (err != cudaSuccess) return (int)err;
  // persistent sweep blocks: as many as the card holds at once
  static int blocks_of_device[64];
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  int& blocks = blocks_of_device[dev & 63];
  if (blocks == 0) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sweep_chunk_kernel, kSweepThreads, 0)) != cudaSuccess)
      return (int)err;
    blocks = sms * per_sm;
  }

  const int tiles_x = W / kTX;
  const dim3 tgrid(tiles_x * ((H + kTY - 1) / kTY), B);
  const size_t smem = sizeof(int) * (size_t)kTY * ((kTX + 2 * radius) | 1);
  threshold_tile_kernel<<<tgrid, kRowThreads, smem, stream>>>(
      img, mask, buf0, list, n_active, H, W, tiles_x, radius, factor,
      black_on_white);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  run_chunks(buf0, buf1, mask, list, n_active, nullptr, res_a, flags_a,
             blocks, B, H, W, n_iters, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 rows((H + kRankRows - 1) / kRankRows, B);
  rep_count_kernel<<<rows, 32 * kRankRows, 0, stream>>>(
      buf0, buf1, res_a, mask, row_cnt, H, W);
  rank_init_kernel<<<rows, 32 * kRankRows, 0, stream>>>(
      buf0, buf1, res_a, mask, row_cnt, H, W, max_labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // the compact phase starts where the label phase ended; with n_iters == 0
  // no chunk runs and res_b keeps res_a's 0
  run_chunks(buf0, buf1, mask, list, n_active, res_a, res_b, flags_b, blocks,
             B, H, W, n_iters, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 fgrid((unsigned)((H * W / 4 + kRowThreads - 1) / kRowThreads),
                   B);
  finalize_kernel<<<fgrid, kRowThreads, 0, stream>>>(buf0, buf1, res_b, mask,
                                                     out, H, W);
  return (int)cudaGetLastError();
}
