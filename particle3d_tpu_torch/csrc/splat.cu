// The splat renderer's "dilate" method for Hopper (sm_90a): one frame of
// render/splat.render_frame in two kernels, after one fill of the seed
// image with EMPTY by the wrapper.
//
// Replaces no TPU kernel: the JAX package renders with XLA ops
// (particle3d_tpu/render/splat.py). The port's plain torch version
// (render/splat._render_plain, the CPU path and the oracle) ran as ~540
// small launches and three blocking uploads a frame, so the frame was
// bound by the host issuing them. These two kernels take the same inputs
// and write the same pixels, bit for bit:
//
//  - seed_kernel: one thread a point, the N particles then the world
//    box's 12 * border_samples edge points. Each thread projects its point
//    in the plain version's op order (_affine, _project: each product and
//    sum rounded on its own, __fmul_rn / __fadd_rn / __fdiv_rn, so that
//    nvcc contracts nothing into an FMA), takes the splat radius
//    r_num / max(view z, 1e-6) clamped to [0.75, footprint / 2] (1 for an
//    edge point), packs [depth:15 | radius*16:8 | colour:8]
//    (_pack_fast_keys; the radius rounded half to even, rintf) and
//    atomicMins it into its 2x2 nearest pixels (_seed_points). Points
//    behind the camera or off screen write nothing.
//  - dilate_kernel<HALF>: one thread a pixel. A block stages its 32x8 tile
//    and a HALF = footprint // 2 apron of the seed image in shared memory
//    (EMPTY outside the image, as the plain version's pad), takes the
//    least key over the (2*HALF+1)^2 - 1 offsets whose radius reaches the
//    pixel (_dilate: threshold round(|offset| * 16), from the host's
//    table, where 256 stands for an offset the plain version skips), and
//    writes the colour of its id (_decode: the palette clamped, times 255,
//    truncated to uint8, from the host's table; background for EMPTY).
//
// Inputs reach the kernels by value: the view and projection matrices,
// the radius' numerator and its cap (SeedParams), the thresholds and the
// palette (read through __grid_constant__, without a local copy). Nothing
// is uploaded; a frame is three launches.
//
// What bounds it: bytes, and few of them. At N = 262,144 and 640x480 a
// frame reads 5.2 MB of positions and species, fills and reads back a
// 1.2 MB seed image (~1M atomicMins, in L2), and writes a 0.92 MB image:
// ~8.5 MB, 2.5 us at 3.35 TB/s. The launches' own latency is of the same
// order; neither is near the ~7 ms of host time the plain version took.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int EMPTY = 0x7FFFFFFF;
constexpr int BORDER_COLOR_ID = 254;
constexpr int BACKGROUND_ID = 255;
constexpr int R_SHIFT = 8;
constexpr int RMASK = 0xFF << R_SHIFT;
constexpr int MAX_HALF = 3;  // footprint <= 7
constexpr int TABLE = (2 * MAX_HALF + 1) * (2 * MAX_HALF + 1);
constexpr int SEED_THREADS = 256;
constexpr int TILE_W = 32, TILE_H = 8, TILE_THREADS = TILE_W * TILE_H;

// The host's float32 parameter block, in order: the view matrix and the
// projection matrix (row-major), the radius' numerator, the radius' cap
// (footprint / 2)
struct SeedParams {
  float vm[16], pm[16], r_num, r_max;
};
constexpr int N_PARAMS = 34;
static_assert(sizeof(SeedParams) == N_PARAMS * sizeof(float), "packing");

// The dilate's thresholds on a 7x7 offset grid, row (oy + 3), column
// (ox + 3), in 1/16 px
struct Thresholds {
  int t[TABLE];
};

// RGB bytes of each colour id, byte 3 unused
struct Palette {
  uint32_t rgb[256];
};

// sum of m[0..2] * (x, y, z) and m[3], left to right, each step rounded
__device__ __forceinline__ float affine_row(float x, float y, float z,
                                            const float* m) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, m[0]), __fmul_rn(y, m[1])),
                             __fmul_rn(z, m[2])),
                   m[3]);
}

template <class Species>
__global__ void __launch_bounds__(SEED_THREADS)
    seed_kernel(const float* __restrict__ pos, int pos_stride,
                const Species* __restrict__ species,
                const float* __restrict__ border, int n, int nb, SeedParams p,
                int width, int height, int* __restrict__ seeds) {
  const int i = static_cast<int>(blockIdx.x * SEED_THREADS + threadIdx.x);
  if (i >= n + nb) return;
  const bool edge = i >= n;
  const float* q = edge ? border + 3 * (i - n)
                        : pos + static_cast<size_t>(pos_stride) * i;
  const float x = q[0], y = q[1], z = q[2];
  float v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = affine_row(x, y, z, p.vm + 4 * r);
  float c[4];  // clip coordinates: the view's w scales pm's last column
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    c[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[0], p.pm[4 * r]),
                                         __fmul_rn(v[1], p.pm[4 * r + 1])),
                               __fmul_rn(v[2], p.pm[4 * r + 2])),
                     __fmul_rn(v[3], p.pm[4 * r + 3]));
  }
  if (!(c[3] > 1e-6f)) return;  // behind the camera
  const float ndc_x = __fdiv_rn(c[0], c[3]);
  const float ndc_y = __fdiv_rn(c[1], c[3]);
  const float px = __fmul_rn(__fmul_rn(__fadd_rn(ndc_x, 1.0f), 0.5f),
                             static_cast<float>(width));
  const float py = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, ndc_y), 0.5f),
                             static_cast<float>(height));
  const float depth = fmaxf(-v[2], 1e-6f);
  float r_px = 1.0f;
  int colour = BORDER_COLOR_ID;
  if (!edge) {
    r_px = fminf(fmaxf(__fdiv_rn(p.r_num, depth), 0.75f), p.r_max);
    colour = static_cast<int>(species[i]);
  }
  const float rq = fminf(fmaxf(rintf(__fmul_rn(r_px, 16.0f)), 0.0f), 255.0f);
  const int key = ((__float_as_int(depth) >> 16) << 16) |
                  (static_cast<int>(rq) << R_SHIFT) | colour;
  const float ix0 = floorf(__fsub_rn(px, 0.5f));
  const float iy0 = floorf(__fsub_rn(py, 0.5f));
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float cx = __fadd_rn(ix0, static_cast<float>(dx));
      const float cy = __fadd_rn(iy0, static_cast<float>(dy));
      if (cx >= 0.0f && cx < static_cast<float>(width) && cy >= 0.0f &&
          cy < static_cast<float>(height)) {
        atomicMin(seeds + static_cast<int>(cy) * width + static_cast<int>(cx),
                  key);
      }
    }
  }
}

template <int HALF>
__global__ void __launch_bounds__(TILE_THREADS)
    dilate_kernel(const int* __restrict__ seeds, int width, int height,
                  const __grid_constant__ Thresholds thr,
                  const __grid_constant__ Palette pal,
                  unsigned char* __restrict__ img) {
  constexpr int SW = TILE_W + 2 * HALF, SH = TILE_H + 2 * HALF;
  __shared__ int tile[SH * SW];
  __shared__ uint32_t rgb[256];
  const int x0 = static_cast<int>(blockIdx.x) * TILE_W - HALF;
  const int y0 = static_cast<int>(blockIdx.y) * TILE_H - HALF;
  for (int k = threadIdx.x; k < SH * SW; k += TILE_THREADS) {
    const int gx = x0 + k % SW, gy = y0 + k / SW;
    tile[k] = (gx >= 0 && gx < width && gy >= 0 && gy < height)
                  ? seeds[gy * width + gx]
                  : EMPTY;
  }
  for (int k = threadIdx.x; k < 256; k += TILE_THREADS) rgb[k] = pal.rgb[k];
  __syncthreads();
  const int tx = threadIdx.x % TILE_W, ty = threadIdx.x / TILE_W;
  const int x = x0 + HALF + tx, y = y0 + HALF + ty;
  if (x >= width || y >= height) return;
  int out = tile[(ty + HALF) * SW + tx + HALF];
#pragma unroll
  for (int oy = -HALF; oy <= HALF; ++oy) {
#pragma unroll
    for (int ox = -HALF; ox <= HALF; ++ox) {
      if (ox == 0 && oy == 0) continue;
      const int cand = tile[(ty + HALF + oy) * SW + tx + HALF + ox];
      const int t = thr.t[(oy + MAX_HALF) * (2 * MAX_HALF + 1) + ox + MAX_HALF];
      out = min(out, (cand & RMASK) >= (t << R_SHIFT) ? cand : EMPTY);
    }
  }
  const uint32_t c = rgb[out == EMPTY ? BACKGROUND_ID : (out & 0xFF)];
  unsigned char* o = img + 3 * (static_cast<size_t>(y) * width + x);
  o[0] = static_cast<unsigned char>(c);
  o[1] = static_cast<unsigned char>(c >> 8);
  o[2] = static_cast<unsigned char>(c >> 16);
}

template <int HALF>
void launch_dilate(dim3 grid, dim3 block, cudaStream_t stream,
                   const int* seeds, int width, int height,
                   const Thresholds& thr, const Palette& pal,
                   unsigned char* img) {
  dilate_kernel<HALF><<<grid, block, 0, stream>>>(seeds, width, height, thr, pal, img);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns
// cudaGetLastError() after its launch; 0 means the launch was accepted.
//
// p3t_splat_seed: `seeds` int32[height * width], filled with EMPTY by the
// caller; `pos` float32[n, 3] whose rows lie `pos_stride` floats apart
// (>= 3: the app's carry path hands over a view of a wider array),
// `species` int32 or int64[n] (`species_bytes` 4 or 8), `border`
// float32[nb, 3]; `params` the host's 34 floats (SeedParams).
extern "C" int p3t_splat_seed(const float* pos, const void* species,
                              const float* border, const float* params,
                              int* seeds, int n, int nb, int width, int height,
                              int species_bytes, int pos_stride,
                              void* stream_handle) {
  if (n < 0 || nb < 0 || width < 1 || height < 1 || pos_stride < 3 ||
      (species_bytes != 4 && species_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n + nb == 0) return 0;
  SeedParams p;
  std::memcpy(&p, params, sizeof p);
  const dim3 grid((n + nb + SEED_THREADS - 1) / SEED_THREADS);
  const dim3 block(SEED_THREADS);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (species_bytes == 4) {
    seed_kernel<int32_t><<<grid, block, 0, stream>>>(pos, pos_stride, static_cast<const int32_t*>(species), border, n, nb, p, width, height, seeds);
  } else {
    seed_kernel<int64_t><<<grid, block, 0, stream>>>(pos, pos_stride, static_cast<const int64_t*>(species), border, n, nb, p, width, height, seeds);
  }
  return static_cast<int>(cudaGetLastError());
}

// p3t_splat_dilate: `img` uint8[height, width, 3]; `thresholds` the host's
// 49 int32 (Thresholds), `palette` its 256 uint32 (Palette); `half` =
// footprint // 2, 0 to 3.
extern "C" int p3t_splat_dilate(const int* seeds, const int* thresholds,
                                const uint32_t* palette, unsigned char* img,
                                int width, int height, int half,
                                void* stream_handle) {
  if (width < 1 || height < 1 || half < 0 || half > MAX_HALF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Thresholds thr;
  std::memcpy(thr.t, thresholds, sizeof thr.t);
  Palette pal;
  std::memcpy(pal.rgb, palette, sizeof pal.rgb);
  const dim3 grid((width + TILE_W - 1) / TILE_W, (height + TILE_H - 1) / TILE_H);
  const dim3 block(TILE_THREADS);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (half) {
    case 0: launch_dilate<0>(grid, block, stream, seeds, width, height, thr, pal, img); break;
    case 1: launch_dilate<1>(grid, block, stream, seeds, width, height, thr, pal, img); break;
    case 2: launch_dilate<2>(grid, block, stream, seeds, width, height, thr, pal, img); break;
    default: launch_dilate<3>(grid, block, stream, seeds, width, height, thr, pal, img); break;
  }
  return static_cast<int>(cudaGetLastError());
}
